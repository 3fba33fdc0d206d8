"""The CUDA kernel against its plain PyTorch version on the card. These need
an NVIDIA GPU and nvcc, and skip elsewhere; this file imports no JAX, so it
also runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import pytest
import torch

from keep_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,padded", [(32, 197, 16, False),
                                          (32, 256, 12, True),
                                          (2, 512, 2, True), (3, 7, 1, False)])
def test_kernel_matches_plain(cuda, b, s, h, padded, dtype):
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=cuda)
    qkv = qkv.to(dtype)
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    kb = None
    if padded:
        lens = torch.randint(1, s + 1, (b,), device="cuda", generator=cuda)
        valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
    n0 = fa.LAUNCHES
    got = fa.attention_qkv_slab(qkv, kb, num_heads=h)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == n0 + 1
    ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h)
    g, r = got.float()[valid], ref.float()[valid]
    if dtype == torch.float32:
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-5)
    else:
        assert (g - r).abs().max().item() < 0.05


def test_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="head_dim"):
        fa.attention_qkv_slab(torch.zeros(1, 4, 3 * 32, device="cuda"),
                              num_heads=1)
    with pytest.raises(ValueError, match="S ≤"):
        fa.attention_qkv_slab(torch.zeros(1, 513, 192, device="cuda"),
                              num_heads=1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_qkv_slab(
            torch.zeros(1, 192, 4, device="cuda").transpose(1, 2),
            num_heads=1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.attention_qkv_slab(torch.zeros(1, 4, 192, device="cuda",
                                          dtype=torch.float16), num_heads=1)
