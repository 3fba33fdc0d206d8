"""The CUDA kernels against their plain PyTorch versions on the card. These need
an NVIDIA GPU and nvcc, and skip elsewhere; this file imports no JAX, so it
also runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import contextlib

import pytest
import torch

from keep_tpu_torch.kernels import _kops, qblock, qmatmul, qmlp
from keep_tpu_torch.kernels import flash_attention as fa
from keep_tpu_torch.kernels import ln_matmul as lm
from keep_tpu_torch.ops.nn import (LayerNorm, QLinear, restore_tf32,
                                   tf32_state)
from keep_tpu_torch.quant import quantize_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    with _tf32(False):
        yield torch.Generator(device="cuda").manual_seed(0)


@contextlib.contextmanager
def _tf32(on: bool):
    """cuBLAS's fp32 matmuls with TF32 ``on``; the caller's setting
    restored on exit."""
    saved = tf32_state()
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        restore_tf32(saved)


# sequence lengths around the bf16 body's 64-row tiles and 16-row mma
# fragments, the two towers' lengths and the kernels' limit
EDGE_S = [1, 15, 16, 17, 64, 197, 256, 257, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,padded", [(32, 197, 16, False),
                                          (32, 256, 12, True),
                                          (2, 512, 2, True), (3, 7, 1, False)]
                         + [(2, s, 2, padded) for s in EDGE_S
                            for padded in (False, True)])
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


# ---- the int8 kernels -----------------------------------------------------------

def _qlin(gen, k, n, std=0.05):
    w = torch.randn(n, k, device="cuda", generator=gen) * std
    q, s = quantize_kernel(w)
    return QLinear.from_quantized(
        q, s, torch.randn(n, device="cuda", generator=gen) * 0.01)


def _norm(gen, d):
    norm = LayerNorm(d, 1e-6, device="cuda").requires_grad_(False)
    norm.weight.copy_(1 + 0.1 * torch.randn(d, device="cuda", generator=gen))
    norm.bias.copy_(0.05 * torch.randn(d, device="cuda", generator=gen))
    return norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln,ps", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("m,k", [(394, 1024), (5, 4096), (1, 48), (3, 3072),
                                 (197, 768), (6304, 1024), (65, 4096),
                                 (63, 2048), (1, 16)])
def test_quant_rows_matches_plain(cuda, m, k, ln, ps, dtype):
    x = (torch.randn(m, k, device="cuda", generator=cuda) * 3).to(dtype)
    g = 1 + 0.1 * torch.randn(k, device="cuda", generator=cuda) if ln else None
    b = 0.1 * torch.randn(k, device="cuda", generator=cuda) if ln else None
    p = torch.rand(k, device="cuda", generator=cuda) + 0.5 if ps else None
    n0 = _kops.LAUNCHES["quant_rows"]
    q, s = _kops.quant_rows(x, g, b, 1e-6, p)
    torch.cuda.synchronize()
    assert _kops.LAUNCHES["quant_rows"] == n0 + 1
    rq, rs = _kops.quant_rows_reference(x, g, b, 1e-6, p)
    # the abs-max, the reciprocal and the rounding are exact, and the LN
    # statistics are fp64 sums rounded once: the same bits
    torch.testing.assert_close(q, rq, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 64, 8), (17, 48, 768), (591, 1024, 3072),
                                   (300, 4096, 1024), (33, 768, 1000)])
@pytest.mark.parametrize("order,gelu,res", [(0, False, None), (0, True, None),
                                            (1, False, torch.float32),
                                            (1, True, torch.bfloat16)])
def test_int8_gemm_matches_plain(cuda, m, k, n, order, gelu, res, out_dtype):
    xq = torch.randint(-127, 128, (m, k), device="cuda", generator=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), device="cuda", generator=cuda,
                       dtype=torch.int8)
    a = torch.rand(m, device="cuda", generator=cuda) * 1e-2
    s = torch.rand(n, device="cuda", generator=cuda) * 1e-3
    bias = torch.randn(n, device="cuda", generator=cuda)
    r = None if res is None else torch.randn(m, n, device="cuda",
                                             generator=cuda).to(res)
    n0 = _kops.LAUNCHES["int8_gemm"]
    got = _kops.int8_gemm(xq, a, wq, s, bias, order=order, gelu=gelu,
                          residual=r, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _kops.LAUNCHES["int8_gemm"] == n0 + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    ref = _kops.int8_gemm_reference(xq, a, wq, s, bias, order=order,
                                    gelu=gelu, residual=r,
                                    out_dtype=out_dtype)
    # the int32 sums are exact in both; the epilogue is the same sequence of
    # fp32 operations, up to the tanh of the GELU
    tol = 1e-5 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d", [(394, 768), (1, 4096), (7, 48), (8192, 768),
                                 (65, 1024), (63, 3072)])
def test_ln_rows_matches_plain(cuda, m, d, out_dtype):
    x = torch.randn(m, d, device="cuda", generator=cuda) * 4 + 1
    g = 1 + 0.1 * torch.randn(d, device="cuda", generator=cuda)
    b = 0.1 * torch.randn(d, device="cuda", generator=cuda)
    got = _kops.ln_rows(x, g, b, 1e-12, out_dtype)
    torch.cuda.synchronize()
    ref = _kops.ln_rows_reference(x, g, b, 1e-12, out_dtype)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


# the (K, N) of every int8 GEMM on the serving path: ViT-L qkv, proj, fc1,
# fc2, patch embed, head fc1, head fc2; BERT-base qkv, out, fc1, fc2
KEEP_GEMMS = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
              (768, 1024), (1024, 768), (768, 768), (768, 2304), (3072, 768)]


@pytest.mark.parametrize("m", [1, 32, 63, 65, 197, 6304])
@pytest.mark.parametrize("k,n", KEEP_GEMMS)
def test_int8_gemm_equals_plain_at_the_keep_shapes(cuda, m, k, n):
    """The wgmma kernel against its plain version (cuBLAS int8 and the same
    fp32 epilogue in PyTorch), bit for bit, in both dequant orders, with
    and without the GELU, with an fp32 and a bf16 residual, writing fp32 and
    bf16."""
    xq = torch.randint(-127, 128, (m, k), device="cuda", generator=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), device="cuda", generator=cuda,
                       dtype=torch.int8)
    a = torch.rand(m, device="cuda", generator=cuda) * 1e-2
    s = torch.rand(n, device="cuda", generator=cuda) * 1e-3
    bias = torch.randn(n, device="cuda", generator=cuda)
    res = torch.randn(m, n, device="cuda", generator=cuda)
    for order, gelu, r in ((0, False, None), (0, True, None),
                           (1, True, None), (1, False, res),
                           (1, False, res.bfloat16())):
        for out_dtype in (torch.float32, torch.bfloat16):
            kw = dict(order=order, gelu=gelu, residual=r, out_dtype=out_dtype)
            got = _kops.int8_gemm(xq, a, wq, s, bias, **kw)
            torch.cuda.synchronize()
            ref = _kops.int8_gemm_reference(xq, a, wq, s, bias, **kw)
            assert torch.equal(got, ref), (order, gelu, out_dtype, (
                got.float() - ref.float()).abs().max().item())


def test_int8_kernels_give_the_same_bits_twice(cuda):
    x = torch.randn(6304, 1024, device="cuda", generator=cuda).bfloat16()
    h = torch.randn(6304, 4096, device="cuda", generator=cuda)
    g = 1 + 0.1 * torch.randn(1024, device="cuda", generator=cuda)
    b = 0.1 * torch.randn(1024, device="cuda", generator=cuda)
    wq = torch.randint(-127, 128, (4096, 1024), device="cuda", generator=cuda,
                       dtype=torch.int8)
    ws = torch.rand(4096, device="cuda", generator=cuda) * 1e-3
    bias = torch.randn(4096, device="cuda", generator=cuda)
    runs = []
    for _ in range(2):
        q, a = _kops.quant_rows(x, g, b)
        hq, ha = _kops.quant_rows(h)
        y = _kops.int8_gemm(q, a, wq, ws, bias, order=1, gelu=True)
        z = _kops.ln_rows(h[:, :1024].contiguous(), g, b, 1e-6)
        runs.append((q, a, hq, ha, y, z))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


def test_attention_fp32_output_matches_plain(cuda):
    """The bf16-in, fp32-out form the int8 blocks use, on its wgmma body:
    within the bf16 attention gate (max |Δ| < 0.05) of the plain version.
    The tensor cores sum in their own order, so the bits differ."""
    qkv = torch.randn(3, 197, 3 * 4 * 64, device="cuda", generator=cuda)
    qkv = qkv.bfloat16()
    n0 = fa.LAUNCHES
    got = fa.attention_qkv_slab(qkv, num_heads=4, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == n0 + 1
    assert got.dtype == torch.float32
    ref = fa.attention_qkv_slab_reference(qkv, num_heads=4,
                                          out_dtype=torch.float32)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() < 0.05


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("s", EDGE_S)
def test_attention_fp32_output_at_every_edge(cuda, s, padded):
    """The fp32-out form at the edge lengths, padded and unpadded, within
    the bf16 attention gate on unpadded query rows: S ≤ 256 in one pass of
    16-key pieces, 256 < S ≤ 512 in two chunks of 256 keys."""
    qkv = torch.randn(2, s, 3 * 2 * 64, device="cuda", generator=cuda)
    qkv = qkv.bfloat16()
    kb = None
    valid = torch.ones(2, s, dtype=torch.bool, device="cuda")
    if padded:
        lens = torch.randint(1, s + 1, (2,), device="cuda", generator=cuda)
        valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
    got = fa.attention_qkv_slab(qkv, kb, num_heads=2, out_dtype=torch.float32)
    torch.cuda.synchronize()
    ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=2,
                                          out_dtype=torch.float32)
    assert torch.isfinite(got).all()
    assert (got[valid] - ref[valid]).abs().max().item() < 0.05


@pytest.mark.parametrize("b,s,h,padded", [(4, 197, 16, False),
                                          (4, 256, 12, True)])
def test_attention_fp32_output_moves_block_codes_by_one(cuda, b, s, h,
                                                        padded):
    """What the int8 blocks re-quantize: quant_rows of the kernel's fp32
    attention output against quant_rows of the plain attention output on
    the same slab. No code moves by more than one."""
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=cuda)
    qkv = qkv.bfloat16()
    kb = None
    if padded:
        lens = torch.randint(8, s + 1, (b,), device="cuda", generator=cuda)
        kb = (torch.arange(s, device="cuda")[None] >= lens[:, None]) * -1e9
    got = fa.attention_qkv_slab(qkv, kb, num_heads=h, out_dtype=torch.float32)
    ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h,
                                          out_dtype=torch.float32)
    q, _ = _kops.quant_rows(got.view(b * s, h * 64))
    rq, _ = _kops.quant_rows_reference(ref.view(b * s, h * 64))
    diff = (q.int() - rq.int()).abs()
    assert diff.max().item() <= 1


@pytest.mark.parametrize("b", [1, 3])
def test_int8_blocks_match_plain(cuda, b):
    """The counterparts of the TPU kernels #4, #5, #6, #8, #9 through the
    kernels, against their plain versions, at the JAX package's tolerances
    for each (tests/test_quant.py); #4 and #5 at its tolerance between two
    routes."""
    s, d, h = 37, 128, 2
    x = torch.randn(b, s, d, device="cuda", generator=cuda) * 0.5
    n1, n2 = _norm(cuda, d), _norm(cuda, d)
    qkv, proj = _qlin(cuda, d, 3 * d, 0.08), _qlin(cuda, d, d, 0.08)
    fc1, fc2 = _qlin(cuda, d, 4 * d), _qlin(cuda, 4 * d, d)
    qkv.pre_scale = torch.rand(d, device="cuda", generator=cuda) + 0.5
    kb = torch.zeros(b, s, device="cuda")
    kb[0, 20:] = -1e9
    before = dict(_kops.LAUNCHES)

    def both(fn, ref, *args, **kw):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        return got.float(), ref(*args, **kw).float()

    got, ref = both(qmatmul.quantized_matmul, qmatmul.quantized_matmul_reference,
                    x[0], fc1.weight_q, fc1.weight_scale, fc1.bias,
                    activation="gelu_tanh", out_dtype=torch.float32)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-3)
    got, ref = both(qmatmul.quantized_matmul_bsd,
                    qmatmul.quantized_matmul_bsd_reference, x, fc1.weight_q,
                    fc1.weight_scale, fc1.bias, out_dtype=torch.float32,
                    pre_scale=qkv.pre_scale)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    mlp_args = (x, fc1.weight_q, fc1.weight_scale, fc1.bias, fc2.weight_q,
                fc2.weight_scale, fc2.bias)
    got, ref = both(qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
                    *mlp_args, out_dtype=torch.float32, ln_scale=n2.weight,
                    ln_bias=n2.bias, residual=True)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-4)
    got, ref = both(qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
                    *mlp_args, out_dtype=torch.float32, ln_scale=n2.weight,
                    ln_bias=n2.bias, eps=1e-12, post_ln=True,
                    pre_scale1=qkv.pre_scale)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)
    # #4 and #5 run their attention on the tensor cores, in another order
    # than the plain version: the JAX package's tolerance between two
    # routes through the same int8 weights (tests/test_quant.py:297-300,
    # 324-327)
    for fn, ref_fn, args, eps in (
            (qblock.quantized_attention_block,
             qblock.quantized_attention_block_reference, (x, n1, qkv, proj),
             1e-6),
            (qblock.quantized_attention_block_postln,
             qblock.quantized_attention_block_postln_reference,
             (x, kb, n1, qkv, proj), 1e-12)):
        got, ref = both(fn, ref_fn, *args, num_heads=h, eps=eps)
        torch.testing.assert_close(got, ref, atol=2e-2, rtol=2e-2)
        cos = torch.nn.functional.cosine_similarity(got.view(-1, d),
                                                    ref.view(-1, d), dim=-1)
        assert cos.min().item() >= 0.9999
    for name in ("quantized_matmul", "quantized_matmul_bsd",
                 "quantized_attention_block",
                 "quantized_attention_block_postln"):
        assert _kops.LAUNCHES[name] == before.get(name, 0) + 1
    assert _kops.LAUNCHES["quantized_mlp_bsd"] == before.get(
        "quantized_mlp_bsd", 0) + 2


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    q8 = torch.zeros(4, 64, dtype=torch.int8, device="cuda")
    one = torch.ones(4, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        _kops.int8_gemm(q8[:, :40].contiguous(), one, q8[:, :40].contiguous(),
                        one, one, order=1)
    with pytest.raises(ValueError, match="contiguous"):
        xt = torch.zeros(64, 32, dtype=torch.int8, device="cuda").t()
        _kops.int8_gemm(xt, torch.ones(32, device="cuda"),
                        torch.zeros(16, 64, dtype=torch.int8, device="cuda"),
                        torch.ones(16, device="cuda"),
                        torch.ones(16, device="cuda"), order=1)
    with pytest.raises(TypeError, match="int8"):
        _kops.int8_gemm(q8.float(), one, q8, one, one, order=1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _kops.int8_gemm(q8, one, q8, one, one, order=1,
                        out_dtype=torch.float16)
    with pytest.raises(ValueError, match="at most 4096"):
        _kops.quant_rows(torch.zeros(2, 4097, device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _kops.quant_rows(torch.zeros(2, 8, device="cuda",
                                     dtype=torch.float16))
    with pytest.raises(TypeError, match="float32 rows"):
        _kops.ln_rows(torch.zeros(2, 8, device="cuda", dtype=torch.bfloat16),
                      torch.ones(8, device="cuda"),
                      torch.zeros(8, device="cuda"), 1e-6)
    # rows of the row kernels: a multiple of 16 values, 16-byte aligned
    with pytest.raises(ValueError, match="multiple of 16 values"):
        _kops.quant_rows(torch.zeros(2, 40, device="cuda"))
    with pytest.raises(ValueError, match="multiple of 16 values"):
        _kops.ln_rows(torch.zeros(2, 40, device="cuda"),
                      torch.ones(40, device="cuda"),
                      torch.zeros(40, device="cuda"), 1e-6)
    shifted = torch.zeros(2 * 64 + 1, device="cuda")[1:].view(2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _kops.quant_rows(shifted)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _kops.ln_rows(shifted, torch.ones(64, device="cuda"),
                      torch.zeros(64, device="cuda"), 1e-6)
    with pytest.raises(ValueError, match="aligned ln_scale"):
        _kops.quant_rows(torch.zeros(2, 64, device="cuda"), shifted[0],
                         torch.zeros(64, device="cuda"))
    # the GEMM's operands and residual: 16-byte aligned
    q64 = torch.zeros(4 * 64 + 1, dtype=torch.int8, device="cuda")[1:]
    w8 = torch.zeros(8, 64, dtype=torch.int8, device="cuda")
    one8 = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        _kops.int8_gemm(q64.view(4, 64), one, w8, one8, one8, order=1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _kops.int8_gemm(q8, one, w8, one8, one8, order=1,
                        residual=torch.zeros(33, device="cuda")[1:].view(4, 8))
    with pytest.raises(ValueError, match="N of 8"):
        _kops.int8_gemm(q8, one, q8[:3].contiguous(), one[:3], one[:3],
                        order=1)
    with pytest.raises(TypeError, match="float32 or the input"):
        fa.attention_qkv_slab(torch.zeros(1, 4, 192, device="cuda"),
                              num_heads=1, out_dtype=torch.bfloat16)


# ---- the attention backward --------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("s", [33] + EDGE_S)
def test_bwd_kernel_matches_plain(cuda, s, padded, dtype):
    """fp32 at atol 2e-4, rtol 1e-4 (tests/test_flash_attention.py's VJP
    tolerance); bf16 within 1e-2 of the largest plain gradient on unpadded
    rows, one bf16 rounding of fp32 sums taken in another order."""
    b, h = 4, 3
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=cuda).to(dtype)
    do = torch.randn(b, s, h * 64, device="cuda", generator=cuda).to(dtype)
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    if padded:
        lens = torch.randint(1, s + 1, (b,), device="cuda", generator=cuda)
        valid = torch.arange(s, device="cuda")[None] < lens[:, None]
    kb = (1.0 - valid.float()) * -1e9
    n0 = fa.BWD_LAUNCHES
    got = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == n0 + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    ref = fa.attention_qkv_slab_bwd_reference(qkv, kb, do, h)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-4)
    else:
        g, r = got.float()[valid], ref.float()[valid]
        assert (g - r).abs().max().item() <= 1e-2 * r.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_is_deterministic(cuda, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    b, s, h = 4, 197, 3
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=cuda).to(dtype)
    do = torch.randn(b, s, h * 64, device="cuda", generator=cuda).to(dtype)
    kb = torch.zeros(b, s, device="cuda")
    kb[1:, 150:] = -1e9
    first = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
    second = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_autograd_launches_both_kernels(cuda):
    """Under autograd a CUDA slab goes forward through the forward kernel
    and back through the backward kernel, once each, to the plain
    gradient."""
    qkv = torch.randn(2, 50, 3 * 2 * 64, device="cuda", generator=cuda)
    do = torch.randn(2, 50, 2 * 64, device="cuda", generator=cuda)
    x = qkv.clone().requires_grad_()
    n0, nb0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    fa.attention_qkv_slab(x, num_heads=2).backward(do)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (n0 + 1, nb0 + 1)
    ref = fa.attention_qkv_slab_bwd_reference(qkv, torch.zeros(2, 50,
                                                               device="cuda"),
                                              do, 2)
    torch.testing.assert_close(x.grad, ref, atol=2e-4, rtol=1e-4)


def test_bwd_kernel_refuses_what_it_does_not_take(cuda):
    kb = torch.zeros(1, 4, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.attention_qkv_slab_bwd(torch.zeros(1, 4, 96, device="cuda"), kb,
                                  torch.zeros(1, 4, 32, device="cuda"), 1)
    with pytest.raises(ValueError, match="S ≤"):
        fa.attention_qkv_slab_bwd(torch.zeros(1, 513, 192, device="cuda"),
                                  torch.zeros(1, 513, device="cuda"),
                                  torch.zeros(1, 513, 64, device="cuda"), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.attention_qkv_slab_bwd(torch.zeros(1, 4, 192, device="cuda"), kb,
                                  torch.zeros(1, 4, 64, device="cuda",
                                              dtype=torch.bfloat16), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.attention_qkv_slab_bwd(
            torch.zeros(1, 4, 192, device="cuda", dtype=torch.float16), kb,
            torch.zeros(1, 4, 64, device="cuda", dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_qkv_slab_bwd(
            torch.zeros(1, 4, 192, device="cuda"), kb,
            torch.zeros(1, 128, 4, device="cuda").transpose(1, 2)[..., :64],
            1)
    with pytest.raises(ValueError, match="device"):
        fa.attention_qkv_slab_bwd(torch.zeros(1, 4, 192, device="cuda"),
                                  torch.zeros(1, 4),
                                  torch.zeros(1, 4, 64, device="cuda"), 1)


def test_train_step_on_the_card(cuda):
    """One bf16 train step of a small KEEP (head width 64) on the card: the
    attention of every block goes forward through the kernel twice (remat)
    and back through the backward kernel once; the loss is finite."""
    from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.train import optim, trainer

    cfg = KEEPConfig(vision=ViTConfig(img_size=32, patch_size=8,
                                      embed_dim=128, depth=2, num_heads=2),
                     text=BertConfig(vocab_size=64, hidden_size=128,
                                     num_hidden_layers=2,
                                     num_attention_heads=2,
                                     intermediate_size=256,
                                     max_position_embeddings=32),
                     projection_dim=128)
    model = KEEPModel.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.bfloat16,
                           weight_dtype=torch.float32, use_flash=True,
                           gelu_approx=False)
    tx = optim.AdamW(lambda s: 1e-4, decay_mask=optim.wd_mask(model),
                     grad_clip_norm=1.0)
    state = trainer.tree_state(model, tx)
    step = trainer.make_train_step(model, trainer.LossConfig(caption_num=4),
                                   tx)
    batch = {"pixels": torch.randn(8, 32, 32, 3, device="cuda",
                                   generator=cuda),
             "input_ids": torch.randint(1, 64, (8, 16), device="cuda",
                                        generator=cuda),
             "attention_mask": torch.ones(8, 16, dtype=torch.long,
                                          device="cuda"),
             "node_connection": torch.ones(4, 4, device="cuda")}
    batch["attention_mask"][:, 10:] = 0
    n0, nb0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    state, m = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"])
    assert fa.BWD_LAUNCHES - nb0 == 4
    assert fa.LAUNCHES - n0 == 8


# ---- split-heads attention, ln_matmul, the flat int8 MLP ----------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,padded", [(4, 197, 16, False),
                                          (4, 256, 12, True),
                                          (2, 512, 2, True), (3, 7, 1, False)])
def test_heads_kernel_matches_plain_and_slab(cuda, b, s, h, padded, dtype):
    """attention_qkv_heads against its plain version (fp32 2e-5, bf16 max
    |Δ| < 0.05 on valid rows), and bit for bit against the slab kernel on
    the same q, k, v: one kernel body, two addressings."""
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=cuda)
    qkv = qkv.to(dtype)
    q, k, v = (t.contiguous() for t in qkv.split(h * 64, dim=-1))
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    kb = None
    if padded:
        lens = torch.randint(1, s + 1, (b,), device="cuda", generator=cuda)
        valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
    n0 = fa.HEADS_LAUNCHES
    got = fa.attention_qkv_heads(q, k, v, kb, num_heads=h)
    torch.cuda.synchronize()
    assert fa.HEADS_LAUNCHES == n0 + 1
    assert got.dtype == dtype
    torch.testing.assert_close(
        got, fa.attention_qkv_slab(qkv, kb, num_heads=h), rtol=0, atol=0)
    ref = fa.attention_qkv_heads_reference(q, k, v, kb, num_heads=h)
    g, r = got.float()[valid], ref.float()[valid]
    if dtype == torch.float32:
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-5)
    else:
        assert (g - r).abs().max().item() < 0.05


@pytest.mark.parametrize("layout", ["bhsd", "bshd", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [17, 197, 256])
def test_flash_attention_equals_heads_and_slab(cuda, s, dtype, layout):
    """flash_attention on [B, H, S, Dh] q, k, v, attention_qkv_heads on
    their [B, S, H·Dh] lanes and attention_qkv_slab on the slab of those
    lanes give the same bits: one kernel body, three addressings. The
    kernel reads contiguous [B, H, S, Dh] tensors ("bhsd") and head views
    of [B, S, H, Dh] ones ("bshd") through their strides; q, k and v of
    different layouts ("mixed") are copied first."""
    b, h = 3, 4
    x = torch.randn(3, b, s, h, 64, device="cuda", generator=cuda).to(dtype)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in x)
    else:
        q, k, v = (t.transpose(1, 2).contiguous() for t in x)
        if layout == "mixed":
            k = x[1].transpose(1, 2)
    bias = torch.zeros(b, 1, 1, s, device="cuda")
    bias[0, ..., s // 2 + 1:] = -1e9
    n0 = fa.HEADS_LAUNCHES
    got = fa.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.HEADS_LAUNCHES == n0 + 1
    assert got.shape == (b, h, s, 64) and got.dtype == dtype
    lanes = [t.reshape(b, s, h * 64) for t in x]
    kb = bias.reshape(b, s)
    heads = fa.attention_qkv_heads(*lanes, kb, num_heads=h)
    slab = fa.attention_qkv_slab(torch.cat(lanes, -1), kb, num_heads=h)
    torch.testing.assert_close(got.transpose(1, 2).reshape(b, s, h * 64),
                               heads, rtol=0, atol=0)
    torch.testing.assert_close(heads, slab, rtol=0, atol=0)


def test_mha_attention_use_flash_on_the_card(cuda):
    """mha_attention(use_flash=True) with a [B, 1, 1, S] mask goes through
    the kernel once, to the plain path's values."""
    from keep_tpu_torch.ops.nn import mha_attention

    q, k, v = (torch.randn(2, 4, 50, 64, device="cuda", generator=cuda)
               for _ in range(3))
    bias = torch.zeros(2, 1, 1, 50, device="cuda")
    bias[1, ..., 30:] = -1e9
    n0 = fa.HEADS_LAUNCHES
    got = mha_attention(q, k, v, bias=bias, use_flash=True)
    torch.cuda.synchronize()
    assert fa.HEADS_LAUNCHES == n0 + 1
    torch.testing.assert_close(got, mha_attention(q, k, v, bias=bias),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (70, 64, 48), (394, 1024, 3072),
                                   (300, 4096, 200), (129, 48, 136),
                                   (132 * 128 + 1, 80, 264),
                                   (128 * 197, 1024, 4096)])
def test_ln_matmul_matches_plain(cuda, m, k, n, dtype, out_dtype):
    """The kernel against its plain version: fp32 at 2e-5; bf16 within one
    bf16 rounding of the output (rtol 2⁻⁷, atol 1e-2 near zero: the sums are
    taken in another order in fp32 before the one rounding). The shapes
    take the bf16 body's edges: one tile and less, K in part of a 64-wide
    stage (80), N a full 256-column tile and part of another (264), more
    128-row tiles than one persistent wave of 132 blocks takes, and ViT-L
    fc1 at B=128."""
    x = (torch.randn(m, k, device="cuda", generator=cuda) * 3 + 1).to(dtype)
    g = 1 + 0.1 * torch.randn(k, device="cuda", generator=cuda)
    b = 0.1 * torch.randn(k, device="cuda", generator=cuda)
    w = (torch.randn(n, k, device="cuda", generator=cuda) * k ** -0.5).to(dtype)
    bias = 0.02 * torch.randn(n, device="cuda", generator=cuda)
    n0 = lm.LAUNCHES
    got = lm.ln_matmul(x, g, b, w, bias, 1e-6, out_dtype)
    torch.cuda.synchronize()
    assert lm.LAUNCHES == n0 + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    ref = lm.ln_matmul_reference(x, g, b, w, bias, 1e-6, out_dtype)
    if dtype == torch.float32 and out_dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7)


def test_ln_matmul_normalised_rows_are_ln_rows_bits(cuda):
    """With an identity weight and a zero bias the kernel returns its
    normalised, rounded rows: bit for bit those of the plain LayerNorm
    (fp64 statistics rounded once, the same fp32 chain). An identity weight
    sums one y per output, whatever the order of the sums; K = 256 and the
    ViT-L width 1024 take the statistics pass with 2 to 8 chunks a lane."""
    for m, k in ((130, 256), (394, 1024)):
        x = torch.randn(m, k, device="cuda", generator=cuda) * 2 + 0.5
        g = 1 + 0.1 * torch.randn(k, device="cuda", generator=cuda)
        b = 0.1 * torch.randn(k, device="cuda", generator=cuda)
        for dtype in (torch.float32, torch.bfloat16):
            eye = torch.eye(k, device="cuda", dtype=dtype)
            got = lm.ln_matmul(x.to(dtype), g, b, eye,
                               torch.zeros(k, device="cuda"), 1e-6,
                               torch.float32)
            want = _kops.ln_rows_reference(x.to(dtype).float(), g, b, 1e-6,
                                           dtype).float()
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_matmul_reads_nothing_past_its_operands(cuda, dtype):
    """x, the LayerNorm vectors and the weight are views at the start of
    NaN-filled buffers: NaN in the rows after M of x, past K in g and b and
    in the rows after N of the weight. The tiles reach past all three (M,
    N and K are none of them a multiple of the tile), so a read past an
    operand, or a zero fill that ln_apply turns into b − mu·rstd·g, shows
    as a non-finite or wrong output."""
    m, k, n = 200, 80, 264
    nan = float("nan")

    def view(shape, fill_rows, scale=1.0, shift=0.0):
        buf = torch.full((shape[0] + fill_rows, *shape[1:]), nan,
                         device="cuda", dtype=torch.float32)
        v = buf[:shape[0]]
        v.copy_(torch.randn(*shape, device="cuda", generator=cuda) * scale
                + shift)
        return buf, v

    x_buf, x = view((m, k), 7, 3.0, 1.0)
    w_buf, w = view((n, k), 9, k ** -0.5)
    g_buf, g = view((k,), 16, 0.1, 1.0)
    b_buf, b = view((k,), 16, 0.1)
    if dtype == torch.bfloat16:
        x_buf, w_buf = x_buf.bfloat16(), w_buf.bfloat16()
        x, w = x_buf[:m], w_buf[:n]
    bias = 0.02 * torch.randn(n, device="cuda", generator=cuda)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = lm.ln_matmul(x, g, b, w, bias, 1e-6, out_dtype)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        ref = lm.ln_matmul_reference(x, g, b, w, bias, 1e-6, out_dtype)
        if dtype == torch.float32 and out_dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
        else:
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                       rtol=2 ** -7)


@pytest.mark.parametrize("m", [1, 70, 394])
def test_flat_qmlp_matches_bsd_bits_on_the_card(cuda, m):
    """The flat int8 MLP through the kernels equals quantized_mlp_bsd on the
    same rows bit for bit, and its plain version at qmlp's tolerance."""
    d, f = 128, 512
    x = torch.randn(m, d, device="cuda", generator=cuda) * 0.5
    fc1, fc2 = _qlin(cuda, d, f), _qlin(cuda, f, d)
    ps = torch.rand(d, device="cuda", generator=cuda) + 0.5
    args = (fc1.weight_q, fc1.weight_scale, fc1.bias, fc2.weight_q,
            fc2.weight_scale, fc2.bias)
    n0 = _kops.LAUNCHES["quantized_mlp"]
    got = qmlp.quantized_mlp(x, *args, out_dtype=torch.float32, pre_scale1=ps)
    torch.cuda.synchronize()
    assert _kops.LAUNCHES["quantized_mlp"] == n0 + 1
    bsd = qmlp.quantized_mlp_bsd(x[None], *args, out_dtype=torch.float32,
                                 pre_scale1=ps)[0]
    torch.testing.assert_close(got, bsd, rtol=0, atol=0)
    ref = qmlp.quantized_mlp_reference(x, *args, out_dtype=torch.float32,
                                       pre_scale1=ps)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-4)


def test_vit_fuse_ln_on_the_card(cuda, monkeypatch):
    """A small bf16 ViT under use_flash + fuse_ln, on random weights whose
    blocks all move the stream (LayerScale 0.1–0.5): two ln_matmul and one
    slab-attention launch per block, features within cos 0.999 of the
    unfused forward, and every ln_matmul call of the forward within one bf16
    rounding of its plain version on the same inputs."""
    from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                    random_keep_state_dict)
    from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig
    from keep_tpu_torch.models import vit
    from keep_tpu_torch.models.keep import KEEPModel

    cfg = KEEPConfig(vision=ViTConfig(img_size=32, patch_size=8,
                                      embed_dim=128, depth=2, num_heads=2),
                     text=BertConfig(vocab_size=64, hidden_size=128,
                                     num_hidden_layers=1,
                                     num_attention_heads=2,
                                     intermediate_size=256,
                                     max_position_embeddings=32),
                     projection_dim=128)
    model = KEEPModel(cfg, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(load_keep_state_dict(random_keep_state_dict(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        cfg))
    px = torch.randn(5, 32, 32, 3, device="cuda", generator=cuda)
    kw = dict(dtype=torch.bfloat16, use_flash=True, gelu_approx=True)
    held = []

    def ln_matmul_held(x, g, b, w, bias, eps=1e-6, out_dtype=torch.bfloat16):
        got = lm.ln_matmul(x, g, b, w, bias, eps, out_dtype)
        ref = lm.ln_matmul_reference(x, g, b, w, bias, eps, out_dtype)
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7)
        held.append(x.shape)
        return got

    with torch.inference_mode():
        n0, a0 = lm.LAUNCHES, fa.LAUNCHES
        fused = model.visual(px, fuse_ln=True, **kw).float()
        torch.cuda.synchronize()
        assert (lm.LAUNCHES - n0, fa.LAUNCHES - a0) == (4, 2)
        base = model.visual(px, **kw).float()
        monkeypatch.setattr(vit, "ln_matmul", ln_matmul_held)
        model.visual(px, fuse_ln=True, **kw)
    assert held == [(5 * 17, 128)] * 4
    cos = torch.nn.functional.cosine_similarity(fused, base, dim=-1)
    assert torch.isfinite(fused).all() and cos.min().item() >= 0.999


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.attention_qkv_heads(*(torch.zeros(1, 4, 64, device="cuda"),) * 3,
                               num_heads=2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.attention_qkv_heads(q, q, q.bfloat16(), num_heads=1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.attention_qkv_heads(*(q.half(),) * 3, num_heads=1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_qkv_heads(
            q, q, torch.zeros(1, 64, 4, device="cuda").transpose(1, 2),
            num_heads=1)
    with pytest.raises(ValueError, match="S ≤"):
        fa.attention_qkv_heads(*(torch.zeros(1, 513, 64, device="cuda"),) * 3,
                               num_heads=1)
    x = torch.zeros(4, 64, device="cuda")
    one, zero = torch.ones(64, device="cuda"), torch.zeros(8, device="cuda")
    w = torch.zeros(8, 64, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        lm.ln_matmul(x[:, :40].contiguous(), one[:40], one[:40],
                     w[:, :40].contiguous(), zero)
    with pytest.raises(ValueError, match="multiple of 8"):
        lm.ln_matmul(x, one, one, w[:6], zero[:6])
    with pytest.raises(ValueError, match="at most 4096"):
        big = torch.zeros(2, 4112, device="cuda")
        lm.ln_matmul(big, big[0], big[0], torch.zeros(8, 4112, device="cuda"),
                     zero)
    with pytest.raises(TypeError, match="same dtype"):
        lm.ln_matmul(x.bfloat16(), one, one, w, zero)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lm.ln_matmul(x.half(), one, one, w.half(), zero)
    with pytest.raises(TypeError, match="writes float32 or bfloat16"):
        lm.ln_matmul(x, one, one, w, zero, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        lm.ln_matmul(torch.zeros(64, 4, device="cuda").t(), one, one, w, zero)
    # a view that starts one float into its storage: the kernel reads the
    # LayerNorm vectors four floats at a time
    shifted = torch.ones(65, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned ln_scale"):
        lm.ln_matmul(x, shifted, one, w, zero)
    with pytest.raises(ValueError, match="aligned ln_bias"):
        lm.ln_matmul(x, one, shifted, w, zero)


# ---- the zero-shot WSI sweep on the card ------------------------------------


@contextlib.contextmanager
def _unguarded():
    """The sweep's fp32 products without ``ieee_fp32``: the control that
    shows the guard is what keeps TF32 out."""
    from keep_tpu_torch.ops import preprocess
    from keep_tpu_torch.wsi import pipelines
    from keep_tpu_torch.zeroshot import classifier

    mods = (preprocess, pipelines, classifier)
    saved = [m.ieee_fp32 for m in mods]
    for m in mods:
        m.ieee_fp32 = contextlib.nullcontext
    try:
        yield
    finally:
        for m, g in zip(mods, saved):
            m.ieee_fp32 = g


def _pixels_255(x):
    from keep_tpu_torch.configs import PreprocessConfig

    cfg = PreprocessConfig()
    mean = torch.tensor(cfg.mean, device=x.device)
    std = torch.tensor(cfg.std, device=x.device)
    return (x * std + mean) * 255.0


@pytest.mark.parametrize("shape", [(32, 256, 256), (4, 448, 300)])
def test_bicubic_on_the_card_matches_the_cpu(cuda, shape):
    """The card's two fp32 einsums against the CPU's: ≤ 1/255 per pixel
    before normalisation (a sum within float noise of a .5 may round the
    other way between the passes), and the same bits with TF32 on."""
    from keep_tpu_torch.ops.preprocess import preprocess

    g = torch.Generator().manual_seed(0)
    tiles = torch.randint(0, 256, (*shape, 3), dtype=torch.uint8, generator=g)
    got = preprocess(tiles.cuda())
    ref = preprocess(tiles)
    diff = (_pixels_255(got.cpu()) - _pixels_255(ref)).abs()
    assert diff.max().item() <= 1.0 + 1e-3
    assert (diff > 0.5).float().mean().item() <= 0.01
    with _tf32(True):
        assert torch.equal(preprocess(tiles.cuda()), got)
        # the control: without the guard TF32 moves the pixels
        with _unguarded():
            assert not torch.equal(preprocess(tiles.cuda()), got)


def test_scores_and_screening_on_the_card(cuda):
    """score_tiles and the prompt screening on the card against the CPU
    (probabilities and the merged classifier at 1e-5, the same top-n set),
    and the same bits with TF32 on."""
    from keep_tpu_torch.wsi.pipelines import score_tiles
    from keep_tpu_torch.zeroshot.classifier import _prompt_select_jit

    g = torch.Generator().manual_seed(0)
    feats = torch.randn(5000, 768, generator=g)
    stack = torch.nn.functional.normalize(torch.randn(300, 768, 2,
                                                      generator=g), dim=1)
    got = score_tiles(stack[0], feats.cuda())
    torch.testing.assert_close(got.cpu(), score_tiles(stack[0], feats),
                               atol=1e-5, rtol=0)
    merged, scores, order = _prompt_select_jit(stack.cuda(), feats.cuda(), 50)
    m_cpu, s_cpu, o_cpu = _prompt_select_jit(stack, feats, 50)
    assert set(order.tolist()) == set(o_cpu.tolist())
    torch.testing.assert_close(merged.cpu(), m_cpu, atol=1e-5, rtol=0)
    with _tf32(True):
        assert torch.equal(score_tiles(stack[0], feats.cuda()), got)
        again = _prompt_select_jit(stack.cuda(), feats.cuda(), 50)
        assert all(torch.equal(a, b) for a, b in zip(again,
                                                     (merged, scores, order)))
        # the control: without the guard TF32 moves the probabilities and
        # the screening's scores
        with _unguarded():
            assert not torch.equal(score_tiles(stack[0], feats.cuda()), got)
            assert not torch.equal(
                _prompt_select_jit(stack.cuda(), feats.cuda(), 50)[1], scores)


def test_extract_features_on_the_card(cuda):
    """A small bf16 KEEP with the fused attention: one attention launch per
    block and batch, pipeline depths 1, 2 and 3 give the same bits, and the
    features hold cosine ≥ 0.999 against plain attention."""
    from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                    random_keep_state_dict)
    from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.wsi.extract import extract_features

    cfg = KEEPConfig(vision=ViTConfig(img_size=32, patch_size=8,
                                      embed_dim=128, depth=2, num_heads=2),
                     text=BertConfig(vocab_size=64, hidden_size=128,
                                     num_hidden_layers=1,
                                     num_attention_heads=2,
                                     intermediate_size=256,
                                     max_position_embeddings=32),
                     projection_dim=128)
    sd = load_keep_state_dict(random_keep_state_dict(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        cfg)
    model = KEEPModel(cfg, device="cuda", dtype=torch.bfloat16,
                      use_flash=True)
    model.load_state_dict(sd)
    plain = KEEPModel(cfg, device="cuda", dtype=torch.bfloat16)
    plain.load_state_dict(sd)
    g = torch.Generator().manual_seed(0)
    tiles = torch.randint(0, 256, (37, 32, 32, 3), dtype=torch.uint8,
                          generator=g).numpy()
    n0 = fa.LAUNCHES
    feats = extract_features(model, tiles, batch_size=8)
    assert fa.LAUNCHES - n0 == 5 * cfg.vision.depth
    assert feats.shape == (37, 128)
    for depth in (1, 3):
        assert (extract_features(model, tiles, batch_size=8,
                                 pipeline_depth=depth) == feats).all()
    ref = extract_features(plain, tiles, batch_size=8)
    cos = (feats * ref).sum(1) / ((feats ** 2).sum(1) * (ref ** 2).sum(1)
                                  ) ** 0.5
    assert cos.min() >= 0.999
