"""The ``keep::`` operators (``keep_tpu_torch/kernels/_library.py``): each
hand-written kernel's C entry point as a PyTorch operator with a CUDA
implementation (the kernel), a CPU implementation (its plain version) and a
fake one (shapes only). ``torch.library.opcheck`` holds each on the CPU:
the schema (no input mutated or aliased), the fake implementation against
the real one, the autograd registration, and a traced run with dynamic
shapes. The card's implementations are held by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``."""

import pytest
import torch
from torch.library import opcheck

from keep_tpu_torch.kernels import _kops
from keep_tpu_torch.kernels import flash_attention as fa
from keep_tpu_torch.kernels import ln_matmul as lm

OPERATORS = ("attention_qkv_slab", "attention_qkv_slab_bwd",
             "attention_qkv_heads", "quant_rows", "int8_gemm", "ln_rows",
             "ln_matmul")


def _gen():
    return torch.Generator().manual_seed(0)


def _slab(dtype=torch.float32, b=2, s=5, h=2, dh=64):
    return torch.randn(b, s, 3 * h * dh, generator=_gen()).to(dtype)


def _bias(b=2, s=5):
    kb = torch.zeros(b, s)
    kb[1, 3:] = -1e9
    return kb


def _int8(m, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)


def _cases():
    g = _gen()
    x = torch.randn(6, 32, generator=g)
    vec = torch.randn(32, generator=g)
    xq, wq = _int8(6, 32), _int8(16, 32, 1)
    a_s, w_s = torch.rand(6, generator=g), torch.rand(16, generator=g)
    bias = torch.randn(16, generator=g)
    q = torch.randn(2, 2, 5, 64, generator=g)
    return {
        "attention_qkv_slab-fp32": ("attention_qkv_slab",
                                    (_slab(), None, 2, torch.float32)),
        "attention_qkv_slab-bias-bf16-to-fp32": (
            "attention_qkv_slab",
            (_slab(torch.bfloat16), _bias(), 2, torch.float32)),
        "attention_qkv_slab-grad": (
            "attention_qkv_slab",
            (_slab().requires_grad_(), _bias(), 2, torch.float32)),
        "attention_qkv_slab_bwd": (
            "attention_qkv_slab_bwd",
            (_slab(), _bias(), torch.randn(2, 5, 128, generator=g), 2)),
        "attention_qkv_heads": ("attention_qkv_heads",
                                (q, q + 1, q - 1, _bias(), 2)),
        "quant_rows": ("quant_rows", (x, None, None, 1e-6, None)),
        "quant_rows-ln-pre_scale": ("quant_rows",
                                    (x.bfloat16(), vec, vec, 1e-6, vec.abs())),
        "int8_gemm-left": ("int8_gemm", (xq, a_s, wq, w_s, bias,
                                         _kops.DEQUANT_LEFT, False, None,
                                         torch.bfloat16, None)),
        "int8_gemm-gelu-residual-block": (
            "int8_gemm", (xq, a_s, wq, w_s, bias, _kops.DEQUANT_PAIRED, True,
                          torch.randn(6, 16, generator=g), torch.float32,
                          "quantized_mlp")),
        "ln_rows": ("ln_rows", (x, vec, vec, 1e-6, torch.bfloat16,
                                "quantized_attention_block_postln")),
        "ln_matmul": ("ln_matmul", (x, vec, vec,
                                    torch.randn(16, 32, generator=g), bias,
                                    1e-6, torch.float32)),
    }


CASES = _cases()


def test_every_kernel_entry_point_is_an_operator():
    for name in OPERATORS:
        op = getattr(torch.ops.keep, name).default
        assert op._schema.name == f"keep::{name}"
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                f"keep::{name}", key), (name, key)
    assert {name for name, _ in CASES.values()} == set(OPERATORS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    name, args = CASES[case]
    opcheck(getattr(torch.ops.keep, name).default, args)


def test_wrappers_run_the_operators_plain_version_on_the_cpu():
    """On a CPU tensor each wrapper returns its plain version's bits and
    counts no launch."""
    before = (fa.LAUNCHES, fa.HEADS_LAUNCHES, lm.LAUNCHES,
              sum(_kops.LAUNCHES.values()))
    qkv, kb = _slab(), _bias()
    torch.testing.assert_close(
        fa.attention_qkv_slab(qkv, kb, num_heads=2),
        fa.attention_qkv_slab_reference(qkv, kb, num_heads=2), rtol=0, atol=0)
    x = torch.randn(6, 32, generator=_gen())
    q, s = _kops.quant_rows(x)
    rq, rs = _kops.quant_rows_reference(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    wq, a, w_s = _int8(16, 32, 1), torch.rand(6), torch.rand(16)
    torch.testing.assert_close(
        _kops.int8_gemm(q, a, wq, w_s, torch.zeros(16), order=1, gelu=True,
                        block="quantized_mlp"),
        _kops.int8_gemm_reference(q, a, wq, w_s, torch.zeros(16), order=1,
                                  gelu=True), rtol=0, atol=0)
    assert before == (fa.LAUNCHES, fa.HEADS_LAUNCHES, lm.LAUNCHES,
                      sum(_kops.LAUNCHES.values()))


def test_slab_gradient_goes_through_the_backward_operator():
    """The slab's autograd formula is the backward operator's: the same
    bits as ``attention_qkv_slab_bwd`` on the saved slab and bias."""
    qkv, kb = _slab().requires_grad_(), _bias()
    dout = torch.randn(2, 5, 128, generator=_gen())
    fa.attention_qkv_slab(qkv, kb, num_heads=2).backward(dout)
    ref = fa.attention_qkv_slab_bwd(qkv.detach(), kb, dout, 2)
    assert torch.equal(qkv.grad, ref)


@pytest.mark.parametrize("device", ["cuda:1", "cuda:3"])
def test_cuda_impls_run_on_their_tensors_card(monkeypatch, device):
    """Each operator's CUDA implementation enters the card of its first
    tensor for the call (``_library.on_device``): the kernels' C code reads
    the current device (SM count, shared-memory opt-in) and launches on
    its current stream, so a tensor on another card than the caller's
    current one must make its own card current. Checked with the device
    context recorded."""
    from keep_tpu_torch.kernels import _library

    entered = []

    class Recorder:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(("enter", torch.device(self.dev)))

        def __exit__(self, *exc):
            entered.append(("exit", torch.device(self.dev)))

    monkeypatch.setattr(torch.cuda, "device", Recorder)
    seen = []
    run = _library.on_device(lambda x, *a, **k: seen.append((a, k)) or 7)
    # stands in for a tensor on that card: the wrapper reads its .device
    fake = type("T", (), {"device": torch.device(device)})()
    assert run(fake, 1, block="qkv") == 7
    assert entered == [("enter", torch.device(device)),
                       ("exit", torch.device(device))]
    assert seen == [((1,), {"block": "qkv"})]
