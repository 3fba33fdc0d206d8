"""LayerNorm fused into the matmul that follows it (inference only).

Counterpart of ``keep_tpu/kernels/ln_matmul.py`` ``ln_matmul`` (the Pallas
kernel at :51), which the ViT runs under ``fuse_ln=True`` for the qkv and
fc1 projections. For a CUDA tensor ``ln_matmul`` launches the hand-written
Hopper kernels in ``csrc/ln_matmul.cu``: a row-statistics pass that reads x
once, then, in bf16, a persistent GEMM on ``wgmma`` fed by TMA whose
consumer warps normalise each stage of x in the registers that feed the
tensor cores, so the normalised [M, K] never reaches device memory (fp32
keeps a CUDA-core FMA loop). For a CPU tensor it runs
``ln_matmul_reference``, the same math in plain PyTorch, which the tests and
``chip_smoke.py`` also hold the kernel against. There is no fallback from
one to the other. Left open on the card: the epilogue does not overlap the
next tile's products, and with the normalised stages after it costs about
40% of the GEMM's time; the statistics pass is a launch of its own.

The weight is in the torch layout, ``weight [N, K]``: the transpose of the
JAX kernel's ``w [K, N]``.
"""

from __future__ import annotations

import threading

import torch

from keep_tpu_torch.kernels import _kops
from keep_tpu_torch.kernels._library import define

MAX_K = 4096  # the row statistics and the K loop are written for K ≤ 4096

# Count of kernel launches in this process; a run resets it to check that
# its main path went through the kernel.
LAUNCHES = 0
_launch_lock = threading.Lock()


def _check(x, ln_scale, ln_bias, weight, w_bias):
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"ln_matmul takes x [M, K] and weight [N, K], got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    k = x.shape[1]
    n = weight.shape[0]
    for name, v, size in (("ln_scale", ln_scale, k), ("ln_bias", ln_bias, k),
                          ("w_bias", w_bias, n)):
        if tuple(v.shape) != (size,):
            raise ValueError(f"{name} must be [{size}], got {tuple(v.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ln_scale, ln_bias, weight, w_bias)):
        raise NotImplementedError(
            "ln_matmul is inference-only (the JAX kernel has no VJP); run it "
            "under torch.no_grad() / torch.inference_mode(), or train "
            "through the unfused LayerNorm and linear (fuse_ln=False)")


def ln_matmul_reference(x: torch.Tensor, ln_scale: torch.Tensor,
                        ln_bias: torch.Tensor, weight: torch.Tensor,
                        w_bias: torch.Tensor, eps: float = 1e-6,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """The kernel's math in plain PyTorch: the fp32 row LayerNorm of
    ``_kops.ln_rows_reference`` rounded to the weight's dtype, times
    ``weightᵀ`` in fp32 (a product of bf16 values is exact in fp32), plus
    the fp32 bias, cast to ``out_dtype``."""
    _check(x, ln_scale, ln_bias, weight, w_bias)
    y = _kops.ln_rows_reference(x.float(), ln_scale, ln_bias, eps,
                                out_dtype=weight.dtype)
    out = y.float() @ weight.float().t() + w_bias.float()
    return out.to(out_dtype)


def _ln_matmul_cuda(x, ln_scale, ln_bias, weight, w_bias, eps, out_dtype):
    """``keep::ln_matmul`` on the card: the launch, counted in
    ``LAUNCHES``."""
    global LAUNCHES
    m, k = x.shape
    n = weight.shape[0]
    if x.dtype not in _kops._DTYPE_CODE or weight.dtype != x.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 x with a "
                        f"weight of the same dtype, got {x.dtype} and "
                        f"{weight.dtype}")
    if out_dtype not in _kops._DTYPE_CODE:
        raise TypeError(f"the kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    if k % 16 or k > MAX_K or n % 8:
        raise ValueError(f"the kernel takes K a multiple of 16 and at most "
                         f"{MAX_K}, and N a multiple of 8, got K={k}, N={n}")
    if (m + 63) // 64 > 65535:
        raise ValueError(f"the kernel takes M ≤ {65535 * 64}, got {m}")
    dev = x.device
    if weight.device != dev:
        raise ValueError(f"weight must be on {dev}, got {weight.device}")
    _kops._check_contiguous("x", x, 16)
    _kops._check_contiguous("weight", weight, 16)
    g = _kops._vector("ln_scale", ln_scale, k, dev)
    b = _kops._vector("ln_bias", ln_bias, k, dev)
    # the kernel reads the LayerNorm vectors with aligned vector loads
    _kops._check_contiguous("ln_scale", g, 16)
    _kops._check_contiguous("ln_bias", b, 16)
    bias = _kops._vector("w_bias", w_bias, n, dev)
    stats = torch.empty(m, 2, dtype=torch.float32, device=dev)
    out = torch.empty(m, n, dtype=out_dtype, device=dev)

    from keep_tpu_torch.kernels._build import library

    code = _kops._DTYPE_CODE
    _kops._raise_on(library().keep_ln_matmul(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), eps, weight.data_ptr(),
        bias.data_ptr(), stats.data_ptr(), out.data_ptr(), code[x.dtype],
        code[out_dtype], m, n, k, _kops._stream(x)), "ln_matmul")
    with _launch_lock:
        LAUNCHES += 1
    return out


define("ln_matmul(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor weight, "
       "Tensor w_bias, float eps, ScalarType out_dtype) -> Tensor",
       _ln_matmul_cuda, lambda *a: ln_matmul_reference(*a),
       lambda x, ln_scale, ln_bias, weight, w_bias, eps, out_dtype:
       x.new_empty((x.shape[0], weight.shape[0]), dtype=out_dtype))


def ln_matmul(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
              weight: torch.Tensor, w_bias: torch.Tensor, eps: float = 1e-6,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [M, K] → LayerNorm (fp32, ``ln_scale``/``ln_bias`` [K]) → rounded
    to the weight's dtype → · ``weight`` [N, K]ᵀ (fp32 accumulation) +
    ``w_bias`` [N] in fp32 → [M, N] ``out_dtype``; ``keep::ln_matmul``.

    A CUDA tensor goes through the kernel, which takes fp32 x with an fp32
    weight or bf16 x with a bf16 weight, an fp32 or bf16 output, K a
    multiple of 16 and at most 4096, N a multiple of 8, contiguous,
    16-byte aligned x and weight (any M), and ``ln_scale`` / ``ln_bias``
    that are 16-byte aligned once in fp32, and raises on anything else; a
    CPU tensor goes through the plain version. Inference-only: raises under
    autograd."""
    _check(x, ln_scale, ln_bias, weight, w_bias)
    _kops._check_device(x)
    return torch.ops.keep.ln_matmul(x, ln_scale, ln_bias, weight, w_bias, eps,
                                    out_dtype)
