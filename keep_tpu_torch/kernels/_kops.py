"""The math the int8 kernels share, and the three CUDA kernels made of it.

Counterpart of ``keep_tpu/kernels/_kops.py`` (``gelu_tanh``, ``quant_rows``,
``int8_dot``, ``ln_rows``). The JAX package keeps that math in one module so
that every int8 Pallas kernel rounds the same way; the port keeps it twice,
once here in plain PyTorch and once in ``csrc/kops.cuh`` for the CUDA
kernels, and holds the two against each other on the card.

The TPU megakernels run these steps on VMEM-resident blocks between their
MXU dots. On Hopper they are three kernels (``csrc/quant_rows.cu``,
``csrc/int8_gemm.cu``):

- ``quant_rows``: optional row LayerNorm and per-channel ``pre_scale``, then
  per-row abs-max int8 quantization → (int8 codes, fp32 row scales).
- ``int8_gemm``: int8 × int8 → int32 on the tensor cores, with the dequant
  epilogue (in either of the TPU kernels' two orders), bias, optional
  tanh-GELU and optional residual.
- ``ln_rows``: fp32 row LayerNorm, cast once to the output dtype.

Each wrapper launches its kernel for a CUDA tensor and raises on what the
kernel does not take; for a CPU tensor it runs its plain version
(``*_reference``), which the tests and ``chip_smoke.py`` also hold the
kernel against. There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches by name in this process, for these
three kernels and for the int8 counterparts of the TPU kernels built from
them (``qmatmul``, ``qmlp``, ``qblock``); a run clears it to check that its
main path went through them.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, NamedTuple

import torch

from keep_tpu_torch.kernels.flash_attention import (
    attention_qkv_slab, attention_qkv_slab_reference)

MAX_ROW = 4096  # quant_rows / ln_rows keep a whole row in a block's registers

# dequant orders of the TPU kernels' epilogues: fp32 products do not
# associate, and each kernel has its own
DEQUANT_LEFT = 0    # (acc·a)·s — qmatmul.py:44,109
DEQUANT_PAIRED = 1  # acc·(a·s) — qblock.py:57,66 and qmlp.py:141,145

LAUNCHES: collections.Counter = collections.Counter()
_launch_lock = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def count(name: str) -> None:
    """Adds one launch of ``name`` to ``LAUNCHES``."""
    with _launch_lock:
        LAUNCHES[name] += 1


# ---- plain PyTorch math -----------------------------------------------------


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU, evaluated in the JAX helper's order."""
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def ln_rows_reference(xf: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                      eps: float, out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Row LayerNorm of fp32 [M, D]: the mean, then the mean of (x − mean)²,
    then ``(x − mean)·(1/sqrt(var + eps))·g + b``, cast once to
    ``out_dtype``. The two means are summed in fp64 and rounded once to
    fp32, as in the kernels, so that neither depends on the order of
    summation and the kernels' int8 codes can equal these bit for bit."""
    mu = xf.double().mean(-1, keepdim=True).float()
    d = xf - mu
    var = d.double().square().mean(-1, keepdim=True).float()
    y = d * (1.0 / torch.sqrt(var + eps)) * g.float() + b.float()
    return y.to(out_dtype)


def quant_rows_reference(x: torch.Tensor, ln_scale: torch.Tensor | None = None,
                         ln_bias: torch.Tensor | None = None, eps: float = 1e-6,
                         pre_scale: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, K] → (int8 codes [M, K], fp32 scales [M]) with ``q·scale ≈ y``,
    y = (LN(x))·pre_scale in fp32. ``scale = max(amax, 1e-8)·(1/127)`` and
    ``q = clip(round(y·(1/scale)), ±127)``: a reciprocal multiply, as the
    kernels do, and round half to even."""
    y = x.float()
    if ln_scale is not None:
        y = ln_rows_reference(y, ln_scale, ln_bias, eps)
    if pre_scale is not None:
        y = y * pre_scale.float()
    amax = y.abs().amax(-1, keepdim=True)
    scale = amax.clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(y * (1.0 / scale)), -127, 127)
    return q.to(torch.int8), scale.squeeze(-1)


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] × int8 [N, K]ᵀ → int32 [M, N].

    On the card this is cuBLAS's int8 GEMM (``torch._int_mm``) where its
    shape rules allow; elsewhere a float64 product, which is exact because
    |acc| ≤ K·127² < 2⁵³. Never an fp32 or bf16 dot."""
    m, k = xq.shape
    n = wq.shape[0]
    if xq.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(xq, wq.t())
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_gemm_reference(xq: torch.Tensor, a_scale: torch.Tensor,
                        wq: torch.Tensor, w_scale: torch.Tensor,
                        bias: torch.Tensor, *, order: int, gelu: bool = False,
                        residual: torch.Tensor | None = None,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """The kernel's math: exact int32 dot, dequant in ``order``, + bias,
    optional tanh-GELU, optional ``residual + ·`` in fp32, one cast."""
    acc = int8_dot(xq, wq).float()
    a, s = a_scale.float()[:, None], w_scale.float()[None, :]
    v = acc * a * s if order == DEQUANT_LEFT else acc * (a * s)
    v = v + bias.float()
    if gelu:
        v = gelu_tanh(v)
    if residual is not None:
        v = residual.float() + v
    return v.to(out_dtype)


# ---- the kernels' wrappers ---------------------------------------------------


def _device_path(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for others."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def _check_contiguous(name: str, t: torch.Tensor, align: int = 1) -> None:
    if not t.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous {name}")
    if t.data_ptr() % align:
        raise ValueError(f"the kernel takes a {align}-byte aligned {name}")


def _vector(name: str, v: torch.Tensor, n: int, device) -> torch.Tensor:
    if tuple(v.shape) != (n,):
        raise ValueError(f"{name} must be [{n}], got {tuple(v.shape)}")
    if v.device != device:
        raise ValueError(f"{name} must be on {device}, got {v.device}")
    return v.float().contiguous()


def _row_vector(name: str, v: torch.Tensor | None, n: int, device
                ) -> torch.Tensor | None:
    """A per-channel vector of the row kernels, which read it 16 bytes at a
    time: fp32 [n], 16-byte aligned once in fp32."""
    if v is None:
        return None
    v = _vector(name, v, n, device)
    _check_contiguous(name, v, 16)
    return v


def _check_row_width(k: int) -> None:
    if k > MAX_ROW:
        raise ValueError(f"the kernel takes rows of at most {MAX_ROW}, got {k}")
    if k % 16:
        raise ValueError(f"the kernel takes rows of a multiple of 16 values, "
                         f"got {k}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def quant_rows(x: torch.Tensor, ln_scale: torch.Tensor | None = None,
               ln_bias: torch.Tensor | None = None, eps: float = 1e-6,
               pre_scale: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (bf16 or fp32) → (int8 codes [M, K], fp32 scales [M]), with
    an optional row LayerNorm (``ln_scale``/``ln_bias`` [K], ``eps``) and
    per-channel ``pre_scale`` [K] in front. A CUDA tensor goes through the
    kernel (contiguous and 16-byte aligned, K a multiple of 16 and at most
    4096); a CPU tensor through the plain version."""
    if x.dim() != 2:
        raise ValueError(f"quant_rows takes [M, K], got {tuple(x.shape)}")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    if not _device_path(x):
        return quant_rows_reference(x, ln_scale, ln_bias, eps, pre_scale)
    m, k = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    _check_row_width(k)
    _check_contiguous("x", x, 16)
    dev = x.device
    g = _row_vector("ln_scale", ln_scale, k, dev)
    b = _row_vector("ln_bias", ln_bias, k, dev)
    ps = _row_vector("pre_scale", pre_scale, k, dev)
    q = torch.empty(m, k, dtype=torch.int8, device=dev)
    scale = torch.empty(m, dtype=torch.float32, device=dev)

    from keep_tpu_torch.kernels._build import library

    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _raise_on(library().keep_quant_rows(
        x.data_ptr(), _DTYPE_CODE[x.dtype], ptr(g), ptr(b), eps, ptr(ps),
        q.data_ptr(), scale.data_ptr(), m, k, _stream(x)), "quant_rows")
    count("quant_rows")
    return q, scale


def int8_gemm(xq: torch.Tensor, a_scale: torch.Tensor, wq: torch.Tensor,
              w_scale: torch.Tensor, bias: torch.Tensor, *, order: int,
              gelu: bool = False, residual: torch.Tensor | None = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 xq [M, K] (row scales ``a_scale`` [M]) × int8 wq [N, K] (column
    scales ``w_scale`` [N]) → [M, N] ``out_dtype``: dequant in ``order``
    (``DEQUANT_LEFT`` or ``DEQUANT_PAIRED``), + ``bias`` [N], optional
    tanh-GELU, optional ``residual`` [M, N] added in fp32. A CUDA tensor goes
    through the kernel (contiguous 16-byte aligned operands and residual, K
    a multiple of 16, N of 8); a CPU tensor through the plain version."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_gemm takes [M, K] × [N, K], got "
                         f"{tuple(xq.shape)} × {tuple(wq.shape)}")
    if order not in (DEQUANT_LEFT, DEQUANT_PAIRED):
        raise ValueError(f"unknown dequant order {order}")
    m, k = xq.shape
    n = wq.shape[0]
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual must be [{m}, {n}], got "
                         f"{tuple(residual.shape)}")
    if not _device_path(xq):
        return int8_gemm_reference(xq, a_scale, wq, w_scale, bias, order=order,
                                   gelu=gelu, residual=residual,
                                   out_dtype=out_dtype)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"the kernel takes int8 operands, got {xq.dtype} and "
                        f"{wq.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    if k % 16 or n % 8:
        raise ValueError(f"the kernel takes K a multiple of 16 and N of 8, got "
                         f"K={k}, N={n}")
    dev = xq.device
    if wq.device != dev:
        raise ValueError(f"wq must be on {dev}, got {wq.device}")
    _check_contiguous("xq", xq, 16)
    _check_contiguous("wq", wq, 16)
    a = _vector("a_scale", a_scale, m, dev)
    s = _vector("w_scale", w_scale, n, dev)
    bb = _vector("bias", bias, n, dev)
    res_code = 0
    if residual is not None:
        if residual.dtype not in _DTYPE_CODE:
            raise TypeError(f"the kernel reads a float32 or bfloat16 "
                            f"residual, got {residual.dtype}")
        if residual.device != dev:
            raise ValueError(f"residual must be on {dev}")
        _check_contiguous("residual", residual, 16)
        res_code = _DTYPE_CODE[residual.dtype]
    out = torch.empty(m, n, dtype=out_dtype, device=dev)

    from keep_tpu_torch.kernels._build import library

    _raise_on(library().keep_int8_gemm(
        xq.data_ptr(), a.data_ptr(), wq.data_ptr(), s.data_ptr(),
        bb.data_ptr(), None if residual is None else residual.data_ptr(),
        res_code, out.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k, order,
        int(gelu), _stream(xq)), "int8_gemm")
    count("int8_gemm")
    return out


def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """fp32 x [M, D] → LayerNorm (``g``/``b`` [D]) → ``out_dtype``. A CUDA
    tensor goes through the kernel (contiguous and 16-byte aligned, D a
    multiple of 16 and at most 4096); a CPU tensor through the plain
    version."""
    if x.dim() != 2:
        raise ValueError(f"ln_rows takes [M, D], got {tuple(x.shape)}")
    if not _device_path(x):
        return ln_rows_reference(x, g, b, eps, out_dtype)
    m, d = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 rows, got {x.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")
    _check_row_width(d)
    _check_contiguous("x", x, 16)
    gg = _row_vector("g", g, d, x.device)
    bb = _row_vector("b", b, d, x.device)
    out = torch.empty(m, d, dtype=out_dtype, device=x.device)

    from keep_tpu_torch.kernels._build import library

    _raise_on(library().keep_ln_rows(
        x.data_ptr(), gg.data_ptr(), bb.data_ptr(), eps, out.data_ptr(),
        _DTYPE_CODE[out_dtype], m, d, _stream(x)), "ln_rows")
    count("ln_rows")
    return out


class Ops(NamedTuple):
    """The four steps the int8 counterparts of the TPU kernels are made of.
    ``KERNELS`` holds the wrappers (the kernels on a CUDA tensor); ``PLAIN``
    the plain versions."""

    quant_rows: Callable
    int8_gemm: Callable
    ln_rows: Callable
    attention: Callable


KERNELS = Ops(quant_rows, int8_gemm, ln_rows, attention_qkv_slab)
PLAIN = Ops(quant_rows_reference, int8_gemm_reference, ln_rows_reference,
            attention_qkv_slab_reference)


def ops_for(x: torch.Tensor) -> Ops:
    """The steps for ``x``'s device: the kernels on a CUDA tensor, the plain
    versions on a CPU tensor; raises on any other device."""
    return KERNELS if _device_path(x) else PLAIN
