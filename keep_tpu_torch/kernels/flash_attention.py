"""Fused multi-head attention over the unsplit qkv slab, and its backward;
the same attention over split q, k and v.

Counterpart of ``keep_tpu/kernels/flash_attention.py``:
``attention_qkv_slab`` (the Pallas kernel at :132-206, under the
``jax.custom_vjp`` of :169-248), ``attention_qkv_heads`` (:80-129) and
``flash_attention`` (:251-281). For a CUDA tensor the wrappers launch the
hand-written Hopper kernels behind the C entry point ``keep_attention``
(``csrc/attention_qkv_slab.cu``: every layout goes to the same bodies,
which read q, k and v through base pointers and batch, head and row
strides) and ``csrc/attention_qkv_slab_bwd.cu`` (the closed-form backward,
``_slab_attn_bwd``). bf16 in, bf16 or fp32 out, runs on ``wgmma`` fed by
TMA (``csrc/attention_qkv_slab_wgmma.cu``: one pass with the scores in
registers at Dh = 64 and S ≤ 320, K and V streamed through a ring of
shared-memory stages elsewhere); so does the bf16 backward, two
deterministic kernels at every shape (``csrc/attention_qkv_slab_bwd_dq.cu``:
the row statistics and dq per query tile, K and V streamed twice;
``_dkv.cu``: dk and dv per key tile, Q and dO streamed); fp32 on the CUDA
cores. For a CPU tensor
they run the ``*_reference`` versions, the same math in plain PyTorch, which the
tests and ``chip_smoke.py`` also hold the kernels against. There is no
fallback from one to the other. The choice is the dispatcher's: the C
entry point ``keep_attention`` is two ``keep::`` operators
(``attention_qkv_slab`` on the slab, ``attention_qkv_heads`` on [B, H, S,
Dh] views, each with its launch count), and ``keep_attention_qkv_slab_bwd``
a third (``_library``).

``attention_qkv_slab`` is differentiable with respect to the slab: the
operator's autograd formula is ``attention_qkv_slab_bwd``. No gradient
flows to the key bias (a mask).

``out_dtype=torch.float32`` on a bf16 slab gives the fp32 sum uncast: the
attention inside the int8 megakernels (``keep_tpu/kernels/qblock.py``
``_sdpa`` and ``_sdpa_masked``), whose fp32 scratch is quantized without a
bf16 round. The tensor cores sum its products in their own order, so it is
held to the plain version within the bf16 gate, not bit for bit. That
form is inference-only and raises under autograd.

``attention_qkv_heads`` (q, k, v [B, S, H·Dh]) and ``flash_attention`` (the
[B, H, S, Dh] API that ``ops.nn.mha_attention(use_flash=True)`` calls) are
inference-only, as in the JAX package, whose kernel has no VJP: they raise
under autograd.
"""

from __future__ import annotations

import threading

import torch

from keep_tpu_torch.kernels._library import LIB, define
from keep_tpu_torch.ops.nn import mha_attention

# What every CUDA body takes (the forward in each dtype pair, the backward):
# every head width in HEAD_DIMS (the OpenCLIP zoo's 64, 80, 88, 104 and 112
# among them) at any S; the wrappers raise on any other head width.
HEAD_DIMS = tuple(range(64, 129, 8))

# Counts of kernel launches in this process (slab forward, slab backward,
# split-heads forward); a run resets them to check that its main path went
# through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0
HEADS_LAUNCHES = 0
_launch_lock = threading.Lock()

# (input dtype, output dtype) → the forward kernel's dtype code
_DTYPE_CODE = {(torch.float32, torch.float32): 0,
               (torch.bfloat16, torch.bfloat16): 1,
               (torch.bfloat16, torch.float32): 2}
# one dtype in and out → the dtype code of the backward kernel (slab, dout
# and dqkv share it) and of the split-heads forward (q, k, v and out)
_IO_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    three_hd = qkv.shape[-1]
    if three_hd % (3 * num_heads):
        raise ValueError(
            f"slab lane dim {three_hd} is not divisible by "
            f"3·num_heads={3 * num_heads}")
    return three_hd // (3 * num_heads)


def _split(qkv: torch.Tensor, num_heads: int):
    """[B, S, 3·H·Dh] → q, k, v as [B, H, S, Dh] views, and Dh."""
    b, s, _ = qkv.shape
    dh = _head_dim(qkv, num_heads)
    q, k, v = qkv.reshape(b, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    return q, k, v, dh


def _check_device(x: torch.Tensor) -> None:
    """The operators have a CUDA and a CPU implementation; any other device
    raises (a traced program's fake tensors carry the device they stand
    for)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {x.device}")


def _check_kernel_slab(qkv: torch.Tensor) -> None:
    """The layout and device checks every kernel shares."""
    b = qkv.shape[0]
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned slab")
    if b > 65535:
        raise ValueError(f"the kernel takes B ≤ 65535, got {b}")


def _check_shape(dh: int) -> None:
    """The head width every body takes: every Dh in ``HEAD_DIMS``, at any
    S."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 from "
                         f"{HEAD_DIMS[0]} to {HEAD_DIMS[-1]}, got {dh}")


def attention_qkv_slab_reference(qkv: torch.Tensor,
                                 key_bias: torch.Tensor | None = None, *,
                                 num_heads: int,
                                 out_dtype: torch.dtype | None = None
                                 ) -> torch.Tensor:
    """The kernel's math in plain PyTorch: qkv [B, S, 3·H·Dh] (+ fp32 key
    bias [B, S]) → [B, S, H·Dh] in ``out_dtype`` (default: qkv's)."""
    b, s, _ = qkv.shape
    q, k, v, dh = _split(qkv, num_heads)
    bias = None if key_bias is None else key_bias.float()[:, None, None, :]
    out = mha_attention(q, k, v, bias=bias, out_dtype=out_dtype)
    return out.transpose(1, 2).reshape(b, s, num_heads * dh)  # [B, H, S, Dh]


def _launch_forward(name: str, q: int, k: int, v: int,
                    strides: tuple[int, int, int],
                    key_bias: torch.Tensor | None, b: int, s: int, h: int,
                    dh: int, dtype: torch.dtype, out_dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """Launches the forward kernel on q, k, v given as the addresses of
    their (batch 0, head 0, row 0) elements and their common (batch, head,
    row) element strides; returns out [B, S, H·Dh] in ``out_dtype``."""
    if (dtype, out_dtype) not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 in and "
                        f"float32 or the input's dtype out, got {dtype} "
                        f"→ {out_dtype}")
    _check_shape(dh)
    if key_bias is not None:
        if key_bias.device != device:
            raise ValueError("key_bias must be on the operands' device")
        key_bias = key_bias.float().contiguous()

    from keep_tpu_torch.kernels._build import library

    out = torch.empty(b, s, h * dh, dtype=out_dtype, device=device)
    rc = library().keep_attention(
        q, k, v, *strides, None if key_bias is None else key_bias.data_ptr(),
        out.data_ptr(), b, s, h, dh, _DTYPE_CODE[dtype, out_dtype],
        dh ** -0.5, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def _slab_cuda(qkv: torch.Tensor, key_bias: torch.Tensor | None,
               num_heads: int, out_dtype: torch.dtype) -> torch.Tensor:
    """``keep::attention_qkv_slab`` on the card: the launch, counted in
    ``LAUNCHES``."""
    global LAUNCHES
    b, s, three_hd = qkv.shape
    dh = _head_dim(qkv, num_heads)
    _check_kernel_slab(qkv)
    # q, k and v are the slab's thirds: head h of each at lanes h·Dh
    d, ptr, size = three_hd // 3, qkv.data_ptr(), qkv.element_size()
    out = _launch_forward(
        "attention_qkv_slab", ptr, ptr + d * size, ptr + 2 * d * size,
        (s * three_hd, dh, three_hd), key_bias, b, s, num_heads, dh,
        qkv.dtype, out_dtype, qkv.device)
    with _launch_lock:
        LAUNCHES += 1
    return out


def _slab_cpu(qkv, key_bias, num_heads, out_dtype):
    return attention_qkv_slab_reference(qkv, key_bias, num_heads=num_heads,
                                        out_dtype=out_dtype)


def _slab_fake(qkv, key_bias, num_heads, out_dtype):
    b, s, _ = qkv.shape
    return qkv.new_empty((b, s, num_heads * _head_dim(qkv, num_heads)),
                         dtype=out_dtype)


define("attention_qkv_slab(Tensor qkv, Tensor? key_bias, int num_heads, "
       "ScalarType out_dtype) -> Tensor", _slab_cuda, _slab_cpu, _slab_fake)


def _slab_setup(ctx, inputs, output) -> None:
    qkv, key_bias, num_heads, out_dtype = inputs
    if out_dtype != qkv.dtype:
        raise NotImplementedError(
            "the fp32-output form of attention_qkv_slab (a bf16 slab with "
            "out_dtype=float32, the int8 blocks' attention) is inference-"
            "only; run it under torch.no_grad() / torch.inference_mode()")
    ctx.num_heads = num_heads
    ctx.save_for_backward(qkv, key_bias)


def _slab_backward(ctx, dout):
    """The counterpart of the JAX package's ``_slab_attn_vjp``: the
    closed-form backward from the saved slab and fp32 key bias. The bias
    gets no gradient."""
    qkv, key_bias = ctx.saved_tensors
    if key_bias is None:
        b, s, _ = qkv.shape
        key_bias = torch.zeros(b, s, dtype=torch.float32, device=qkv.device)
    dqkv = torch.ops.keep.attention_qkv_slab_bwd(
        qkv, key_bias, dout.contiguous(), ctx.num_heads)
    return dqkv, None, None, None


torch.library.register_autograd("keep::attention_qkv_slab", _slab_backward,
                                setup_context=_slab_setup, lib=LIB)


def attention_qkv_slab(qkv: torch.Tensor, key_bias: torch.Tensor | None = None,
                       *, num_heads: int,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """qkv [B, S, 3·H·Dh], the unsplit qkv-projection output, → [B, S, H·Dh]
    in ``out_dtype`` (default: qkv's dtype); ``keep::attention_qkv_slab``.

    ``key_bias``: optional [B, S] additive mask on key positions (0 valid,
    −1e9 masked), taken in fp32. A CUDA tensor goes through the kernel,
    which takes a contiguous slab, fp32 → fp32, bf16 → bf16 or bf16 → fp32
    at every Dh in ``HEAD_DIMS`` and any S, and raises on anything else; a CPU tensor goes through the plain version.
    When the slab requires grad, the call is differentiable (the operator's
    backward is ``attention_qkv_slab_bwd``; a ``None`` bias becomes zeros,
    as in the JAX package), except for the fp32-output form, which
    raises."""
    b, s, _ = qkv.shape
    _head_dim(qkv, num_heads)
    if key_bias is not None and tuple(key_bias.shape) != (b, s):
        raise ValueError(f"key_bias must be [B, S] = {(b, s)}, got "
                         f"{tuple(key_bias.shape)}")
    _check_device(qkv)
    out_dtype = qkv.dtype if out_dtype is None else out_dtype
    if qkv.requires_grad and torch.is_grad_enabled():
        if key_bias is None:
            key_bias = torch.zeros(b, s, dtype=torch.float32,
                                   device=qkv.device)
        key_bias = key_bias.detach().float()
    return torch.ops.keep.attention_qkv_slab(qkv, key_bias, num_heads,
                                             out_dtype)


def attention_qkv_slab_bwd_reference(qkv: torch.Tensor,
                                     key_bias: torch.Tensor,
                                     dout: torch.Tensor,
                                     num_heads: int) -> torch.Tensor:
    """The backward kernel's math in plain PyTorch, as the JAX package's
    ``_slab_attn_bwd``: p recomputed and kept in fp32; dv = pᵀ·do;
    ds = p∘(dp − rowsum(dp∘p)) with dp = do·vᵀ; dq = ds·k·scale;
    dk = dsᵀ·q·scale; all in fp32, cast once to the slab dtype, in the slab
    layout [B, S, 3·H·Dh]."""
    b, s, three_hd = qkv.shape
    q, k, v, dh = _split(qkv, num_heads)
    scale = dh ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    do = dout.reshape(b, s, num_heads, dh).transpose(1, 2).float()
    sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    sc = sc + key_bias.float()[:, None, None, :]
    p = torch.softmax(sc, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dqkv = torch.stack([dq, dk, dv], dim=0)  # [3, B, H, S, Dh]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, s, three_hd).to(qkv.dtype)


def _bwd_cuda(qkv: torch.Tensor, key_bias: torch.Tensor, dout: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """``keep::attention_qkv_slab_bwd`` on the card: the launch, counted in
    ``BWD_LAUNCHES``."""
    global BWD_LAUNCHES
    b, s, _ = qkv.shape
    dh = _head_dim(qkv, num_heads)
    _check_kernel_slab(qkv)
    _check_shape(dh)
    if qkv.dtype not in _IO_DTYPE_CODE or dout.dtype != qkv.dtype:
        raise TypeError(f"the backward kernel takes float32 or bfloat16 slabs "
                        f"with dout in the slab's dtype, got {qkv.dtype} and "
                        f"{dout.dtype}")
    if key_bias.device != qkv.device or dout.device != qkv.device:
        raise ValueError("key_bias and dout must be on the slab's device")
    if not dout.is_contiguous() or dout.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned dout")
    key_bias = key_bias.float().contiguous()

    from keep_tpu_torch.kernels._build import library

    dqkv = torch.empty_like(qkv)
    stats = torch.empty(b, num_heads, s, 4, dtype=torch.float32,
                        device=qkv.device)
    rc = library().keep_attention_qkv_slab_bwd(
        qkv.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
        stats.data_ptr(), b, s, num_heads, dh, _IO_DTYPE_CODE[qkv.dtype],
        dh ** -0.5, torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_qkv_slab_bwd kernel launch failed: "
                           f"cudaError {rc}")
    with _launch_lock:
        BWD_LAUNCHES += 1
    return dqkv


def _bwd_cpu(qkv, key_bias, dout, num_heads):
    return attention_qkv_slab_bwd_reference(qkv, key_bias, dout, num_heads)


define("attention_qkv_slab_bwd(Tensor qkv, Tensor key_bias, Tensor dout, "
       "int num_heads) -> Tensor", _bwd_cuda, _bwd_cpu,
       lambda qkv, key_bias, dout, num_heads: torch.empty_like(qkv))


def attention_qkv_slab_bwd(qkv: torch.Tensor, key_bias: torch.Tensor,
                           dout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The gradient of ``attention_qkv_slab`` with respect to the slab:
    qkv [B, S, 3·H·Dh], fp32 key bias [B, S], dout [B, S, H·Dh] →
    dqkv [B, S, 3·H·Dh] in the slab's dtype; ``keep::attention_qkv_slab_bwd``.
    A CUDA tensor goes through the backward kernel, which takes fp32 or
    bf16 (dout in the slab's dtype), every Dh in ``HEAD_DIMS`` at any S and
    contiguous tensors, and raises on anything else; a CPU tensor goes
    through the plain version."""
    b, s, _ = qkv.shape
    dh = _head_dim(qkv, num_heads)
    if tuple(key_bias.shape) != (b, s):
        raise ValueError(f"key_bias must be [B, S] = {(b, s)}, got "
                         f"{tuple(key_bias.shape)}")
    if tuple(dout.shape) != (b, s, num_heads * dh):
        raise ValueError(f"dout must be [B, S, H·Dh] = "
                         f"{(b, s, num_heads * dh)}, got {tuple(dout.shape)}")
    _check_device(qkv)
    return torch.ops.keep.attention_qkv_slab_bwd(qkv, key_bias, dout,
                                                 num_heads)


# ---- split q, k, v: attention_qkv_heads and flash_attention ------------------


def _inference_only(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "attention_qkv_heads / flash_attention are inference-only (the "
            "JAX kernel has no VJP); run them under torch.no_grad() / "
            "torch.inference_mode(), or train through attention_qkv_slab")


def _heads_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_bias: torch.Tensor | None, num_heads: int) -> int:
    """The checks of the JAX ``attention_qkv_heads``; returns Dh."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be one [B, S, H·Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"lane dim {hd} is not divisible by "
                         f"num_heads={num_heads}")
    if key_bias is not None and tuple(key_bias.shape) != (b, s):
        raise ValueError(f"key_bias must be [B, S] = {(b, s)}, got "
                         f"{tuple(key_bias.shape)}")
    _inference_only(q, k, v)
    return hd // num_heads


def _heads_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_bias: torch.Tensor | None, num_heads: int) -> torch.Tensor:
    """``keep::attention_qkv_heads`` on the card: q, k, v [B, H, S, Dh] of
    one dtype on one CUDA device, sharing one layout with contiguous rows
    (the kernel reads them through their (batch, head, row) strides);
    counted in ``HEADS_LAUNCHES``."""
    global HEADS_LAUNCHES
    if k.dtype != q.dtype or v.dtype != q.dtype or \
            q.dtype not in _IO_DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    b, h, s, dh = q.shape
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
            and all(st % 8 == 0 for st in q.stride()[:3])):
        raise ValueError("the kernel takes contiguous rows of q, k, v in one "
                         "layout")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("the kernel takes 16-byte aligned q, k, v")
    if b > 65535:
        raise ValueError(f"the kernel takes B ≤ 65535, got {tuple(q.shape)}")
    out = _launch_forward("attention_qkv_heads", q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), q.stride()[:3], key_bias, b, s, h, dh,
                          q.dtype, q.dtype, q.device)
    with _launch_lock:
        HEADS_LAUNCHES += 1
    return out


def _heads_plain(q, k, v, key_bias, num_heads):
    """The kernel's math on [B, H, S, Dh] views: ``mha_attention``'s plain
    path → [B, S, H·Dh] in q's dtype."""
    b, h, s, dh = q.shape
    bias = None if key_bias is None else key_bias.float()[:, None, None, :]
    out = mha_attention(q, k, v, bias=bias, out_dtype=q.dtype)
    return out.transpose(1, 2).reshape(b, s, h * dh)


define("attention_qkv_heads(Tensor q, Tensor k, Tensor v, Tensor? key_bias, "
       "int num_heads) -> Tensor", _heads_cuda, _heads_plain,
       lambda q, k, v, key_bias, num_heads: q.new_empty(
           (q.shape[0], q.shape[2], q.shape[1] * q.shape[3])))


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H·Dh] → [B, H, S, Dh] (a view of a contiguous tensor)."""
    b, s, hd = t.shape
    return t.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def attention_qkv_heads_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  key_bias: torch.Tensor | None = None, *,
                                  num_heads: int, group: int = 8
                                  ) -> torch.Tensor:
    """The kernel's math in plain PyTorch: ``mha_attention``'s plain path on
    the [B, H, S, Dh] views of q, k, v [B, S, H·Dh] (+ fp32 key bias
    [B, S]) → [B, S, H·Dh] in q's dtype. ``group`` does not change the
    result."""
    dh = _heads_check(q, k, v, key_bias, num_heads)
    b, s, _ = q.shape
    return _heads_plain(*(t.reshape(b, s, num_heads, dh).transpose(1, 2)
                          for t in (q, k, v)), key_bias, num_heads)


def attention_qkv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_bias: torch.Tensor | None = None, *,
                        num_heads: int, group: int = 8) -> torch.Tensor:
    """q, k, v [B, S, H·Dh] (head h in lanes [h·Dh, (h+1)·Dh)) → [B, S, H·Dh]
    in q's dtype. ``key_bias``: optional [B, S] additive mask on key
    positions (0 valid, −1e9 masked), taken in fp32.

    ``group`` (heads per TPU program) halves until it divides H, as on the
    TPU, and does not change the result: the kernel runs one block per
    (query tile, head). A CUDA tensor goes through the kernel, which takes
    fp32 or bf16 q, k, v of one dtype, every Dh in ``HEAD_DIMS``, any S and
    contiguous, 16-byte aligned operands, and raises on anything else; a CPU
    tensor goes through the plain version. Inference-only: raises under
    autograd."""
    _heads_check(q, k, v, key_bias, num_heads)
    while num_heads % group:
        group //= 2
    _check_device(q)
    if q.device.type == "cuda" and not all(t.is_contiguous()
                                           for t in (q, k, v)):
        raise ValueError("the kernel takes contiguous q, k, v")
    return torch.ops.keep.attention_qkv_heads(
        *(_heads(t, num_heads) for t in (q, k, v)), key_bias, num_heads)


def _key_bias(bias: torch.Tensor | None, b: int, s: int
              ) -> torch.Tensor | None:
    """A [B, 1, 1, S] key mask as [B, S]; raises on any other bias, as the
    JAX ``flash_attention`` does."""
    if bias is not None and (bias.dim() != 4 or bias.shape[1] != 1
                             or bias.shape[2] != 1):
        raise ValueError(
            f"flash_attention supports only [B, 1, 1, S] key-mask biases, got "
            f"{tuple(bias.shape)}; use mha_attention(use_flash=False) for "
            f"full score-level biases")
    return None if bias is None else bias.reshape(b, s)


def _to_lanes(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: torch.Tensor | None = None,
                              group: int = 8) -> torch.Tensor:
    """The plain version of ``flash_attention``."""
    b, h, s, dh = q.shape
    out = attention_qkv_heads_reference(
        _to_lanes(q), _to_lanes(k), _to_lanes(v), _key_bias(bias, b, s),
        num_heads=h, group=group)
    return out.reshape(b, s, h, dh).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    group: int = 8) -> torch.Tensor:
    """The generic [B, H, S, Dh] API over ``attention_qkv_heads``, the
    kernel of ``ops.nn.mha_attention(use_flash=True)``. ``bias`` must be a
    key mask shaped [B, 1, 1, S] (the BERT padding mask) or None; full
    score-level biases raise, as in the JAX package. Returns the
    [B, H, S, Dh] view of a [B, S, H·Dh] tensor, as there. On the card the
    kernel reads q, k and v through their strides, without the layout
    copies of the plain version, when the three share one layout with
    contiguous rows; otherwise it takes contiguous copies. Inference-only."""
    _check_device(q)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be one [B, H, S, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _inference_only(q, k, v)
    b, h, s, dh = q.shape
    key_bias = _key_bias(bias, b, s)
    if q.device.type == "cuda" and not (
            q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
            and all(st % 8 == 0 for st in q.stride()[:3])):
        q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.ops.keep.attention_qkv_heads(q, k, v, key_bias, h)
    return out.view(b, s, h, dh).transpose(1, 2)
