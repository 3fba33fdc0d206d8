"""Fused multi-head attention over the unsplit qkv slab, and its backward;
the same attention over split q, k and v.

Counterpart of ``keep_tpu/kernels/flash_attention.py``:
``attention_qkv_slab`` (the Pallas kernel at :132-206, under the
``jax.custom_vjp`` of :169-248), ``attention_qkv_heads`` (:80-129) and
``flash_attention`` (:251-281). For a CUDA tensor the wrappers launch the
hand-written Hopper kernels in ``csrc/attention_qkv_slab.cu`` (the forward
of every layout: one kernel body that reads q, k and v through base
pointers and batch, head and row strides) and
``csrc/attention_qkv_slab_bwd.cu`` (the closed-form backward,
``_slab_attn_bwd``); bf16 runs on the tensor cores, fp32 on the CUDA
cores, and the bf16 → fp32 form below on its own tensor-core body
(``csrc/attention_qkv_slab_f32.cu``: ``wgmma`` fed by TMA, one pass with
the scores in registers). For a CPU tensor they run
the ``*_reference`` versions, the same math in plain PyTorch, which the
tests and ``chip_smoke.py`` also hold the kernels against. There is no
fallback from one to the other.

``attention_qkv_slab`` is differentiable with respect to the slab: under
autograd it goes through ``SlabAttention``, whose backward is
``attention_qkv_slab_bwd``. No gradient flows to the key bias (a mask).

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

from keep_tpu_torch.ops.nn import mha_attention

MAX_SEQ = 512  # the kernels keep a whole score row and K/V slice on chip
HEAD_DIM = 64  # the kernels are written for the KEEP towers' head width

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


def _check_kernel_slab(qkv: torch.Tensor, dh: int) -> None:
    """The shape, dtype-independent layout and device checks both kernels
    share."""
    b, s, _ = qkv.shape
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if dh != HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, got {dh}")
    if s > MAX_SEQ:
        raise ValueError(f"the kernel takes S ≤ {MAX_SEQ}, got {s}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned slab")
    if b > 65535:
        raise ValueError(f"the kernel takes B ≤ 65535, got {b}")


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
                    dtype: torch.dtype, out_dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """Launches the forward kernel on q, k, v given as the addresses of
    their (batch 0, head 0, row 0) elements and their common (batch, head,
    row) element strides; returns out [B, S, H·64] in ``out_dtype``."""
    if (dtype, out_dtype) not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 in and "
                        f"float32 or the input's dtype out, got {dtype} "
                        f"→ {out_dtype}")
    if key_bias is not None:
        if key_bias.device != device:
            raise ValueError("key_bias must be on the operands' device")
        key_bias = key_bias.float().contiguous()

    from keep_tpu_torch.kernels._build import library

    out = torch.empty(b, s, h * HEAD_DIM, dtype=out_dtype, device=device)
    rc = library().keep_attention(
        q, k, v, *strides, None if key_bias is None else key_bias.data_ptr(),
        out.data_ptr(), b, s, h, HEAD_DIM, _DTYPE_CODE[dtype, out_dtype],
        HEAD_DIM ** -0.5, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def _forward(qkv: torch.Tensor, key_bias: torch.Tensor | None, num_heads: int,
             out_dtype: torch.dtype) -> torch.Tensor:
    global LAUNCHES
    b, s, three_hd = qkv.shape
    dh = _head_dim(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_slab_reference(qkv, key_bias, num_heads=num_heads,
                                            out_dtype=out_dtype)
    _check_kernel_slab(qkv, dh)
    # q, k and v are the slab's thirds: head h of each at lanes h·Dh
    d, ptr, size = three_hd // 3, qkv.data_ptr(), qkv.element_size()
    out = _launch_forward(
        "attention_qkv_slab", ptr, ptr + d * size, ptr + 2 * d * size,
        (s * three_hd, dh, three_hd), key_bias, b, s, num_heads, qkv.dtype,
        out_dtype, qkv.device)
    with _launch_lock:
        LAUNCHES += 1
    return out


class SlabAttention(torch.autograd.Function):
    """``attention_qkv_slab`` under autograd, the counterpart of the JAX
    package's ``_slab_attn_vjp``: the forward kernel, then the closed-form
    backward from the saved slab and fp32 key bias. The bias gets no
    gradient."""

    @staticmethod
    def forward(ctx, qkv, key_bias, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, key_bias)
        return _forward(qkv, key_bias, num_heads, qkv.dtype)

    @staticmethod
    def backward(ctx, dout):
        qkv, key_bias = ctx.saved_tensors
        dqkv = attention_qkv_slab_bwd(qkv, key_bias, dout.contiguous(),
                                      ctx.num_heads)
        return dqkv, None, None


def attention_qkv_slab(qkv: torch.Tensor, key_bias: torch.Tensor | None = None,
                       *, num_heads: int,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """qkv [B, S, 3·H·Dh], the unsplit qkv-projection output, → [B, S, H·Dh]
    in ``out_dtype`` (default: qkv's dtype).

    ``key_bias``: optional [B, S] additive mask on key positions (0 valid,
    −1e9 masked), taken in fp32. A CUDA tensor goes through the kernel,
    which takes fp32 → fp32, bf16 → bf16 or bf16 → fp32, Dh = 64, S ≤ 512
    and a contiguous slab, and raises on anything else; a CPU tensor goes
    through the plain version. When the slab requires grad, the call is
    differentiable (``SlabAttention``; a ``None`` bias becomes zeros, as in
    the JAX package), except for the fp32-output form, which raises."""
    b, s, _ = qkv.shape
    _head_dim(qkv, num_heads)
    if key_bias is not None and tuple(key_bias.shape) != (b, s):
        raise ValueError(f"key_bias must be [B, S] = {(b, s)}, got "
                         f"{tuple(key_bias.shape)}")
    out_dtype = qkv.dtype if out_dtype is None else out_dtype
    if not (qkv.requires_grad and torch.is_grad_enabled()):
        return _forward(qkv, key_bias, num_heads, out_dtype)
    if out_dtype != qkv.dtype:
        raise NotImplementedError(
            "the fp32-output form of attention_qkv_slab (a bf16 slab with "
            "out_dtype=float32, the int8 blocks' attention) is inference-"
            "only; run it under torch.no_grad() / torch.inference_mode()")
    if key_bias is None:
        key_bias = torch.zeros(b, s, dtype=torch.float32, device=qkv.device)
    return SlabAttention.apply(qkv, key_bias.detach().float(), num_heads)


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


def attention_qkv_slab_bwd(qkv: torch.Tensor, key_bias: torch.Tensor,
                           dout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The gradient of ``attention_qkv_slab`` with respect to the slab:
    qkv [B, S, 3·H·Dh], fp32 key bias [B, S], dout [B, S, H·Dh] →
    dqkv [B, S, 3·H·Dh] in the slab's dtype. A CUDA tensor goes through the
    backward kernel, which takes fp32 or bf16 (dout in the slab's dtype),
    Dh = 64, S ≤ 512 and contiguous tensors, and raises on anything else; a
    CPU tensor goes through the plain version."""
    global BWD_LAUNCHES
    b, s, _ = qkv.shape
    dh = _head_dim(qkv, num_heads)
    if tuple(key_bias.shape) != (b, s):
        raise ValueError(f"key_bias must be [B, S] = {(b, s)}, got "
                         f"{tuple(key_bias.shape)}")
    if tuple(dout.shape) != (b, s, num_heads * dh):
        raise ValueError(f"dout must be [B, S, H·Dh] = "
                         f"{(b, s, num_heads * dh)}, got {tuple(dout.shape)}")
    if qkv.device.type == "cpu":
        return attention_qkv_slab_bwd_reference(qkv, key_bias, dout, num_heads)
    _check_kernel_slab(qkv, dh)
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


def _heads_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  strides: tuple[int, int, int],
                  key_bias: torch.Tensor | None, b: int, s: int,
                  h: int) -> torch.Tensor:
    """The split-heads launch: q, k, v of one dtype on one CUDA device,
    sharing the (batch, head, row) element strides; counted in
    ``HEADS_LAUNCHES``."""
    global HEADS_LAUNCHES
    if k.dtype != q.dtype or v.dtype != q.dtype or \
            q.dtype not in _IO_DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    out = _launch_forward("attention_qkv_heads", q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), strides, key_bias, b, s, h, q.dtype,
                          q.dtype, q.device)
    with _launch_lock:
        HEADS_LAUNCHES += 1
    return out


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
    b, s, hd = q.shape
    heads = lambda t: t.reshape(b, s, num_heads, dh).transpose(1, 2)  # noqa: E731
    bias = None if key_bias is None else key_bias.float()[:, None, None, :]
    out = mha_attention(heads(q), heads(k), heads(v), bias=bias,
                        out_dtype=q.dtype)
    return out.transpose(1, 2).reshape(b, s, hd)


def attention_qkv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_bias: torch.Tensor | None = None, *,
                        num_heads: int, group: int = 8) -> torch.Tensor:
    """q, k, v [B, S, H·Dh] (head h in lanes [h·Dh, (h+1)·Dh)) → [B, S, H·Dh]
    in q's dtype. ``key_bias``: optional [B, S] additive mask on key
    positions (0 valid, −1e9 masked), taken in fp32.

    ``group`` (heads per TPU program) halves until it divides H, as on the
    TPU, and does not change the result: the kernel runs one block per
    (query tile, head). A CUDA tensor goes through the kernel, which takes
    fp32 or bf16 q, k, v of one dtype, Dh = 64, S ≤ 512 and contiguous,
    16-byte aligned operands, and raises on anything else; a CPU tensor goes
    through the plain version. Inference-only: raises under autograd."""
    dh = _heads_check(q, k, v, key_bias, num_heads)
    while num_heads % group:
        group //= 2
    if q.device.type == "cpu":
        return attention_qkv_heads_reference(q, k, v, key_bias,
                                             num_heads=num_heads, group=group)
    b, s, hd = q.shape
    for t in (q, k, v):
        _check_kernel_slab(t, dh)
    return _heads_kernel(q, k, v, (s * hd, dh, hd), key_bias, b, s, num_heads)


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
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, group)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be one [B, H, S, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _inference_only(q, k, v)
    b, h, s, dh = q.shape
    key_bias = _key_bias(bias, b, s)
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
            and all(st % 8 == 0 for st in q.stride()[:3])):
        q, k, v = (t.contiguous() for t in (q, k, v))
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("the kernel takes 16-byte aligned q, k, v")
    if dh != HEAD_DIM or s > MAX_SEQ or b > 65535:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, S ≤ "
                         f"{MAX_SEQ} and B ≤ 65535, got {tuple(q.shape)}")
    out = _heads_kernel(q, k, v, q.stride()[:3], key_bias, b, s, h)
    return out.view(b, s, h, dh).transpose(1, 2)
