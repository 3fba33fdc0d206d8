"""Fused multi-head attention over the unsplit qkv slab.

Counterpart of ``keep_tpu/kernels/flash_attention.py`` ``attention_qkv_slab``
(the Pallas kernel at :132-206). For a CUDA tensor the wrapper launches the
hand-written Hopper kernel in ``csrc/attention_qkv_slab.cu``; for a CPU
tensor it runs ``attention_qkv_slab_reference``, the same math in plain
PyTorch, which the tests and ``chip_smoke.py`` also hold the kernel against.
There is no fallback from one to the other.

``out_dtype=torch.float32`` on a bf16 slab gives the fp32 sum uncast: the
attention inside the int8 megakernels (``keep_tpu/kernels/qblock.py``
``_sdpa`` and ``_sdpa_masked``), whose fp32 scratch is quantized without a
bf16 round.

Forward only: the closed-form backward (``_slab_attn_bwd``) comes with
training.
"""

from __future__ import annotations

import threading

import torch

from keep_tpu_torch.ops.nn import mha_attention

MAX_SEQ = 512  # the kernel keeps a whole score row and K/V slice on chip
HEAD_DIM = 64  # the kernel is written for the KEEP towers' head width

# Count of kernel launches in this process; a run resets it to check that
# its main path went through the kernel.
LAUNCHES = 0
_launch_lock = threading.Lock()

# (input dtype, output dtype) → the kernel's dtype code
_DTYPE_CODE = {(torch.float32, torch.float32): 0,
               (torch.bfloat16, torch.bfloat16): 1,
               (torch.bfloat16, torch.float32): 2}


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    three_hd = qkv.shape[-1]
    if three_hd % (3 * num_heads):
        raise ValueError(
            f"slab lane dim {three_hd} is not divisible by "
            f"3·num_heads={3 * num_heads}")
    return three_hd // (3 * num_heads)


def attention_qkv_slab_reference(qkv: torch.Tensor,
                                 key_bias: torch.Tensor | None = None, *,
                                 num_heads: int,
                                 out_dtype: torch.dtype | None = None
                                 ) -> torch.Tensor:
    """The kernel's math in plain PyTorch: qkv [B, S, 3·H·Dh] (+ fp32 key
    bias [B, S]) → [B, S, H·Dh] in ``out_dtype`` (default: qkv's)."""
    b, s, _ = qkv.shape
    h = num_heads
    dh = _head_dim(qkv, h)
    q, k, v = qkv.reshape(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
    bias = None if key_bias is None else key_bias.float()[:, None, None, :]
    out = mha_attention(q, k, v, bias=bias, out_dtype=out_dtype)
    return out.transpose(1, 2).reshape(b, s, h * dh)  # from [B, H, S, Dh]


def attention_qkv_slab(qkv: torch.Tensor, key_bias: torch.Tensor | None = None,
                       *, num_heads: int,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """qkv [B, S, 3·H·Dh], the unsplit qkv-projection output, → [B, S, H·Dh]
    in ``out_dtype`` (default: qkv's dtype).

    ``key_bias``: optional [B, S] additive mask on key positions (0 valid,
    −1e9 masked), taken in fp32. A CUDA tensor goes through the kernel,
    which takes fp32 → fp32, bf16 → bf16 or bf16 → fp32, Dh = 64, S ≤ 512
    and a contiguous slab, and raises on anything else; a CPU tensor goes
    through the plain version."""
    global LAUNCHES
    b, s, _ = qkv.shape
    dh = _head_dim(qkv, num_heads)
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "attention_qkv_slab is forward-only in the PyTorch port; run it "
            "under torch.no_grad() / torch.inference_mode()")
    if key_bias is not None and tuple(key_bias.shape) != (b, s):
        raise ValueError(f"key_bias must be [B, S] = {(b, s)}, got "
                         f"{tuple(key_bias.shape)}")
    out_dtype = qkv.dtype if out_dtype is None else out_dtype
    if qkv.device.type == "cpu":
        return attention_qkv_slab_reference(qkv, key_bias, num_heads=num_heads,
                                            out_dtype=out_dtype)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if dh != HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, got {dh}")
    if s > MAX_SEQ:
        raise ValueError(f"the kernel takes S ≤ {MAX_SEQ}, got {s}")
    if (qkv.dtype, out_dtype) not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 in and "
                        f"float32 or the input's dtype out, got {qkv.dtype} "
                        f"→ {out_dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned slab")
    if b > 65535:
        raise ValueError(f"the kernel takes B ≤ 65535, got {b}")
    if key_bias is not None:
        if key_bias.device != qkv.device:
            raise ValueError("key_bias must be on the slab's device")
        key_bias = key_bias.float().contiguous()

    from keep_tpu_torch.kernels._build import library

    out = torch.empty(b, s, num_heads * dh, dtype=out_dtype, device=qkv.device)
    rc = library().keep_attention_qkv_slab(
        qkv.data_ptr(), None if key_bias is None else key_bias.data_ptr(),
        out.data_ptr(), b, s, num_heads, dh, _DTYPE_CODE[qkv.dtype, out_dtype],
        dh ** -0.5, torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_qkv_slab kernel launch failed: "
                           f"cudaError {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return out
