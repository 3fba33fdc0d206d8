"""A plain CPU model of the card's bf16 attention body (#1's tensor-core
body for Dh = 64 and S <= 512, ``slab_attention_tc_kernel`` in
``keep_tpu_torch/kernels/csrc/attention_qkv_slab.cu``), in the order the
card takes its sums and roundings. It imports neither JAX nor the JAX
package, so that a script on the card can hold the kernel against it.

The body, per (batch row, head, query row):

- s = q·kᵀ as four 16-wide partial products (its ``mma.sync`` k16 steps)
  added in fp32, times Dh^-0.5, plus the key bias; keys past S score -inf;
- pass 1 over 64-key tiles: the running row max m (the tile's max taken
  over the row's four threads), each thread's running sum l_t of
  exp(s − m) over its 16 keys of a tile (columns 8n + 2t + {0, 1}), in
  key order, rescaled by exp(m_old − m_new) as m rises; l = (l_0 + l_1) +
  (l_2 + l_3) (the quad's butterfly);
- pass 2: p = exp(s − m)·(1 / l) (``divide=True``: exp(s − m) / l, the
  JAX body's form), rounded to bf16;
- o = p·v as partial products over 16 keys at a time added in fp32,
  rounded to bf16.

Within a 16-wide step the sum is PyTorch's, where the tensor cores take
their own, and ``torch.exp`` stands for ``expf``: the model predicts the
card's order of operations, not its bits.
"""

from __future__ import annotations

import torch

TILE = 64  # keys per tile of the body's two passes


def card_body_attention(qkv: torch.Tensor,
                        key_bias: torch.Tensor | None = None, *,
                        num_heads: int, divide: bool = False
                        ) -> torch.Tensor:
    """qkv [B, S, 3·H·64] (bf16 values) and an fp32 key bias [B, S] → the
    body's output [B, S, H·64] in bf16, computed on qkv's device."""
    b, s, width = qkv.shape
    dh = width // (3 * num_heads)
    if dh != 64:
        raise ValueError(f"the modelled body takes Dh = 64, got {dh}")
    q, k, v = (t.float() for t in qkv.bfloat16().reshape(
        b, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4))
    sc = q[..., :16] @ k[..., :16].transpose(-1, -2)
    for c in range(16, dh, 16):
        sc = sc + q[..., c:c + 16] @ k[..., c:c + 16].transpose(-1, -2)
    sc = sc * torch.tensor(dh ** -0.5, dtype=torch.float32)
    if key_bias is not None:
        sc = sc + key_bias.float()[:, None, None, :]
    sp = -(-s // TILE) * TILE
    sc = torch.nn.functional.pad(sc, (0, sp - s), value=float("-inf"))

    # pass 1: the running max and the four threads' running sums
    m = torch.full(sc.shape[:-1], float("-inf"), device=sc.device)
    lt = torch.zeros(sc.shape[:-1] + (4,), device=sc.device)
    for kb in range(0, sp, TILE):
        m_new = torch.maximum(m, sc[..., kb:kb + TILE].amax(-1))
        lt = lt * torch.exp(m - m_new)[..., None]
        m = m_new
        for n in range(8):
            for j in range(2):
                cols = [kb + 8 * n + 2 * t + j for t in range(4)]
                lt = lt + torch.exp(sc[..., cols] - m[..., None])
    l = (lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3])

    # pass 2: p normalised, then rounded to bf16; p·v in 16-key steps
    e = torch.exp(sc - m[..., None])
    p = e / l[..., None] if divide else e * (1.0 / l)[..., None]
    p = p.bfloat16().float()[..., :s]
    o = p[..., :16] @ v[..., :16, :]
    for c in range(16, s, 16):
        o = o + p[..., c:c + 16] @ v[..., c:c + 16, :]
    return o.transpose(1, 2).reshape(b, s, num_heads * dh).bfloat16()
