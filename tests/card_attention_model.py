"""A plain CPU model of the card's bf16 attention forward (#1 / #2's
``wgmma`` bodies in ``keep_tpu_torch/kernels/csrc/attention_qkv_slab_wgmma.cu``,
bf16 or fp32 out), in the order the card takes its sums and roundings. It
imports neither JAX nor the JAX package, so that a script on the card can
hold the kernel against it.

Both bodies, per (batch row, head, query row):

- s = q·kᵀ as 16-wide partial products (the ``wgmma`` k16 steps) added in
  fp32, Dh padded with zeros to a multiple of 16 (the zeros add exact
  zeros), times Dh^-0.5, plus the key bias; keys past S score -inf;
- the row sum of e = exp(s − m) over a row's four threads: thread t holds
  the keys 8n + 2t + {0, 1} and adds its e in key order, and
  l = (l_0 + l_1) + (l_2 + l_3) (the quad's butterfly). The one-pass body
  (Dh = 64, S ≤ 320) takes the exact row max m first; the streamed body
  (every other shape) keeps m and the four sums online over 64-key tiles:
  at each tile m rises over the tile and each l_t is scaled by
  exp(m_old − m_new) before the tile's e are added;
- p = e / l, rounded to bf16;
- o = p·v as partial products over 16 keys at a time added in fp32, cast
  to the output type.

Within a 16-wide step the sum is PyTorch's, where the tensor cores take
their own, and ``torch.exp`` stands for ``expf``: the model predicts the
card's order of operations, not its bits.
"""

from __future__ import annotations

import torch

TILE = 64  # keys a stage of the streamed body holds
ONE_PASS = (64, 320)  # the one-pass body's head width and longest row


def one_pass(dh: int, s: int) -> bool:
    """Whether the card takes (Dh, S) in one pass with the exact row max."""
    return dh == ONE_PASS[0] and s <= ONE_PASS[1]


def card_body_attention(qkv: torch.Tensor,
                        key_bias: torch.Tensor | None = None, *,
                        num_heads: int,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """qkv [B, S, 3·H·Dh] (bf16 values) and an fp32 key bias [B, S] → the
    body's output [B, S, H·Dh] in ``out_dtype``, computed on qkv's
    device."""
    b, s, width = qkv.shape
    dh = width // (3 * num_heads)
    q, k, v = (t.float() for t in qkv.bfloat16().reshape(
        b, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4))
    sc = q[..., :16] @ k[..., :16].transpose(-1, -2)
    for c in range(16, dh, 16):
        sc = sc + q[..., c:c + 16] @ k[..., c:c + 16].transpose(-1, -2)
    sc = sc * torch.tensor(dh ** -0.5, dtype=torch.float32)
    if key_bias is not None:
        sc = sc + key_bias.float()[:, None, None, :]
    tile = -(-s // 16) * 16 if one_pass(dh, s) else TILE
    sp = -(-s // tile) * tile
    sc = torch.nn.functional.pad(sc, (0, sp - s), value=float("-inf"))

    # the row max (exact, or online over the tiles) and four threads' sums
    m = (sc.amax(-1) if one_pass(dh, s)
         else torch.full(sc.shape[:-1], float("-inf"), device=sc.device))
    lt = torch.zeros(sc.shape[:-1] + (4,), device=sc.device)
    for kb in range(0, sp, tile):
        m_new = torch.maximum(m, sc[..., kb:kb + tile].amax(-1))
        lt = lt * torch.exp(m - m_new)[..., None]
        m = m_new
        for n in range(tile // 8):
            for j in range(2):
                cols = [kb + 8 * n + 2 * t + j for t in range(4)]
                lt = lt + torch.exp(sc[..., cols] - m[..., None])
    l = (lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3])

    # p normalised by division, then rounded to bf16; p·v in 16-key steps
    p = (torch.exp(sc - m[..., None]) / l[..., None]).bfloat16().float()
    p = p[..., :s]
    o = p[..., :16] @ v[..., :16, :]
    for c in range(16, s, 16):
        o = o + p[..., c:c + 16] @ v[..., c:c + 16, :]
    return o.transpose(1, 2).reshape(b, s, num_heads * dh).to(out_dtype)
