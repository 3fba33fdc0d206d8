"""Plain CPU models of the card's bf16 attention kernels, in the order the
card takes their sums and roundings: the forward (#1 / #2's ``wgmma``
bodies in ``keep_tpu_torch/kernels/csrc/attention_qkv_slab_wgmma.cu``, bf16
or fp32 out; ``card_body_attention``) and the backward (#1b's two
``wgmma`` kernels, ``attention_qkv_slab_bwd_dq.cu`` and ``_dkv.cu``;
``card_body_attention_bwd``). It imports neither JAX nor the JAX package,
so that a script on the card can hold the kernels against it.

The forward:

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

The backward, per (batch row, head):

- s = q·kᵀ and dp = do·vᵀ as 16-wide partial products added in fp32; s
  times Dh^-0.5, plus the key bias; keys past S score -inf;
- kernel A's statistics over 64-key tiles: m online as the streamed
  forward's, and each of a row's four threads keeps l_t = Σ e and
  u_t = Σ e·dp (e = exp(s − m)) in key order, both scaled by exp(m_old −
  m_new) at each tile; l = (l_0 + l_1) + (l_2 + l_3), u likewise;
  1/l; rowsum(dp∘p) = u · (1/l);
- p = exp(s − m) · (1/l) and ds = p·(dp − rowsum) in fp32, each rounded to
  bf16 only as the operand of its products;
- dq = ds·k over 16-key steps (kernel A), dk = dsᵀ·q and dv = pᵀ·do over
  16-query steps (kernel B), added in fp32 in order; dq and dk times
  Dh^-0.5 in fp32; all cast once to bf16 into the slab layout.

Within a 16-wide step the sum is PyTorch's, where the tensor cores take
their own, and ``torch.exp`` stands for ``expf``: the model predicts the
card's order of operations, not its bits.
"""

from __future__ import annotations

import torch

TILE = 64  # keys a stage of the streamed bodies holds
ONE_PASS = (64, 320)  # the one-pass body's head width and longest row


def one_pass(dh: int, s: int) -> bool:
    """Whether the card takes (Dh, S) in one pass with the exact row max."""
    return dh == ONE_PASS[0] and s <= ONE_PASS[1]


def _k16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] · b [..., K, N] as 16-wide partial products along K
    added in fp32 in order (the wgmma k16 steps; a last step narrower)."""
    out = a[..., :16] @ b[..., :16, :]
    for c in range(16, a.shape[-1], 16):
        out = out + a[..., c:c + 16] @ b[..., c:c + 16, :]
    return out


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
    sc = _k16(q, k.transpose(-1, -2))
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
    o = _k16(p[..., :s], v)
    return o.transpose(1, 2).reshape(b, s, num_heads * dh).to(out_dtype)


def card_body_attention_bwd(qkv: torch.Tensor, key_bias: torch.Tensor,
                            dout: torch.Tensor, *,
                            num_heads: int) -> torch.Tensor:
    """qkv [B, S, 3·H·Dh] and dout [B, S, H·Dh] (bf16 values) and an fp32
    key bias [B, S] → the bf16 backward's dqkv [B, S, 3·H·Dh] in bf16,
    computed on qkv's device."""
    b, s, width = qkv.shape
    h = num_heads
    dh = width // (3 * h)
    q, k, v = (t.float() for t in qkv.bfloat16().reshape(
        b, s, 3, h, dh).permute(2, 0, 3, 1, 4))
    do = dout.bfloat16().float().reshape(b, s, h, dh).transpose(1, 2)
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    sc = (_k16(q, k.transpose(-1, -2)) * scale
          + key_bias.float()[:, None, None, :])
    dp = _k16(do, v.transpose(-1, -2))
    sp = -(-s // TILE) * TILE
    sc = torch.nn.functional.pad(sc, (0, sp - s), value=float("-inf"))
    dp = torch.nn.functional.pad(dp, (0, sp - s))

    # kernel A's pass 1: m online over the tiles, four threads' l and u
    m = torch.full(sc.shape[:-1], float("-inf"), device=sc.device)
    lt = torch.zeros(sc.shape[:-1] + (4,), device=sc.device)
    ut = torch.zeros_like(lt)
    for kb in range(0, sp, TILE):
        m_new = torch.maximum(m, sc[..., kb:kb + TILE].amax(-1))
        alpha = torch.exp(m - m_new)[..., None]
        lt, ut, m = lt * alpha, ut * alpha, m_new
        for n in range(TILE // 8):
            for j in range(2):
                cols = [kb + 8 * n + 2 * t + j for t in range(4)]
                e = torch.exp(sc[..., cols] - m[..., None])
                lt = lt + e
                ut = ut + e * dp[..., cols]
    inv = 1 / ((lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3]))
    delta = ((ut[..., 0] + ut[..., 1]) + (ut[..., 2] + ut[..., 3])) * inv

    # p and ds in fp32, rounded to bf16 as the operands of their products
    p = (torch.exp(sc - m[..., None]) * inv[..., None])[..., :s]
    ds = p * (dp[..., :s] - delta[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = _k16(ds16, k) * scale
    dk = _k16(ds16.transpose(-1, -2), q) * scale
    dv = _k16(p16.transpose(-1, -2), do)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, s, width).bfloat16()
