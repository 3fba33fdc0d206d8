"""Plain CPU models of the card's attention kernels, in the order the card
takes their sums and roundings: the bf16 forward (#1 / #2's ``wgmma``
bodies in ``keep_tpu_torch/kernels/csrc/attention_qkv_slab_wgmma.cu``, bf16
or fp32 out; ``card_body_attention``), the bf16 backward (#1b's two
``wgmma`` kernels, ``attention_qkv_slab_bwd_dq.cu`` and ``_dkv.cu``;
``card_body_attention_bwd``) and the fp32 backward (#1b's two split-TF32
``wgmma`` kernels, ``attention_qkv_slab_bwd_f32_dq.cu`` and
``_f32_dkv.cu``; ``card_body_attention_bwd_f32``). It imports neither JAX
nor the JAX package, so that a script on the card can hold the kernels
against it.

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

The fp32 backward, per (batch row, head): as the bf16 backward's, with
32-key tiles for kernel A's statistics and no bf16 rounding; each product
a · b in split TF32, every operand x as hi = rna_tf32(x) and lo =
rna_tf32(x − hi) (``tf32_split``), over k8 steps in order, each step
adding a_lo·b_hi, then a_hi·b_lo, then a_hi·b_hi to the fp32 sum
(``_tf32x3``); kernel B takes s and dp again as kᵀ's and vᵀ's products
(sᵀ = k·qᵀ, dpᵀ = v·doᵀ: the two middle terms in the other order).

Within a 16-wide (bf16) or 8-wide (TF32) step the sum is PyTorch's (in
fp64 for TF32: the parts' products are exact), where the tensor cores
take their own, and ``torch.exp`` stands for ``expf``: the model predicts
the card's order of operations, not its bits.
"""

from __future__ import annotations

import contextlib

import torch

TILE = 64  # keys a stage of the streamed bodies holds
F32_TILE = 32  # keys a stage of the fp32 backward's kernel A holds
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


def _row_statistics(sc: torch.Tensor, dp: torch.Tensor, tile: int):
    """Kernel A's pass 1 over ``tile``-key tiles: m online (at each tile m
    rises over the tile), each of a row's four threads keeping l_t = Σ e
    and u_t = Σ e·dp (e = exp(s − m), thread t's keys 8n + 2t + {0, 1} in
    key order), both scaled by exp(m_old − m_new) at each tile; l = (l_0 +
    l_1) + (l_2 + l_3), u likewise. Returns m, 1/l and rowsum(dp∘p) =
    u · (1/l)."""
    s = sc.shape[-1]
    sp = -(-s // tile) * tile
    sc = torch.nn.functional.pad(sc, (0, sp - s), value=float("-inf"))
    dp = torch.nn.functional.pad(dp, (0, sp - s))
    m = torch.full(sc.shape[:-1], float("-inf"), device=sc.device)
    lt = torch.zeros(sc.shape[:-1] + (4,), device=sc.device)
    ut = torch.zeros_like(lt)
    for kb in range(0, sp, tile):
        m_new = torch.maximum(m, sc[..., kb:kb + tile].amax(-1))
        alpha = torch.exp(m - m_new)[..., None]
        lt, ut, m = lt * alpha, ut * alpha, m_new
        for n in range(tile // 8):
            for j in range(2):
                cols = [kb + 8 * n + 2 * t + j for t in range(4)]
                e = torch.exp(sc[..., cols] - m[..., None])
                lt = lt + e
                ut = ut + e * dp[..., cols]
    inv = 1 / ((lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3]))
    delta = ((ut[..., 0] + ut[..., 1]) + (ut[..., 2] + ut[..., 3])) * inv
    return m, inv, delta


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
    m, inv, delta = _row_statistics(sc, dp, TILE)

    # p and ds in fp32, rounded to bf16 as the operands of their products
    p = torch.exp(sc - m[..., None]) * inv[..., None]
    ds = p * (dp - delta[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = _k16(ds16, k) * scale
    dk = _k16(ds16.transpose(-1, -2), q) * scale
    dv = _k16(p16.transpose(-1, -2), do)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, s, width).bfloat16()


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo as the kernels split it: hi = cvt.rna.tf32.f32(x) (10
    fraction bits, ties away from zero), lo = the same of x − hi (exact in
    fp32); finite fp32 x."""

    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def _tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] · b [..., K, N] in split TF32: over 8-wide steps along
    K in order, the step's a_lo·b_hi, a_hi·b_lo and a_hi·b_hi each summed
    exactly (fp64) and added in turn to the fp32 sum."""
    pad = -a.shape[-1] % 8
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    steps = a.shape[-1] // 8

    def by_step(x, y):  # [steps, ..., M, N]: each step's exact sum
        xs = x.double().unflatten(-1, (steps, 8)).movedim(-2, 0)
        ys = y.double().unflatten(-2, (steps, 8)).movedim(-3, 0)
        return xs @ ys

    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    parts = [by_step(al, bh), by_step(ah, bl), by_step(ah, bh)]
    out = torch.zeros(parts[0].shape[1:], device=a.device)
    for c in range(steps):
        for part in parts:
            out = (out.double() + part[c]).float()
    return out


@contextlib.contextmanager
def _one_thread():
    """One CPU thread for the model's many small fp64 products, which
    several threads take ~50× longer on a busy host; the caller's count
    restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@_one_thread()
def card_body_attention_bwd_f32(qkv: torch.Tensor, key_bias: torch.Tensor,
                                dout: torch.Tensor, *,
                                num_heads: int) -> torch.Tensor:
    """qkv [B, S, 3·H·Dh] and dout [B, S, H·Dh] (fp32) and an fp32 key bias
    [B, S] → the fp32 backward's dqkv [B, S, 3·H·Dh], computed on qkv's
    device."""
    b, s, width = qkv.shape
    h = num_heads
    dh = width // (3 * h)
    q, k, v = qkv.float().reshape(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
    do = dout.float().reshape(b, s, h, dh).transpose(1, 2)
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    bias = key_bias.float()[:, None, None, :]

    # kernel A: s and dp, the statistics over 32-key tiles, p, ds and dq
    sc = _tf32x3(q, k.transpose(-1, -2)) * scale + bias
    dp = _tf32x3(do, v.transpose(-1, -2))
    m, inv, delta = _row_statistics(sc, dp, F32_TILE)
    p = torch.exp(sc - m[..., None]) * inv[..., None]
    dq = _tf32x3(p * (dp - delta[..., None]), k) * scale

    # kernel B: s^T and dp^T as k's and v's products, p^T and ds^T from
    # the statistics of each query column
    sc_t = _tf32x3(k, q.transpose(-1, -2)) * scale + bias.transpose(-1, -2)
    dp_t = _tf32x3(v, do.transpose(-1, -2))
    p_t = torch.exp(sc_t - m[..., None, :]) * inv[..., None, :]
    ds_t = p_t * (dp_t - delta[..., None, :])
    dk = _tf32x3(ds_t, q) * scale
    dv = _tf32x3(p_t, do)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, s, width)
