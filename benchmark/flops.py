"""Operations, bytes and peaks: the arithmetic every roofline share and every
``mfu`` of the benchmark reads, kept here so that the program cannot move
it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s in bf16, 1,979 TOP/s in int8, 495 TFLOP/s in TF32, 67
TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM.

The attention arithmetic is a frozen copy of ``chip_smoke.attention_flops``
/ ``attention_bound`` with one change: the backward counts only what it
needs, four S²·Dh products a head (dv, dp, dq, dk: 8·S²·Dh), whatever a
body recomputes, so that a later body that skips the score recompute cannot
read above 100%.
"""

from __future__ import annotations

PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: dict[str, float], nbytes: float) -> float:
    """The least time (s) for ``ops`` operations by route (``PEAK``'s
    keys) that must move ``nbytes``: the larger of the two times."""
    return max(sum(n / PEAK[k] for k, n in ops.items()),
               nbytes / HBM_BYTES_PER_S)


def attention_flops(b: int, s: int, h: int, dh: int,
                    backward: bool = False) -> int:
    """q·kᵀ and p·v (4·S²·Dh a head), or the backward's four products
    (8·S²·Dh)."""
    return b * h * (8 if backward else 4) * s * s * dh


def attention_bound_s(b: int, s: int, h: int, dh: int, in_bytes: int,
                      out_bytes: int | None = None, key_bias: bool = False,
                      backward: bool = False) -> float:
    """One attention call's bound: q, k, v (and dout) read once, the output
    (dq, dk, dv) written once, at the route of the input's type (bf16; an
    fp32 forward on the CUDA cores; an fp32 backward in split TF32, three
    products for each)."""
    io = b * s * h * dh
    moved = (io * in_bytes * 3 + io * (out_bytes or in_bytes)
             if not backward else io * in_bytes * (3 + 1 + 3))
    flops = attention_flops(b, s, h, dh, backward)
    if in_bytes == 2:
        ops = {"bf16": flops}
    else:
        ops = {"tf32": 3 * flops} if backward else {"fp32": flops}
    return bound_s(ops, moved + key_bias * b * s * 4)


def vit_tokens(vision: dict) -> int:
    return (vision["img_size"] // vision["patch_size"]) ** 2 + 1


def image_gemms(model: dict, rows: int) -> list[dict]:
    """The linears of ``rows`` images through the image tower and the
    visual head: name, M, N, K, and whether the int8 path adds a residual
    (read) and which type it writes (as W8A8 serves them)."""
    v = model["vision"]
    d, p = v["embed_dim"], v["patch_size"]
    f = int(d * v["mlp_ratio"])
    s = vit_tokens(v)
    m = rows * s
    k = model["projection_dim"]
    out = [dict(name="patch_embed", m=rows * (s - 1), n=d, k=3 * p * p,
                residual=False, out_bytes=2)]
    for _ in range(v["depth"]):
        out += [dict(name="qkv", m=m, n=3 * d, k=d, residual=False,
                     out_bytes=2),
                dict(name="proj", m=m, n=d, k=d, residual=True, out_bytes=2),
                dict(name="fc1", m=m, n=f, k=d, residual=False, out_bytes=4),
                dict(name="fc2", m=m, n=d, k=f, residual=True, out_bytes=2)]
    out += [dict(name="head1", m=rows, n=k, k=d, residual=False, out_bytes=2),
            dict(name="head2", m=rows, n=k, k=k, residual=False, out_bytes=2)]
    return out


def gemm_flops(g: dict) -> int:
    return 2 * g["m"] * g["n"] * g["k"]


def int8_gemm_bound_s(g: dict) -> float:
    """An int8 GEMM with its dequant epilogue: A and B codes, the row and
    column scales and the bias read, the residual (bf16) read where there is
    one, the output written."""
    m, n, k = g["m"], g["n"], g["k"]
    moved = (m * k + n * k + 4 * m + 4 * n + 4 * n
             + (2 * m * n if g["residual"] else 0) + g["out_bytes"] * m * n)
    return bound_s({"int8": gemm_flops(g)}, moved)


def image_attention_calls(model: dict, rows: int) -> list[dict]:
    v = model["vision"]
    return [dict(b=rows, s=vit_tokens(v), h=v["num_heads"],
                 dh=v["embed_dim"] // v["num_heads"])] * v["depth"]


def image_ideal_s(model: dict, rows: int, int8: bool) -> float:
    """The least time for ``rows`` images' GEMMs and attention products,
    each at its own route's peak: the numerator of ``mfu.extract``. The
    device resize and the elementwise work are not counted."""
    gemm = sum(gemm_flops(g) for g in image_gemms(model, rows))
    attn = sum(attention_flops(c["b"], c["s"], c["h"], c["dh"])
               for c in image_attention_calls(model, rows))
    return gemm / PEAK["int8" if int8 else "bf16"] + attn / PEAK["bf16"]


def image_flops(model: dict, rows: int) -> int:
    return (sum(gemm_flops(g) for g in image_gemms(model, rows))
            + sum(attention_flops(c["b"], c["s"], c["h"], c["dh"])
                  for c in image_attention_calls(model, rows)))


def text_flops(model: dict, rows: int) -> int:
    """BERT over ``rows`` sequences of ``max_text_length`` positions (the
    padded length: every position is computed), with the pooler."""
    t = model["text"]
    d, f, s = t["hidden_size"], t["intermediate_size"], \
        model["max_text_length"]
    layer = (2 * s * d * 3 * d + 2 * s * d * d + 2 * 2 * s * d * f
             + 4 * s * s * d)
    return rows * (t["num_hidden_layers"] * layer + 2 * d * d)


def train_flops(model: dict, rows: int) -> int:
    """Forward and backward of both towers: three times the forward (the
    backward's two products for each forward product); remat's recompute is
    not counted."""
    return 3 * (image_flops(model, rows) + text_flops(model, rows))


def train_attention_bwd_calls(model: dict, rows: int) -> list[dict]:
    """The backward attention calls of one training step: the ViT's, then
    BERT's (with its key mask)."""
    v, t = model["vision"], model["text"]
    return ([dict(b=rows, s=vit_tokens(v), h=v["num_heads"],
                  dh=v["embed_dim"] // v["num_heads"], key_bias=False)]
            * v["depth"]
            + [dict(b=rows, s=model["max_text_length"],
                    h=t["num_attention_heads"],
                    dh=t["hidden_size"] // t["num_attention_heads"],
                    key_bias=True)] * t["num_hidden_layers"])
