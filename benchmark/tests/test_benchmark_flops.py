"""The benchmark's operation and byte counts against hand counts."""

import pytest

import smallcell  # noqa: F401  (puts the repo on the path)
from benchmark import flops, harness


def keep_model():
    return harness.load_json(harness.HERE / "configs" /
                             "keep-bf16.json")["model"]


def test_vit_l16_tile_is_123_gflop():
    # by hand, S = 197, D = 1024, 24 blocks: qkv 2·S·D·3D, proj 2·S·D²,
    # fc1 and fc2 2·S·D·4D each, attention 4·S²·64·16; the patch embed
    # 2·196·768·1024; the head 2·1024·768 + 2·768·768
    s, d = 197, 1024
    block = (2 * s * d * 3 * d + 2 * s * d * d + 2 * 2 * s * d * 4 * d
             + 4 * s * s * 64 * 16)
    hand = 24 * block + 2 * 196 * 768 * 1024 + 2 * 1024 * 768 + 2 * 768 * 768
    assert flops.image_flops(keep_model(), 1) == hand
    assert hand == pytest.approx(123.08e9, rel=1e-3)


def test_attention_backward_counts_four_products():
    b, s, h, dh = 2, 197, 16, 64
    assert flops.attention_flops(b, s, h, dh) == 4 * b * h * s * s * dh
    assert flops.attention_flops(b, s, h, dh, backward=True) == \
        8 * b * h * s * s * dh


def test_bounds_take_the_larger_side():
    # ViT-L B=256: 40.7 GFLOP of products (41 µs at 989 TFLOP/s) against
    # 413 MB of q, k, v and out in bf16 (123 µs at 3.35 TB/s)
    t = flops.attention_bound_s(256, 197, 16, 64, 2)
    assert t == pytest.approx(256 * 197 * 1024 * 2 * 4 / 3.35e12)
    g = dict(m=4096, n=4096, k=4096, residual=False, out_bytes=2)
    assert flops.int8_gemm_bound_s(g) == pytest.approx(
        2 * 4096 ** 3 / 1979e12)


def test_ideal_time_uses_each_route_peak():
    m = keep_model()
    bf16 = flops.image_ideal_s(m, 1, int8=False)
    int8 = flops.image_ideal_s(m, 1, int8=True)
    attn = sum(flops.attention_flops(c["b"], c["s"], c["h"], c["dh"])
               for c in flops.image_attention_calls(m, 1))
    gemm = flops.image_flops(m, 1) - attn
    assert bf16 == pytest.approx((gemm + attn) / 989e12)
    assert int8 == pytest.approx(gemm / 1979e12 + attn / 989e12)
