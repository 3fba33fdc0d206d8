#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``keep_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (a failing phase raises, and the script
exits non-zero without a result line):

1. device   — needs CUDA; prints the card and its power limit; TF32 off.
2. build    — compiles the CUDA kernels from ``keep_tpu_torch/kernels/csrc``
   (one nvcc per source, in parallel).
3. kernel   — ``attention_qkv_slab`` against its plain PyTorch version at the
   serving shapes (ViT-L: S=197, H=16, no bias; BERT-base: S=256, H=12,
   padded key bias; each at B=32 and B=128), in fp32 (atol = rtol = 2e-5)
   and bf16 (max |Δ| < 0.05 on unpadded query rows), each timed with CUDA
   events,
   beside ``F.scaled_dot_product_attention`` on the same values (a
   yardstick the port never calls; the backend that ran is recorded).
   Then the bf16 → fp32 form the int8 blocks run (its own ``wgmma`` body)
   at the same shapes: max |Δ| < 0.05 on unpadded query rows, with the
   mean |Δ| and the share of the int8 codes re-quantized from it that move
   against those from the plain version (none by more than one), timed
   beside its bound and SDPA's bf16 time (a reading, not a yardstick: no
   one call computes the fp32-out function); and at every edge length of
   ``tests/test_torch_gpu.py`` (S = 1 … 512), padded and unpadded.
   heads — ``flash_attention`` / ``attention_qkv_heads`` (split q, k, v) at
   the same shapes and tolerances (BERT with a [B, 1, 1, S] mask), bit for
   bit against ``attention_qkv_heads`` and ``attention_qkv_slab`` on the
   same values, timed beside SDPA;
   then its path, ``ops.nn.mha_attention(use_flash=True)``, with its
   launches counted.
   int8_kernel — the int8 counterparts of the TPU kernels (the ViT and BERT
   attention sub-blocks, the MLP pair in both towers' forms and flat, the
   patch-embed and visual-head matmuls) against their plain versions at the
   serving shapes, in fp32 at the JAX package's tolerances for each
   (``tests/test_quant.py``; the attention sub-blocks, whose attention
   runs on the tensor cores in another order, at its tolerance between two
   routes: atol = rtol = 2e-2 and cosine ≥ 0.9999 per row), with the share
   of int8 codes that differ from the plain version's (for the attention
   sub-blocks also the codes re-quantized from the kernel's attention
   against the plain attention's on the same slab, none moving by more
   than one); kernel and plain times in bf16. The flat MLP pair
   bit for bit against the [B, S, D] form, and its path, ``ops.nn.Mlp`` on
   an int8 fc1/fc2 pair and a 2-D input, with its launches counted.
   int8_primitive — the three CUDA kernels alone (quant_rows, int8_gemm,
   ln_rows) at the shapes #4 and #6 give them in a ViT-L dispatch at B=32
   and B=128 (the qkv, proj, fc1 and fc2 GEMMs with their epilogues; the
   row passes over the stream, the attention output and the MLP hidden;
   BERT's post-LN rows), bit for bit against their plain versions, each
   with its device time, its bound and, for the GEMMs, TOP/s beside cuBLAS
   int8 (``torch._int_mm``) on the same operands.
   ln_matmul — the fused LayerNorm → matmul against its plain version at the
   ViT-L qkv and fc1 shapes (M = 197·B for B = 32 and 128, K = 1024, N =
   3072, 4096), fp32 at 2e-5 and bf16 within one bf16 rounding, timed
   beside the unfused cuBLAS route (``F.layer_norm`` then ``F.linear``)
   and the product alone in cuBLAS, with its statistics pass's device time
   and its share of the bound. fuse_ln_path — a full-width
   ViT-L/16 (224², bf16, B = 128, random weights whose blocks all move the
   stream) under ``use_flash=True, fuse_ln=True`` and its visual head,
   against ``fuse_ln=False``: cosine ≥ 0.999 per row, 48 ``ln_matmul`` and
   24 attention launches per forward, every ``ln_matmul`` call of the
   forward against its plain version on the same inputs (bf16 tolerance as
   above), two faults planted in the kernel's result that must each fail
   one of these gates, both forwards' device times and ``ln_matmul``'s
   share.
4. server   — a full-width KEEP (ViT-L/16 + BERT-base) with random weights
   written in the released checkpoint layout, loaded by
   ``keep_tpu_torch.serve.build_server`` (bf16, fused attention), warmed up
   and driven over HTTP. The served features must be finite unit vectors of
   width 768 that agree (cosine ≥ 0.999) with the same weights run without
   the kernel, and the kernel's launch count must show that every block of
   every dispatch went through it.
5. numbers  — image and text throughput at bucket 128, the device-time
   share of the attention kernel, and the device time of one image and one
   text dispatch by kernel family (``scripts/torch_dispatch_profile.py``'s
   families), beside the card's name and power limit.
6. int8_drift — the int8 model of phase 4's weights against phase 4's
   features, reported, not gated: on weights whose every block moves the
   stream, W8A8 drifts further than on the JAX package's init statistics.
   server (int8) — weights drawn with the statistics of the JAX package's
   ``keep.init`` (on which its int8 gate, ``bench.py`` ``_int8_gate``, is
   measured) served by ``build_server([..., "--int8"])`` and driven over
   HTTP as in phase 4: finite unit features, cosine ≥ 0.999 per row against
   the same weights served in bf16, against the same int8 model with its
   blocks' plain versions at the JAX package's gate between two int8 routes
   (mean cosine of the image rows and cosine of the text features taken
   whole > 0.9999; the per-row cosines reported), and launch counts that
   show every block of every dispatch went through the int8 attention
   sub-block and MLP pair of its tower.
7. numbers (int8) — the same throughputs and breakdowns for the int8
   server, whose attention must show as the ``wgmma`` body's kernel.
8. attention_bwd — the backward kernel of ``attention_qkv_slab`` against its
   plain version at the training shapes at B=32 and B=128 (ViT-L: S=197,
   H=16, zero key bias; BERT-base: S=256, H=12, padded key bias), fp32 at
   atol 2e-4, rtol 1e-4 and bf16 within 1e-2 of the largest plain gradient
   on unpadded rows, each timed with CUDA events.
9. train — ``keep_tpu_torch.train.main.main(["--config", <json>,
   "--device", "cuda"])`` on the values of ``configs/keep_train.yml``
   (batch 128, 32 captions, lhp-hn, amp_bf16, fused attention, both towers
   frozen in epoch 0) at full width from a random init, on PNG tiles,
   groups, a DO graph and a vocab written from a seed: 2 epochs of 4 steps. Every loss finite; no backward launch
   and towers equal to the seed's initial weights while frozen; in epoch 1
   every step launches the backward kernel once per block and the forward
   kernel twice (remat), and the towers move; a checkpoint that
   ``restore()`` reads back. Prints ms per unfrozen step, samples/s, peak
   device memory and the device time of the last step by kernel family.

The zero-shot WSI sweep runs between phases 7 and 8, on phase 6's weights
(``keep.init`` statistics), through ``keep_tpu_torch.wsi.run.load_model``,
once in bf16 and once with ``--int8`` (calibration 0). Every fp32 product
of the sweep is checked to give the same bits with TF32 on, against a
control: with the guard (``ops.nn.ieee_fp32``) taken out, TF32 must move
the bicubic's pixels, the probabilities and the screening's scores. The
kernels are held against their plain versions at the shapes this path
gives them (batch 256; text widths as dispatched).

10. wsi_extract — a flat 16,384² synthetic slide from a seed →
    ``io.tiles.cut_tiles`` (~3,300 tissue tiles of 256²) →
    ``wsi.extract.extract_features(resize=True, batch_size=256)``: the
    bicubic 256 → 224 and the ViT-L on the card. Gates: the card's bicubic
    against the CPU's on 64 tiles (≤ 1/255); the features against plain
    attention on the first batch (cosine ≥ 0.999); ``pipeline_depth`` 1
    against 3 (the same bits); the padded tail batch against its rows
    alone (cosine ≥ 0.9999); int8 against bf16 (cosine ≥ 0.999) and, on
    the first batch, against the same int8 model with plain blocks (mean
    row cosine > 0.9999, tests/test_quant.py:300); one attention (int8:
    sub-block and MLP pair) launch per block and batch.
    Prints tiles/s from uint8 tiles to fetched features, bf16 and int8, the
    bicubic's ms per batch and the idle share of a profiled run.
11. wsi_classifier — ``zeroshot.build_classifiers_batched`` over 1,386
    two-class prompts (texts of 5–40 tokens from ``VOCAB``) with
    ``length_buckets="auto"`` and then flat: columns at cosine ≥ 0.9999,
    the plan and its tier, prompts/s of each, 12 attention launches a text
    dispatch; one batch of each width dispatched against the same BERT
    with plain attention (cosine ≥ 0.999 per row); the flat build with the
    int8 text tower (cosine ≥ 0.999), its batches against the same int8
    model with plain blocks (> 0.9999 taken whole, tests/test_quant.py:327).
12. wsi_pipelines — 100,000 patches on a 317 × 317 grid (D = 768, a
    tumour disc): ``prompt_select`` (top 50 of 1,386), ``random_ensemble``,
    detection (overlap off and on), segmentation (a level-0 mask at 32
    pixels a patch), subtyping (3 classes + Normal) and the tumour heatmap
    on the card, each held against the same functions on the CPU:
    probabilities and the merged classifier at 1e-5, the same top-50 set,
    decisions, AUROC, Dice and heatmap bytes equal (patches within 1e-5 of
    a threshold counted; only they may move a value, by at most what they
    can move it). Prints the ms of each step.

Then one JSON line describing the kernels (each TPU kernel's counterpart:
its launches on the path that runs it, its time, its plain version's, its
bound — the larger of its operations over the card's peak for their type
and its bytes over 3.35 TB/s — and the one PyTorch call that computes the
same function, or null), and last the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SOURCE = "keep_tpu_torch/kernels/csrc/attention_qkv_slab.cu"
REPLACES = "keep_tpu/kernels/flash_attention.py:190"
BWD_SOURCE = "keep_tpu_torch/kernels/csrc/attention_qkv_slab_bwd.cu"
BWD_REPLACES = "keep_tpu/kernels/flash_attention.py:221"
HEADS_REPLACES = "keep_tpu/kernels/flash_attention.py:115"
LN_MATMUL_SOURCE = "keep_tpu_torch/kernels/csrc/ln_matmul.cu"
LN_MATMUL_REPLACES = "keep_tpu/kernels/ln_matmul.py:51"
LN_MATMUL_BODY = ("ln_stats_kernel (one read of x) + ln_matmul_wgmma_kernel: "
                  "persistent 128x256 tiles, wgmma m64n256k16 fed by TMA, "
                  "x normalised in the register-A fragments, TMA-store "
                  "epilogue")
CSRC = "keep_tpu_torch/kernels/csrc/"
# the card's published peaks (H100 SXM, dense) and memory rate, for the
# least time a kernel's work could take (bound_ms)
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# the int8 counterparts of the TPU kernels: the module that composes them
# and the CUDA sources they run, the TPU kernel each replaces
INT8_KERNELS = {
    "quantized_attention_block": (
        "keep_tpu_torch/kernels/qblock.py",
        ["quant_rows.cu", "int8_gemm.cu", "attention_qkv_slab_f32.cu"],
        "keep_tpu/kernels/qblock.py:79"),
    "quantized_attention_block_postln": (
        "keep_tpu_torch/kernels/qblock.py",
        ["quant_rows.cu", "int8_gemm.cu", "attention_qkv_slab_f32.cu"],
        "keep_tpu/kernels/qblock.py:182"),
    "quantized_mlp_bsd": (
        "keep_tpu_torch/kernels/qmlp.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmlp.py:227"),
    "quantized_matmul_bsd": (
        "keep_tpu_torch/kernels/qmatmul.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmatmul.py:151"),
    "quantized_matmul": (
        "keep_tpu_torch/kernels/qmatmul.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmatmul.py:80"),
    "quantized_mlp": (
        "keep_tpu_torch/kernels/qmlp.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmlp.py:97"),
}
# the attention phases' shapes (name, B, S, H, padded key bias): the
# serving shapes at B=32, whose slab fits the 50 MB L2, and at B=128, the
# serving and training buckets, whose slab (155 MB for ViT-L in bf16) does
# not
ATTENTION_SHAPES = [(name, b, s, h, padded) for b in (32, 128)
                    for name, s, h, padded in (("vit_l16", 197, 16, False),
                                               ("bert_base", 256, 12, True))]
# sequence lengths around the attention bodies' tiles and pieces, the two
# towers' lengths and the kernels' limit (tests/test_torch_gpu.py EDGE_S)
EDGE_S = [1, 15, 16, 17, 64, 197, 256, 257, 512]
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] an h & e image of breast invasive "
         "carcinoma normal tissue lung adeno ##carcinoma squamous cell "
         "melanoma skin kidney clear renal tumor . , -").split()
PROMPTS = ["an h&e image of breast invasive carcinoma.",
           "an h&e image of normal lung tissue.",
           "an h&e image of clear cell renal carcinoma."]


def phase(tag: str, /, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median of ``runs`` single-call times from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, runs: int = 20) -> float:
    """The device time of one call of ``fn`` (ms): the profiler's kernel
    time summed over ``runs`` calls, the host's gaps between launches left
    out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(kernel_ms(torch, prof).values()) / runs


def bound(ops: dict[str, float], nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take for work of ``ops``
    operations by type (``PEAK``'s keys) that must move ``nbytes`` (each
    input read once, each output written once): the larger of the two
    times, and which one sets it."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items()) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def attention_bound(b: int, s: int, h: int, dtype_bytes: int,
                    key_bias: bool, backward: bool = False,
                    out_bytes: int | None = None) -> tuple[float, str]:
    """The bound of one attention call (Dh = 64): the forward's q·kᵀ and p·v
    (4·S²·Dh per head), the backward's score recompute and four products
    (10·S²·Dh); q, k, v (and dout) read, the output (dq, dk, dv) written,
    the forward's output in ``out_bytes`` a value (default: the input's)."""
    dh = 64
    per_head = (10 if backward else 4) * s * s * dh
    io = b * s * h * dh
    moved = (io * dtype_bytes * 3 + io * (out_bytes or dtype_bytes)
             if not backward else io * dtype_bytes * (3 + 1 + 3))
    return bound({"bf16": b * h * per_head}, moved + key_bias * b * s * 4)


def sdpa_backend(torch, fn) -> str:
    """The name of the longest device kernel of one call of ``fn`` (which
    SDPA backend ran)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = kernel_ms(torch, prof)
    return max(by_kernel, key=by_kernel.get) if by_kernel else "not measured"


def check_kernel(fa, torch, gen) -> tuple[list[dict], list[dict]]:
    """Phase 3: the slab attention against its plain version in fp32 and
    bf16, then its bf16 → fp32 form (``check_f32_form``), at each of
    ``ATTENTION_SHAPES``, then the fp32-out form at the edge lengths.
    Returns (fp32 and bf16 rows, bf16 → fp32 rows)."""
    shapes = ATTENTION_SHAPES
    rows, f32_rows = [], []
    for name, b, s, h, padded in shapes:
        qkv32 = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen)
        kb, valid = None, torch.ones(b, s, dtype=torch.bool, device="cuda")
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            valid = torch.arange(s, device="cuda")[None] < lens[:, None]
            kb = (1.0 - valid.float()) * -1e9
        for dtype in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dtype)
            got = fa.attention_qkv_slab(qkv, kb, num_heads=h)
            torch.cuda.synchronize()
            ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h)
            g, r = got.float()[valid], ref.float()[valid]
            err = (g - r).abs().max().item()
            if dtype == torch.float32:
                if not torch.allclose(g, r, atol=2e-5, rtol=2e-5):
                    raise AssertionError(
                        f"{name} fp32 kernel vs plain: max |Δ| {err}")
            elif not err < 0.05:
                raise AssertionError(f"{name} bf16 kernel vs plain: "
                                     f"max |Δ| {err}")
            ms = cuda_ms(lambda: fa.attention_qkv_slab(qkv, kb, num_heads=h))
            plain_ms = cuda_ms(lambda: fa.attention_qkv_slab_reference(
                qkv, kb, num_heads=h))
            # the library's attention on the slab's [B, H, S, Dh] head views,
            # a yardstick the port never calls
            q, k, v = qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4)
            mask = None if kb is None else kb[:, None, None, :].to(dtype)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask)
            row = {"shape": name, "B": b, "S": s, "H": h,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": cuda_ms(sdpa),
                   "library_kernel": sdpa_backend(torch, sdpa)}
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, h, qkv.element_size(), kb is not None)
            phase("kernel", **row)
            rows.append(row)
        f32_rows.append(check_f32_form(fa, torch, name, qkv32.bfloat16(), kb,
                                       valid, h, rows[-1]["library_ms"]))
    check_f32_edges(fa, torch, gen)
    return rows, f32_rows


def code_moves(torch, got, ref) -> float:
    """The int8 codes an int8 block re-quantizes from an fp32 attention
    output [B, S, D] (``quant_rows`` over full D rows): the kernel's output
    through the kernel against the plain output through the plain version.
    Raises if a code moves by more than one; returns the share that
    moves."""
    from keep_tpu_torch.kernels import _kops

    d = got.shape[-1]
    q, _ = _kops.quant_rows(got.reshape(-1, d))
    rq, _ = _kops.PLAIN.quant_rows(ref.reshape(-1, d))
    diff = (q.int() - rq.int()).abs()
    if diff.max().item() > 1:
        raise AssertionError(f"int8 codes from the fp32-out attention off by "
                             f"{diff.max().item()}")
    return diff.count_nonzero().item() / diff.numel()


def check_f32_form(fa, torch, name, qkv, kb, valid, h, sdpa_ms) -> dict:
    """The bf16 → fp32 form of ``attention_qkv_slab`` (the int8 blocks'
    attention, its ``wgmma`` body) against its plain version on a bf16
    slab: finite, max |Δ| < 0.05 on unpadded query rows (the bf16 attention
    gate; the tensor cores sum in another order), the re-quantized codes
    within one of the plain version's (``code_moves``); its time (CUDA
    events; the profiler's device time beside), the plain version's, its
    bound (the bf16 slab read, the fp32 output written) and SDPA's bf16
    time on the same values (``sdpa_ms``, a reading)."""
    b, s, _ = qkv.shape
    kw = dict(num_heads=h, out_dtype=torch.float32)
    got = fa.attention_qkv_slab(qkv, kb, **kw)
    torch.cuda.synchronize()
    ref = fa.attention_qkv_slab_reference(qkv, kb, **kw)
    diff = (got - ref).abs()[valid]
    err = diff.max().item()
    if not (torch.isfinite(got).all() and err < 0.05):
        raise AssertionError(f"{name} B={b} bf16 -> fp32 kernel vs plain: "
                             f"max |Δ| {err}")
    row = {"shape": name, "B": b, "S": s, "H": h,
           "dtype": "bfloat16->float32", "max_abs_err": err,
           "mean_abs_err": diff.mean().item(),
           "int8_codes_moved_share": code_moves(torch, got, ref),
           "ms": cuda_ms(lambda: fa.attention_qkv_slab(qkv, kb, **kw)),
           "device_ms": device_ms(
               torch, lambda: fa.attention_qkv_slab(qkv, kb, **kw)),
           "plain_ms": cuda_ms(lambda: fa.attention_qkv_slab_reference(
               qkv, kb, **kw)),
           "sdpa_bf16_ms_reading": sdpa_ms}
    row["bound_ms"], row["bound_by"] = attention_bound(
        b, s, h, 2, kb is not None, out_bytes=4)
    phase("kernel_f32", **row)
    return row


def check_f32_edges(fa, torch, gen) -> None:
    """The bf16 → fp32 form at every length of ``EDGE_S`` (B=2, H=2),
    padded and unpadded: finite, max |Δ| < 0.05 on unpadded query rows."""
    errs = {}
    for s in EDGE_S:
        for padded in (False, True):
            qkv = torch.randn(2, s, 3 * 2 * 64, device="cuda",
                              generator=gen).bfloat16()
            kb, valid = None, torch.ones(2, s, dtype=torch.bool,
                                         device="cuda")
            if padded:
                lens = torch.randint(1, s + 1, (2,), device="cuda",
                                     generator=gen)
                valid = torch.arange(s, device="cuda")[None] < lens[:, None]
                kb = (1.0 - valid.float()) * -1e9
            kw = dict(num_heads=2, out_dtype=torch.float32)
            got = fa.attention_qkv_slab(qkv, kb, **kw)
            torch.cuda.synchronize()
            ref = fa.attention_qkv_slab_reference(qkv, kb, **kw)
            err = (got - ref).abs()[valid].max().item()
            if not (torch.isfinite(got).all() and err < 0.05):
                raise AssertionError(f"bf16 -> fp32 kernel at S={s}, padded "
                                     f"{padded}: max |Δ| {err}")
            errs[f"S={s}{' padded' if padded else ''}"] = err
    phase("kernel_f32_edges", max_abs_err=errs)


def check_heads(fa, torch, gen) -> tuple[list[dict], int]:
    """Phase 3b. ``flash_attention`` (split q, k, v [B, H, S, Dh], read
    through their strides by the kernel of ``attention_qkv_heads``) against
    its plain version at the serving shapes (ViT-L: S=197, H=16, no bias;
    BERT-base: S=256, H=12, a padded [B, 1, 1, S] mask; B=32 and 128), fp32
    at 2e-5 and bf16 at max |Δ| < 0.05 on unpadded query rows; bit for bit
    against ``attention_qkv_heads`` and ``attention_qkv_slab`` on the same
    q, k, v; the kernel's, the plain version's and SDPA's times. Then the
    main path: ``ops.nn.mha_attention(use_flash=True)`` at every shape in
    bf16, its launches counted from zero. Returns (rows, launches)."""
    from keep_tpu_torch.ops.nn import mha_attention

    F = torch.nn.functional
    shapes = ATTENTION_SHAPES
    rows, inputs = [], []
    for name, b, s, h, padded in shapes:
        q32, k32, v32 = (torch.randn(b, h, s, 64, device="cuda",
                                     generator=gen) for _ in range(3))
        valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
        bias = None
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            valid = torch.arange(s, device="cuda")[None] < lens[:, None]
            bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
        kb = None if bias is None else bias.reshape(b, s)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            got = fa.flash_attention(q, k, v, bias)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q, k, v, bias)
            g = got.transpose(1, 2).float()[valid]
            r = ref.transpose(1, 2).float()[valid]
            err = (g - r).abs().max().item()
            if dtype == torch.float32:
                if not torch.allclose(g, r, atol=2e-5, rtol=2e-5):
                    raise AssertionError(
                        f"{name} fp32 heads kernel vs plain: max |Δ| {err}")
            elif not err < 0.05:
                raise AssertionError(f"{name} bf16 heads kernel vs plain: "
                                     f"max |Δ| {err}")
            lanes = [t.transpose(1, 2).reshape(b, s, h * 64) for t in
                     (q, k, v)]
            heads = fa.attention_qkv_heads(*lanes, kb, num_heads=h)
            slab = fa.attention_qkv_slab(torch.cat(lanes, -1).contiguous(), kb,
                                         num_heads=h)
            if not (torch.equal(heads, slab) and torch.equal(
                    got.transpose(1, 2).reshape(b, s, h * 64), heads)):
                raise AssertionError(f"{name} B={b} {dtype}: flash_attention, "
                                     f"the heads kernel and the slab kernel "
                                     f"differ on the same q, k, v")
            mask = None if bias is None else bias.to(dtype)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask)
            row = {"shape": name, "B": b, "S": s, "H": h,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "equals_slab_bitwise": True,
                   "flash_attention_equals_heads_bitwise": True,
                   "ms": cuda_ms(lambda: fa.attention_qkv_heads(
                       *lanes, kb, num_heads=h)),
                   "plain_ms": cuda_ms(lambda: fa.attention_qkv_heads_reference(
                       *lanes, kb, num_heads=h)),
                   "flash_attention_ms": cuda_ms(
                       lambda: fa.flash_attention(q, k, v, bias)),
                   "library_ms": cuda_ms(sdpa),
                   "library_kernel": sdpa_backend(torch, sdpa)}
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, h, q.element_size(), padded)
            phase("heads", **row)
            rows.append(row)
            if dtype == torch.bfloat16:
                inputs.append((name, q, k, v, bias, valid, ref))

    with fa._launch_lock:
        fa.HEADS_LAUNCHES = 0
    # ---- the main path: the generic attention op with the kernel -----------
    with torch.inference_mode():
        outs = [mha_attention(q, k, v, bias=bias, use_flash=True)
                for _, q, k, v, bias, _, _ in inputs]
    torch.cuda.synchronize()
    launches = fa.HEADS_LAUNCHES
    # -------------------------------------------------------------------------
    if launches != len(inputs):
        raise AssertionError(f"mha_attention(use_flash=True): {launches} "
                             f"kernel launches for {len(inputs)} calls")
    for out, (name, _, _, _, _, valid, ref) in zip(outs, inputs):
        g = out.transpose(1, 2).float()[valid]
        if not torch.isfinite(g).all() or \
                not (g - ref.transpose(1, 2).float()[valid]).abs().max() < 0.05:
            raise AssertionError(f"{name}: mha_attention(use_flash=True) "
                                 f"differs from the plain version")
    phase("heads_path", entry="ops.nn.mha_attention(use_flash=True)",
          calls=[n for n, *_ in inputs], launches=launches)
    return rows, launches


def check_ln_matmul(lm, torch, gen) -> list[dict]:
    """Phase 3d. ``ln_matmul`` against its plain version at the ViT-L
    projections after a LayerNorm (K = 1024, N = 3072 for qkv, 4096 for
    fc1) at B=32 and B=128 (M = 197·B): fp32 at 2e-5; bf16 within one bf16
    rounding (rtol 2⁻⁷, atol 1e-2 for outputs near zero). Times of the
    kernel and its plain version in both types; in bf16 also
    ``scripts/torch_ln_matmul_bench.py``'s ``measure``: the kernel's
    device ms split into the statistics pass (``stats_ms``) and the GEMM,
    the unfused cuBLAS route (``F.layer_norm`` then ``F.linear``, two calls:
    ``unfused_ms``), the product alone in cuBLAS on the normalised rows
    (``gemm_library_ms``), the bound and the kernel's share of it."""
    from scripts.torch_ln_matmul_bench import measure

    k = 1024
    rows = []
    for batch in (32, 128):
        m = 197 * batch
        x32 = torch.randn(m, k, device="cuda", generator=gen) * 2 + 0.5
        g = 1 + 0.1 * torch.randn(k, device="cuda", generator=gen)
        b = 0.05 * torch.randn(k, device="cuda", generator=gen)
        for n in (3072, 4096):
            w32 = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
            bias = 0.02 * torch.randn(n, device="cuda", generator=gen)
            row = {"shape": f"vit_l16 [{m},{k}]x[{k}->{n}]", "B": batch}
            for dtype in (torch.float32, torch.bfloat16):
                x, w = x32.to(dtype), w32.to(dtype)
                got = lm.ln_matmul(x, g, b, w, bias, 1e-6, dtype)
                torch.cuda.synchronize()
                ref = lm.ln_matmul_reference(x, g, b, w, bias, 1e-6, dtype)
                err = (got.float() - ref.float()).abs().max().item()
                tol = (dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32
                       else dict(atol=1e-2, rtol=2 ** -7))
                if not torch.allclose(got.float(), ref.float(), **tol):
                    raise AssertionError(f"ln_matmul {row['shape']} {dtype} "
                                         f"vs plain: max |Δ| {err}")
                tag = "fp32" if dtype == torch.float32 else "bf16"
                row[f"max_abs_err_{tag}"] = err
                if dtype == torch.float32:
                    row["ms_fp32"] = cuda_ms(
                        lambda: lm.ln_matmul(x, g, b, w, bias, 1e-6, dtype))
                row[f"plain_ms_{tag}"] = cuda_ms(lambda: lm.ln_matmul_reference(
                    x, g, b, w, bias, 1e-6, dtype))
                del got, ref
            t = measure(lm, x, g, b, w, bias)
            row.update({key: v for key, v in t.items()
                        if key not in ("B", "M", "K", "N")})
            phase("ln_matmul", **row)
            rows.append(row)
            del x, w, w32
        del x32
        torch.cuda.empty_cache()
    return rows


def drive_fuse_ln(torch, fa, lm, cfg) -> dict:
    """Phase 3e. The ViT under ``fuse_ln`` at full width: ViT-L/16 at 224²,
    bf16, tanh GELU, B = 128, random weights whose blocks all move the
    residual stream (LayerScale 0.1–0.5; ``keep.init``'s 1e-5 would scale
    every ``ln_matmul`` result down to where the features cannot see it).
    ``model.visual(..., use_flash=True, fuse_ln=True)`` and the visual head
    against the same call with ``fuse_ln=False``: finite features, cosine ≥
    0.999 per row, and exactly 2 ``ln_matmul`` and 1 slab-attention launch
    per block of the forward. Then every ``ln_matmul`` call of a second
    fused forward is held against its plain version on the same inputs at
    ``check_ln_matmul``'s bf16 tolerance, and two faults planted in the
    kernel's result must each fail one of the two gates. Device ms of both
    forwards (CUDA events) and ``ln_matmul``'s share of the fused one
    (torch.profiler)."""
    from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                    random_keep_state_dict)
    from keep_tpu_torch.models import vit
    from keep_tpu_torch.models.keep import KEEPModel

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = KEEPModel(cfg, device="cuda", dtype=torch.bfloat16,
                      gelu_approx=True)
    model.load_state_dict(load_keep_state_dict(
        random_keep_state_dict(cfg, gen, device="cuda"), cfg), strict=True)
    model.eval()
    size = cfg.vision.img_size
    px = torch.randn(128, size, size, 3, device="cuda", generator=gen)
    kw = dict(dtype=torch.bfloat16, use_flash=True, gelu_approx=True)

    def encode(fuse_ln: bool) -> torch.Tensor:
        return model.visual_head(model.visual(px, fuse_ln=fuse_ln, **kw))

    with torch.inference_mode():
        with fa._launch_lock:
            fa.LAUNCHES = 0
        with lm._launch_lock:
            lm.LAUNCHES = 0
        # ---- the main path: the ViT forward under fuse_ln ----------------
        fused = encode(True)
        torch.cuda.synchronize()
        ln_launches, attn_launches = lm.LAUNCHES, fa.LAUNCHES
        # -----------------------------------------------------------------
        base = encode(False)
        depth = cfg.vision.depth
        if (ln_launches, attn_launches) != (2 * depth, depth):
            raise AssertionError(f"fuse_ln forward: {ln_launches} ln_matmul "
                                 f"and {attn_launches} attention launches, "
                                 f"want {2 * depth} and {depth}")
        f, r = fused.float(), base.float()
        if not torch.isfinite(f).all():
            raise AssertionError("fuse_ln forward: non-finite features")
        cos = torch.nn.functional.cosine_similarity(f, r, dim=-1)
        if not (cos >= 0.999).all():
            raise AssertionError(f"fuse_ln vs unfused: min cos "
                                 f"{cos.min().item()}")

        def held_forward(fault=None) -> tuple[float, float, int]:
            """A fused forward with every ``ln_matmul`` call held against
            its plain version on the same inputs (rtol 2⁻⁷, atol 1e-2);
            ``fault`` alters each kernel result first. Returns the
            features' min cosine against ``fuse_ln=False``, the largest
            per-call |Δ| and the first call out of tolerance (0: none)."""
            errs, first_bad = [], []

            def held(x, g, b, w, bias, eps=1e-6, out_dtype=torch.bfloat16):
                got = lm.ln_matmul(x, g, b, w, bias, eps, out_dtype)
                if fault is not None:
                    fault(got)
                ref = lm.ln_matmul_reference(x, g, b, w, bias, eps, out_dtype)
                errs.append((got.float() - ref.float()).abs().max().item())
                if not first_bad and not torch.allclose(
                        got.float(), ref.float(), atol=1e-2, rtol=2 ** -7):
                    first_bad.append(len(errs))
                return got

            vit.ln_matmul = held
            try:
                feats = encode(True).float()
            finally:
                vit.ln_matmul = lm.ln_matmul
            if len(errs) != 2 * depth:
                raise AssertionError(f"fuse_ln forward: {len(errs)} "
                                     f"ln_matmul calls held, want {2 * depth}")
            c = torch.nn.functional.cosine_similarity(feats, r, dim=-1)
            return c.min().item(), max(errs), (first_bad or [0])[0]

        _, call_err, bad_call = held_forward()
        if bad_call:
            raise AssertionError(f"fuse_ln forward: ln_matmul call {bad_call} "
                                 f"vs plain: max |Δ| {call_err}")
        # the gates' self-check: faults planted in the kernel's result must
        # fail one of them (a zero result fails both; one token off by one
        # in 8 columns only the per-call check)
        faults = {"zeros": lambda o: o.zero_(),
                  "one_token_8_columns_plus_1": lambda o: o[1, :8].add_(1)}
        planted = {}
        for name, fault in faults.items():
            fcos, ferr, fbad = held_forward(fault)
            caught = [gname for gname, hit in (("cosine", fcos < 0.999),
                                               ("per_call", fbad)) if hit]
            if not caught:
                raise AssertionError(f"fuse_ln gates: the planted fault "
                                     f"{name} passed both (min cos {fcos}, "
                                     f"per-call max |Δ| {ferr})")
            planted[name] = {"min_cos": fcos, "per_call_max_abs_err": ferr,
                             "first_call_out_of_tolerance": fbad,
                             "caught_by": caught}
        fused_ms = cuda_ms(lambda: model.visual(px, fuse_ln=True, **kw),
                           warmup=2, runs=10)
        unfused_ms = cuda_ms(lambda: model.visual(px, **kw), warmup=2,
                             runs=10)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.visual(px, fuse_ln=True, **kw)
            torch.cuda.synchronize()
    by_kernel = kernel_ms(torch, prof)
    total = sum(by_kernel.values())
    ln_ms = sum(v for kk, v in by_kernel.items()
                if "ln_matmul" in kk or "ln_stats" in kk)
    out = {"config": "ViT-L/16 224² bf16 B=128, random weights, LayerScale "
                     "0.1-0.5",
           "ln_matmul_launches": ln_launches,
           "attention_launches": attn_launches,
           "min_cos_vs_unfused": cos.min().item(),
           "max_abs_diff_vs_unfused": (f - r).abs().max().item(),
           "ln_matmul_calls_vs_plain_max_abs_err": call_err,
           "planted_faults": planted,
           "fused_forward_ms": fused_ms, "unfused_forward_ms": unfused_ms,
           "fused_profiled_device_ms": total if total else "not measured",
           "ln_matmul_share_of_fused": ln_ms / total if total
           else "not measured"}
    phase("fuse_ln_path", **out)
    del model
    torch.cuda.empty_cache()
    return out


def check_int8_kernels(torch, gen) -> tuple[dict, list]:
    """Phase 3b. Each int8 counterpart of a TPU kernel through the kernels
    against its plain version (fp32 stream, the JAX tests' tolerance; the
    attention sub-blocks, whose attention the tensor cores sum in another
    order, at the JAX package's tolerance between two routes through the
    same int8 weights, tests/test_quant.py:297-300, 324-327: atol = rtol =
    2e-2, cosine ≥ 0.9999 per row), the share of int8 codes that differ
    from the plain quantizer's on the tensors each one quantizes (for the
    attention sub-blocks also ``code_moves`` of their attention on the same
    slab), and kernel and plain times in bf16. Then the three CUDA kernels
    alone. Returns ({name: row}, primitive rows)."""
    from keep_tpu_torch.kernels import _kops, qblock, qmatmul, qmlp
    from keep_tpu_torch.ops.nn import LayerNorm, Mlp, QLinear
    from keep_tpu_torch.quant import quantize_kernel

    P = _kops.PLAIN
    dev = "cuda"

    def randn(*shape, std=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * std

    def qlin(k, n):
        q, s = quantize_kernel(randn(n, k, std=k ** -0.5))
        return QLinear.from_quantized(q, s, randn(n, std=0.02))

    def norm(d, eps):
        m = LayerNorm(d, eps, device=dev).requires_grad_(False)
        m.weight.copy_(1 + randn(d, std=0.1))
        m.bias.copy_(randn(d, std=0.05))
        return m

    def code_share(x2, *args, **kw):
        """Share of quant_rows' codes that differ from the plain
        version's on x2; a code may move by at most one."""
        q, _ = _kops.quant_rows(x2, *args, **kw)
        rq, _ = P.quant_rows(x2, *args, **kw)
        diff = (q.int() - rq.int()).abs()
        if diff.max().item() > 1:
            raise AssertionError(f"int8 codes off by {diff.max().item()}")
        return diff.count_nonzero().item(), diff.numel()

    # ---- the serving shapes ---------------------------------------------
    vb, vs, vd, vh, vf = 32, 197, 1024, 16, 4096  # ViT-L/16
    tb, ts, td, th, tf = 32, 256, 768, 12, 3072   # BERT-base
    vx = randn(vb, vs, vd)
    vn1, vn2 = norm(vd, 1e-6), norm(vd, 1e-6)
    vqkv, vproj, vfc1, vfc2 = (qlin(vd, 3 * vd), qlin(vd, vd), qlin(vd, vf),
                               qlin(vf, vd))
    tx = randn(tb, ts, td)
    lens = torch.randint(8, ts + 1, (tb,), device=dev, generator=gen)
    kb = (1.0 - (torch.arange(ts, device=dev)[None] < lens[:, None]).float()
          ) * -1e9
    tn1, tn2 = norm(td, 1e-12), norm(td, 1e-12)
    tqkv, tout, tfc1, tfc2 = (qlin(td, 3 * td), qlin(td, td), qlin(td, tf),
                              qlin(tf, td))
    tqkv.pre_scale = torch.exp(randn(td, std=0.5))
    tfc1.pre_scale = torch.exp(randn(td, std=0.5))
    px = randn(vb, 196, 768)  # normalised 16×16×3 patches
    pe = qlin(768, vd)
    feats = randn(vb, vd)  # the pooled, normed CLS features
    hd1 = qlin(vd, 768)

    def mlp_args(x, f1, f2):
        return (x, f1.weight_q, f1.weight_scale, f1.bias, f2.weight_q,
                f2.weight_scale, f2.bias)

    def hidden(x2, f1, **kw):
        """The plain fc1 + GELU output, the tensor the MLP re-quantizes."""
        xq, a = P.quant_rows(x2, **kw)
        return P.int8_gemm(xq, a, f1.weight_q, f1.weight_scale, f1.bias,
                           order=_kops.DEQUANT_PAIRED, gelu=True)

    def slab_of(x2, b, s, d, qkv, **kw):
        """The plain bf16 qkv slab the block's attention reads."""
        xq, a = P.quant_rows(x2, **kw)
        return P.int8_gemm(xq, a, qkv.weight_q, qkv.weight_scale, qkv.bias,
                           order=_kops.DEQUANT_PAIRED,
                           out_dtype=torch.bfloat16).view(b, s, 3 * d)

    def attn_out(x2, b, s, d, h, qkv, key_bias, **kw):
        """The plain fp32 attention output, the tensor the block
        re-quantizes."""
        return P.attention(slab_of(x2, b, s, d, qkv, **kw), key_bias,
                           num_heads=h, out_dtype=torch.float32
                           ).view(b * s, d)

    def attn_moves(x2, b, s, d, h, qkv, key_bias, **kw):
        """``code_moves`` of the block's attention on its plain slab: the
        kernel's fp32 output against the plain version's."""
        slab = slab_of(x2, b, s, d, qkv, **kw)
        akw = dict(num_heads=h, out_dtype=torch.float32)
        got = _kops.KERNELS.attention(slab, key_bias, **akw)
        return code_moves(torch, got, P.attention(slab, key_bias, **akw))

    vx2, tx2 = vx.view(-1, vd), tx.view(-1, td)
    cases = [
        ("quantized_attention_block", "vit_l16 B=32 S=197 D=1024 H=16",
         qblock.quantized_attention_block,
         qblock.quantized_attention_block_reference,
         lambda x: (x, vn1, vqkv, vproj), dict(num_heads=vh, eps=1e-6),
         vx, 2e-2, 2e-2,
         lambda: [code_share(vx2, vn1.weight, vn1.bias, 1e-6),
                  code_share(attn_out(vx2, vb, vs, vd, vh, vqkv, None,
                                      ln_scale=vn1.weight,
                                      ln_bias=vn1.bias, eps=1e-6))]),
        ("quantized_mlp_bsd", "vit_l16 B=32 S=197 D=1024 F=4096, LN + "
         "residual", qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
         lambda x: mlp_args(x, vfc1, vfc2),
         dict(ln_scale=vn2.weight, ln_bias=vn2.bias, eps=1e-6,
              residual=True),
         vx, 2e-4, 1e-4,
         lambda: [code_share(vx2, vn2.weight, vn2.bias, 1e-6),
                  code_share(hidden(vx2, vfc1, ln_scale=vn2.weight,
                                    ln_bias=vn2.bias, eps=1e-6))]),
        ("quantized_attention_block_postln", "bert_base B=32 S=256 D=768 "
         "H=12, padded key bias, pre_scale",
         qblock.quantized_attention_block_postln,
         qblock.quantized_attention_block_postln_reference,
         lambda x: (x, kb, tn1, tqkv, tout), dict(num_heads=th, eps=1e-12),
         tx, 2e-2, 2e-2,
         lambda: [code_share(tx2, pre_scale=tqkv.pre_scale),
                  code_share(attn_out(tx2, tb, ts, td, th, tqkv, kb,
                                      pre_scale=tqkv.pre_scale))]),
        ("quantized_mlp_bsd", "bert_base B=32 S=256 D=768 F=3072, post-LN + "
         "pre_scale", qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
         lambda x: mlp_args(x, tfc1, tfc2),
         dict(ln_scale=tn2.weight, ln_bias=tn2.bias, eps=1e-12, post_ln=True,
              pre_scale1=tfc1.pre_scale),
         tx, 2e-3, 2e-3,
         lambda: [code_share(tx2, pre_scale=tfc1.pre_scale),
                  code_share(hidden(tx2, tfc1, pre_scale=tfc1.pre_scale))]),
        ("quantized_matmul_bsd", "patch embed [32,196,768]x[768->1024]",
         qmatmul.quantized_matmul_bsd, qmatmul.quantized_matmul_bsd_reference,
         lambda x: (x, pe.weight_q, pe.weight_scale, pe.bias), {},
         px, 1e-4, 1e-4, lambda: [code_share(px.view(-1, 768))]),
        ("quantized_matmul", "visual head [32,1024]->768",
         qmatmul.quantized_matmul, qmatmul.quantized_matmul_reference,
         lambda x: (x, hd1.weight_q, hd1.weight_scale, hd1.bias), {},
         feats, 1e-4, 1e-4, lambda: [code_share(feats)]),
        ("quantized_mlp", "vit_l16 flat M=32*197 D=1024 F=4096",
         qmlp.quantized_mlp, qmlp.quantized_mlp_reference,
         lambda x: mlp_args(x, vfc1, vfc2), {}, vx2, 2e-4, 1e-4,
         lambda: [code_share(vx2), code_share(hidden(vx2, vfc1))]),
        ("quantized_mlp", "bert_base flat M=32*256 D=768 F=3072, pre_scale",
         qmlp.quantized_mlp, qmlp.quantized_mlp_reference,
         lambda x: mlp_args(x, tfc1, tfc2), dict(pre_scale1=tfc1.pre_scale),
         tx2, 2e-4, 1e-4,
         lambda: [code_share(tx2, pre_scale=tfc1.pre_scale),
                  code_share(hidden(tx2, tfc1, pre_scale=tfc1.pre_scale))]),
    ]
    # operations by type of each case (the int8 GEMMs; the attention's
    # score and p·v products in bf16), for its bound
    attn_ops = {"quantized_attention_block": 4 * vb * vh * vs * vs * 64,
                "quantized_attention_block_postln": 4 * tb * th * ts * ts * 64}
    attn_codes = {
        "quantized_attention_block": lambda: attn_moves(
            vx2, vb, vs, vd, vh, vqkv, None, ln_scale=vn1.weight,
            ln_bias=vn1.bias, eps=1e-6),
        "quantized_attention_block_postln": lambda: attn_moves(
            tx2, tb, ts, td, th, tqkv, kb, pre_scale=tqkv.pre_scale)}
    rows: dict[str, dict] = {}
    for name, shape, fn, ref, args, kw, x, atol, rtol, codes in cases:
        out_kw = {} if name.startswith("quantized_a") else {
            "out_dtype": x.dtype}
        got = fn(*args(x), **kw, **out_kw)
        torch.cuda.synchronize()
        want = ref(*args(x), **kw, **out_kw)
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(f"{name} ({shape}) vs plain: max |Δ| {err} "
                                 f"beyond atol {atol} / rtol {rtol}")
        extra = {}
        if name in attn_codes:
            cos = torch.nn.functional.cosine_similarity(
                got.view(-1, got.shape[-1]), want.view(-1, got.shape[-1]),
                dim=-1).min().item()
            if not cos >= 0.9999:
                raise AssertionError(f"{name} ({shape}) vs plain: min row "
                                     f"cosine {cos}")
            extra = {"min_row_cos": cos,
                     "attention_int8_codes_moved_share": attn_codes[name]()}
        changed, total = map(sum, zip(*codes()))
        x16 = x.bfloat16()
        out16 = {} if not out_kw else {"out_dtype": torch.bfloat16}
        ms = cuda_ms(lambda: fn(*args(x16), **kw, **out16))
        dev_ms = device_ms(torch, lambda: fn(*args(x16), **kw, **out16))
        plain_ms = cuda_ms(lambda: ref(*args(x16), **kw, **out16))
        weights = [a for a in args(x16)[1:]
                   if isinstance(a, torch.Tensor) and a.dtype == torch.int8]
        weights += [m.weight_q for m in args(x16)[1:]
                    if isinstance(m, QLinear)]
        int8_ops = sum(2 * x16.numel() // x16.shape[-1] * w.numel()
                       for w in weights)
        moved = nbytes(x16, fn(*args(x16), **kw, **out16), *weights)
        row = {"name": name, "shape": shape, "max_abs_err": err,
               "atol": atol, "rtol": rtol,
               "int8_codes_differing": changed, "int8_codes": total,
               "int8_code_diff_share": changed / total,
               "ms_bf16": ms, "device_ms_bf16": dev_ms,
               "plain_ms_bf16": plain_ms, **extra}
        row["bound_ms_bf16"], row["bound_by"] = bound(
            {"int8": int8_ops, "bf16": attn_ops.get(name, 0)}, moved)
        phase("int8_kernel", **row)
        rows.setdefault(name, {"shapes": []})["shapes"].append(row)

    # ---- the flat pair: bit for bit against the bsd form, then its path ----
    for x, f1, f2, ps in ((vx2, vfc1, vfc2, None),
                          (tx2, tfc1, tfc2, tfc1.pre_scale)):
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            flat = qmlp.quantized_mlp(*mlp_args(xd, f1, f2), out_dtype=dtype,
                                      pre_scale1=ps)
            bsd = qmlp.quantized_mlp_bsd(*mlp_args(xd.view(32, -1, x.shape[1]),
                                                   f1, f2), out_dtype=dtype,
                                         pre_scale1=ps)
            if not torch.equal(flat, bsd.view_as(flat)):
                raise AssertionError(f"flat int8 MLP differs from the bsd "
                                     f"form on {tuple(x.shape)} {dtype}")
    mlp = Mlp(vd, vf, device=dev)
    mlp.fc1, mlp.fc2 = vfc1, vfc2
    x16 = vx2.bfloat16()
    with _kops._launch_lock:
        _kops.LAUNCHES.clear()
    # ---- the main path: the int8 Mlp on a flat input --------------------------
    with torch.inference_mode():
        out = mlp(x16, gelu_approx=True)
    torch.cuda.synchronize()
    flat_launches = dict(_kops.LAUNCHES)
    # ---------------------------------------------------------------------------
    want = {"quantized_mlp": 1, "quant_rows": 2, "int8_gemm": 2}
    if flat_launches != want:
        raise AssertionError(f"Mlp.forward on [M, D]: launches "
                             f"{flat_launches}, want {want}")
    if out.shape != x16.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"Mlp.forward on [M, D]: {tuple(out.shape)}")
    phase("int8_flat_mlp_path", entry="ops.nn.Mlp.forward(x [M, D], "
          "gelu_approx=True) with int8 fc1, fc2", shape=list(x16.shape),
          launches=flat_launches, equals_bsd_bitwise=True)
    rows["quantized_mlp"]["launches"] = flat_launches["quantized_mlp"]

    return rows, check_int8_primitives(torch, gen, (vqkv, vproj, vfc1, vfc2),
                                       vn1, tn1)


def check_int8_primitives(torch, gen, vit_linears, vit_norm, bert_norm
                          ) -> list[dict]:
    """Phase 3b, second part: the three CUDA kernels alone at the shapes #4
    and #6 give them in a ViT-L dispatch at B=32 and B=128 (M = B·197):
    ``int8_gemm`` at the qkv, proj, fc1 and fc2 shapes with their
    epilogues, beside cuBLAS's int8 GEMM (``torch._int_mm``) on the same
    operands; ``quant_rows`` on the LN'd bf16 stream, the fp32 attention
    output and the fp32 MLP hidden; ``ln_rows`` on BERT's post-LN rows.
    Each must give its plain version's bits. Times: the profiler's kernel
    time a call (``device_ms``, host gaps left out) and CUDA events around
    one call (``ms``, the wrapper's host time included where it is the
    longer), each beside its bound."""
    from keep_tpu_torch.kernels import _kops

    P = _kops.PLAIN
    dev = "cuda"
    qkv, proj, fc1, fc2 = vit_linears
    gemms = (("qkv", qkv, dict(out_dtype=torch.bfloat16), False),
             ("proj", proj, dict(out_dtype=torch.bfloat16), True),
             ("fc1", fc1, dict(gelu=True, out_dtype=torch.float32), False),
             ("fc2", fc2, dict(out_dtype=torch.bfloat16), True))
    prims = []

    def report(kind, name, got, want, fn, ref, ops, moved, **extra):
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"{kind} {name}: not the plain version's "
                                 f"bits")
        row = {"kernel": kind, "shape": name, "bitwise_equal": same,
               "device_ms": device_ms(torch, fn), "ms": cuda_ms(fn),
               "plain_ms": cuda_ms(ref), "bytes": moved, **extra}
        row["bound_ms"], row["bound_by"] = bound(ops, moved)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        if ops:
            row["tops"] = ops["int8"] / row["device_ms"] / 1e9
        phase("int8_primitive", **row)
        prims.append(row)

    for b in (32, 128):
        m = b * 197
        for gname, lin, kw, with_res in gemms:
            n, k = lin.weight_q.shape
            xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                               dtype=torch.int8)
            a = torch.rand(m, device=dev, generator=gen) * 1e-2
            res = (torch.randn(m, n, device=dev, generator=gen).bfloat16()
                   if with_res else None)
            args = (xq, a, lin.weight_q, lin.weight_scale, lin.bias)
            fn = lambda: _kops.int8_gemm(*args, order=1, residual=res, **kw)
            ref = lambda: P.int8_gemm(*args, order=1, residual=res, **kw)
            out = fn()
            torch.cuda.synchronize()
            lib = device_ms(torch, lambda: torch._int_mm(xq,
                                                         lin.weight_q.t()))
            ops = 2 * m * k * n
            report("int8_gemm", f"{gname} [{m},{k}]x[{k}->{n}] {kw}, "
                   f"residual {with_res}", [out], [ref()], fn, ref,
                   {"int8": ops}, nbytes(xq, a, lin.weight_q, out, res)
                   + 8 * n, int_mm_device_ms=lib,
                   int_mm_tops=ops / lib / 1e9)
        xs = (torch.randn(m, 1024, device=dev, generator=gen) * 3)
        for rname, x, ln in (("LN'd bf16 stream", xs.bfloat16(), True),
                             ("fp32 attention output", xs, False),
                             ("fp32 MLP hidden",
                              torch.randn(m, 4096, device=dev, generator=gen),
                              False)):
            lnw = (vit_norm.weight, vit_norm.bias) if ln else (None, None)
            fn = lambda: _kops.quant_rows(x, *lnw)
            ref = lambda: P.quant_rows(x, *lnw)
            q, s = fn()
            report("quant_rows", f"{rname} [{m},{x.shape[1]}]", [q, s],
                   list(ref()), fn, ref, {}, nbytes(x, q, s))
        t2 = torch.randn(b * 256, 768, device=dev, generator=gen) * 4 + 1
        fn = lambda: _kops.ln_rows(t2, bert_norm.weight, bert_norm.bias,
                                   1e-12, torch.bfloat16)
        ref = lambda: P.ln_rows(t2, bert_norm.weight, bert_norm.bias, 1e-12,
                                torch.bfloat16)
        out = fn()
        report("ln_rows", f"BERT post-LN [{b * 256},768] fp32 -> bf16",
               [out], [ref()], fn, ref, {}, nbytes(t2, out))
    return prims


def check_bwd_kernel(fa, torch, gen) -> list[dict]:
    """Phase 8: the backward kernel against its plain version at the
    training shapes, B=32 and B=128."""
    shapes = ATTENTION_SHAPES
    rows = []
    for name, b, s, h, padded in shapes:
        qkv32 = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen)
        do32 = torch.randn(b, s, h * 64, device="cuda", generator=gen)
        valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
        for dtype in (torch.float32, torch.bfloat16):
            qkv, do = qkv32.to(dtype), do32.to(dtype)
            got = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
            torch.cuda.synchronize()
            ref = fa.attention_qkv_slab_bwd_reference(qkv, kb, do, h)
            g, r = got.float()[valid], ref.float()[valid]
            err = (g - r).abs().max().item()
            limit = 1e-2 * r.abs().max().item()
            if dtype == torch.float32:
                if not torch.allclose(got, ref, atol=2e-4, rtol=1e-4):
                    raise AssertionError(f"{name} fp32 backward vs plain: "
                                         f"max |Δ| {err}")
            elif not err <= limit:
                raise AssertionError(f"{name} bf16 backward vs plain: max "
                                     f"|Δ| {err} > {limit}")
            ms = cuda_ms(lambda: fa.attention_qkv_slab_bwd(qkv, kb, do, h))
            plain_ms = cuda_ms(lambda: fa.attention_qkv_slab_bwd_reference(
                qkv, kb, do, h))
            # the library's attention backward on the same values: SDPA's
            # gradient through autograd, the graph kept (retain_graph) so
            # that only the backward is timed
            q, k, v = (t.detach().requires_grad_() for t in
                       qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4))
            mask = kb[:, None, None, :].to(dtype) if padded else None
            out = torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)
            do4 = do.view(b, s, h, 64).transpose(1, 2)
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                out, (q, k, v), do4, retain_graph=True)
            row = {"shape": name, "B": b, "S": s, "H": h,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "max_abs_plain": r.abs().max().item(),
                   "ms": ms, "plain_ms": plain_ms,
                   "library_ms": cuda_ms(sdpa_bwd),
                   "library_kernel": sdpa_backend(torch, sdpa_bwd)}
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, h, qkv.element_size(), True, backward=True)
            del out
            phase("attention_bwd", **row)
            rows.append(row)
    return rows


TRAIN_NODES = {
    "DOID:14566": {"name": "disease of cellular proliferation", "parent": []},
    "DOID:162": {"name": "cancer", "parent": ["DOID:14566"]},
    "DOID:1324": {"name": "lung cancer", "parent": ["DOID:162"]},
    "DOID:3910": {"name": "lung adenocarcinoma", "parent": ["DOID:1324"]},
    "DOID:3908": {"name": "lung squamous cell carcinoma",
                  "parent": ["DOID:1324"]},
    "DOID:1909": {"name": "melanoma", "parent": ["DOID:162"]},
    "DOID:4450": {"name": "renal cell carcinoma", "parent": ["DOID:162"]},
}
TRAIN_CAPTIONS = ["an h&e image of lung adeno ##carcinoma.",
                  "squamous cell carcinoma of the lung.",
                  "melanoma of the skin.", "clear cell renal tumor.",
                  "normal lung tissue.", "breast invasive carcinoma."]


def write_train_data(d: str, n_groups: int, image_size: int,
                     n_images: int = 32) -> tuple[str, str, str, str]:
    """PNG tiles larger than the model size (so the random crop moves), a
    semantic-groups JSON, a DO-graph JSON and a vocab, from a numpy seed.
    Returns (groups, images dir, graph, vocab) paths."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = os.path.join(d, "images")
    os.makedirs(img_dir)
    names = []
    for i in range(n_images):
        names.append(f"tile{i}.png")
        Image.fromarray(rng.integers(0, 256, (image_size + 32,
                                              image_size + 32, 3),
                                     dtype=np.uint8)).save(
            os.path.join(img_dir, names[-1]))
    labels = list(TRAIN_NODES)[2:] + [None]
    groups = {}
    for g in range(n_groups):
        lab = labels[g % len(labels)]
        groups[f"group{g}"] = {
            "captions": [TRAIN_CAPTIONS[(g + k) % len(TRAIN_CAPTIONS)]
                         for k in range(2)],
            "images": [names[(3 * g + k) % n_images] for k in range(3)],
            "labels": {lab: 1} if lab else {}}
    paths = tuple(os.path.join(d, n) for n in ("groups.json", "kg.json",
                                                "vocab.txt"))
    with open(paths[0], "w") as f:
        json.dump(groups, f)
    with open(paths[1], "w") as f:
        json.dump(TRAIN_NODES, f)
    words = sorted({w for n in TRAIN_NODES.values() for w in
                    n["name"].split()} | {w for c in TRAIN_CAPTIONS for w in
                                          c.replace(".", " .").split()})
    with open(paths[2], "w") as f:
        f.write("\n".join(VOCAB + [w for w in words if w not in VOCAB])
                + "\n")
    return paths[0], img_dir, paths[1], paths[2]


def train_config(d: str, keep: dict | None = None, batch_size: int = 128,
                 caption_num: int = 32, steps_per_epoch: int = 4) -> dict:
    """configs/keep_train.yml's values (no pretrained towers), 2 epochs,
    data written by ``write_train_data``."""
    keep = keep or {"projection_dim": 768}
    image_size = keep.get("vision", {}).get("img_size", 224)
    n_groups = steps_per_epoch * batch_size // (batch_size // caption_num)
    groups, img_dir, kg, vocab = write_train_data(d, n_groups, image_size)
    return {
        "seed": 0,
        "dataset": {"type": "json", "train_data": groups, "img_dir": img_dir,
                    "knowledge_file": kg, "label_cap": "both",
                    "vocab_path": vocab},
        "dataloader": {"batch_size": batch_size, "caption_num": caption_num,
                       "text_drop": True},
        "solver": {"epochs": 2, "lr": 1.0e-5, "weight_decay": 0.2,
                   "warmup": 200, "lr_scheduler": "cosine",
                   "grad_clip_norm": 1.0, "freeze_visual_epochs": 1,
                   "freeze_text_epochs": 1},
        "model": {"precision": "amp_bf16", "type": "hierarchy_metric",
                  "loss_subtype": "lhp-hn", "logit_scale": 0.04,
                  "use_flash": True},
        "save": {"output_dir": os.path.join(d, "logs"),
                 "experiment_name": "smoke", "save_frequency": 1},
        "keep": keep,
    }


def drive_train(torch, fa, d: str, raw: dict, blocks: int,
                steps_per_epoch: int, device: str = "cuda") -> dict:
    """Phase 9: the training entry point on ``raw`` (``train_config`` with
    ``steps_per_epoch``). Each train step is timed between device
    synchronisations and its kernel launches counted; on the card the last
    step is traced with torch.profiler (and left out of the timing).
    ``blocks`` is the towers' block count."""
    import ast

    from keep_tpu_torch.train import checkpoint as ckpt
    from keep_tpu_torch.train import main as tmain
    from keep_tpu_torch.train.config import TrainRunConfig

    path = os.path.join(d, "train.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    steps: list[dict] = []
    traced: dict[str, float] = {}
    make_step = tmain.make_train_step

    def timed_make_train_step(*args, static_frozen=None, **kw):
        inner = make_step(*args, static_frozen=static_frozen, **kw)

        def step(state, batch, frozen=None):
            if device == "cuda":
                torch.cuda.synchronize()
            f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
            t0 = time.perf_counter()
            if device == "cuda" and len(steps) == 2 * steps_per_epoch - 1:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, metrics = inner(state, batch, frozen)
                    loss = float(metrics["loss"])
                traced.update(kernel_ms(torch, prof))
            else:
                state, metrics = inner(state, batch, frozen)
                loss = float(metrics["loss"])  # waits for the step
            steps.append({"frozen": static_frozen is not None,
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "loss": loss, "fwd_launches": fa.LAUNCHES - f0,
                          "bwd_launches": fa.BWD_LAUNCHES - b0})
            return state, metrics

        return step

    tmain.make_train_step = timed_make_train_step
    try:
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with fa._launch_lock:
            fa.LAUNCHES = fa.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        # ---- the main path: the training CLI --------------------------------
        result = tmain.main(["--config", path, "--device", device])
        fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
        # --------------------------------------------------------------------
        wall_s = time.perf_counter() - t0
    finally:
        tmain.make_train_step = make_step
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    out_dir = os.path.join(raw["save"]["output_dir"], "smoke")
    per_epoch = steps_per_epoch
    if [s["frozen"] for s in steps] != [True] * per_epoch + [False] * per_epoch:
        raise AssertionError(f"steps: {[s['frozen'] for s in steps]}")
    for i, s in enumerate(steps):
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"step {i}: loss {s['loss']}")
        want = (blocks, 0) if s["frozen"] else (2 * blocks, blocks)
        if (s["fwd_launches"], s["bwd_launches"]) != want:
            raise AssertionError(
                f"step {i}: forward / backward launches "
                f"{s['fwd_launches']} / {s['bwd_launches']}, want {want}")
    if bwd != per_epoch * blocks or fwd != per_epoch * 3 * blocks:
        raise AssertionError(f"launches {fwd} / {bwd}")
    with open(os.path.join(out_dir, "checkpoints", "results.jsonl")) as f:
        losses = [json.loads(ln)["train_loss"] for ln in f]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"epoch losses {losses}")
    with open(os.path.join(out_dir, "out.log")) as f:
        log = f.read()
    checks = {}
    for epoch in (0, 1):
        line = log.split(f"epoch {epoch} freeze check: ")[1].splitlines()[0]
        checks[epoch] = ast.literal_eval(line)
    if (checks[0]["visual"], checks[0]["text"]) != ("frozen", "frozen"):
        raise AssertionError(f"freeze checks {checks}")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    restored = ckpt.restore(ckpt_dir)
    if ckpt.list_epochs(ckpt_dir) != [0, 1] or \
            restored["step"] != len(steps) or restored["epoch"] != 1 or \
            result["epoch"] != 1:
        raise AssertionError(f"checkpoints {ckpt.list_epochs(ckpt_dir)}, "
                             f"step {restored['step']}")
    # The norm check above cannot see updates of lr ~1e-7 (warmup), so the
    # leaves are also compared bit for bit: the seed's initial weights
    # against epoch 0's checkpoint (towers equal, visual head moved), and
    # epoch 0's against epoch 1's (most tower leaves moved).
    init = tmain.build_model(TrainRunConfig.from_dict(
        json.loads(json.dumps(raw))), device).state_dict()
    epoch0 = ckpt.restore(ckpt_dir, epoch=0)["params"]
    moved: dict[str, list[int]] = {}
    for n, t in init.items():
        top = n.split(".", 1)[0]
        counts = moved.setdefault(top, [0, 0, 0])
        counts[0] += not torch.equal(t.cpu(), epoch0[n])
        counts[1] += not torch.equal(epoch0[n], restored["params"][n])
        counts[2] += 1
    moved_share = {k: {"epoch0": c[0] / c[2], "epoch1": c[1] / c[2]}
                   for k, c in moved.items()}
    # (a LayerNorm gain behind a LayerScale of 1e-5 gets gradients far below
    # Adam's eps, and may not move by one ulp in three steps of warmup)
    for tower in ("visual", "text"):
        if moved[tower][0] or moved[tower][1] < moved[tower][2] / 2:
            raise AssertionError(f"{tower}: leaves moved {moved_share}")
    if not moved["visual_head"][0]:
        raise AssertionError(f"the visual head did not train in epoch 0: "
                             f"{moved_share}")
    # the first step of a phase carries its one-off setup; the traced step
    # carries the profiler's
    open_ms = [s["ms"] for s in steps if not s["frozen"]][1:]
    if traced:
        open_ms = open_ms[:-1]
    frozen_ms = [s["ms"] for s in steps if s["frozen"]][1:]
    from scripts.torch_dispatch_profile import family

    families: dict[str, float] = {}
    for k, v in traced.items():
        fam = next((f for f in ("slab_attention_bwd", "slab_attention")
                    if f in k), family(k))
        families[fam] = families.get(fam, 0.0) + v
    busy = sum(traced.values())
    batch = raw["dataloader"]["batch_size"]
    out = {"card": card() if device == "cuda" else "cpu",
           "epoch_losses": losses, "step_losses": [s["loss"] for s in steps],
           "freeze_checks": checks, "leaves_moved_share": moved_share,
           "fwd_launches": fwd,
           "bwd_launches": bwd, "checkpoint_step": restored["step"],
           "ms_per_unfrozen_step": statistics.median(open_ms),
           "ms_per_frozen_step": statistics.median(frozen_ms),
           "step_ms": [s["ms"] for s in steps],
           "samples_per_s_unfrozen": batch / statistics.median(open_ms) * 1e3,
           "peak_memory_gb": peak / 1e9, "wall_s": wall_s,
           "traced_unfrozen_step": {
               "step_ms": steps[-1]["ms"] if traced else "not measured",
               "device_busy_ms": busy if traced else "not measured",
               "ms_by_family": families,
               "top_kernels_ms": sorted(traced.items(),
                                        key=lambda kv: -kv[1])[:12]}}
    phase("train", **out)
    return out


def write_model(d: str, torch, cfg, device: str = "cuda",
                keep_init: bool = False) -> None:
    from keep_tpu_torch.compat.torch_loader import random_keep_state_dict

    gen = torch.Generator(device=device).manual_seed(0)
    sd = random_keep_state_dict(cfg, gen, device=device, keep_init=keep_init)
    torch.save({k: v.cpu() for k, v in sd.items()},
               os.path.join(d, "pytorch_model.bin"))
    t = cfg.text
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "vision_config": dataclasses.asdict(cfg.vision),
            "text_config": {
                "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
                "num_hidden_layers": t.num_hidden_layers,
                "num_attention_heads": t.num_attention_heads,
                "intermediate_size": t.intermediate_size,
                "max_position_embeddings": t.max_position_embeddings,
                "type_vocab_size": t.type_vocab_size,
                "layer_norm_eps": t.ln_eps, "pad_token_id": t.pad_token_id},
            "projection_dim": cfg.projection_dim,
            "max_text_length": cfg.max_text_length,
        }, f)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")


def smoke_images(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The tiles the server phases send: 8 model-size ones and one 260×300
    image that takes the host-side resize."""
    rng = np.random.default_rng(0)
    size = cfg.vision.img_size
    tiles = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    odd = rng.integers(0, 256, (1, 260, 300, 3), dtype=np.uint8)
    return tiles, odd


def served_features(torch, serve, cfg, d: str, quantize: bool,
                    device: str = "cuda", plain_blocks: bool = False) -> dict:
    """The features a server built as ``build_server`` builds it (bf16,
    fused attention; ``quantize`` as ``--int8``) gives for the server
    phases' inputs, through its core in this process, without HTTP. With
    ``plain_blocks`` the int8 blocks run their plain versions on the
    card."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

    model = KEEPModel.from_pretrained(d, dtype=torch.bfloat16, use_flash=True,
                                      device=device, quantize=quantize)
    core = serve.InferenceServer(
        model, WordPieceTokenizer.from_pretrained(d),
        max_length=min(cfg.max_text_length,
                       cfg.text.max_position_embeddings),
        image_size=cfg.vision.img_size)
    tiles, odd = smoke_images(cfg)
    try:
        with (plain_int8_blocks() if plain_blocks
              else contextlib.nullcontext()):
            return {"text": core.encode_text(PROMPTS),
                    "image": core.encode_image(tiles),
                    "image_260x300": core.encode_image(odd)}
    finally:
        core.stop()


@contextlib.contextmanager
def plain_int8_blocks():
    """The int8 blocks' plain versions on the card: what ``_kops.ops_for``
    hands a CUDA tensor for the duration."""
    from keep_tpu_torch.kernels import _kops

    kernels = _kops.KERNELS
    _kops.KERNELS = _kops.PLAIN
    try:
        yield
    finally:
        _kops.KERNELS = kernels


def int8_route(feats: np.ndarray, ref: np.ndarray) -> dict:
    """Two int8 routes through the same weights (the kernels against their
    plain versions) in the JAX package's gate's forms: the mean of the
    per-row cosines (image rows, tests/test_quant.py:300) and the cosine of
    the features taken whole (text, :327), with the per-row minimum."""
    rows = cosine_rows(feats, ref)
    a, b = feats.ravel(), ref.ravel()
    return {"mean_row_cos": float(rows.mean()),
            "whole_cos": float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)),
            "min_row_cos": float(rows.min()), "rows": int(len(rows))}


def http(port: int, path: str, body: bytes | None = None,
         content_type: str = "application/json") -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": content_type} if body is not None else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def check_features(name: str, x: np.ndarray, n: int, width: int) -> None:
    if x.shape != (n, width):
        raise AssertionError(f"{name}: shape {x.shape}, want {(n, width)}")
    if not np.isfinite(x).all():
        raise AssertionError(f"{name}: non-finite features")
    norms = np.linalg.norm(x, axis=-1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        raise AssertionError(f"{name}: norms {norms}")


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def drive_server(torch, fa, serve, cfg, d: str, device: str = "cuda",
                 bf16_features: dict | None = None,
                 plain_int8_features: dict | None = None):
    """Phase 4, or with ``bf16_features`` (phase 4's served features) phase
    6: the int8 server, held to those and to ``plain_int8_features`` (the
    same int8 model with its blocks' plain versions). Returns the phase's
    result, the running server core (the caller stops it) and the served
    features."""
    from keep_tpu_torch.kernels import _kops
    from keep_tpu_torch.models.keep import KEEPModel

    int8 = bf16_features is not None
    t0 = time.perf_counter()
    core, httpd = serve.build_server(["--model-dir", d, "--port", "0",
                                      "--device", device]
                                     + (["--int8"] if int8 else []))
    setup_s = time.perf_counter() - t0
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        tiles, odd = smoke_images(cfg)
        sim_imgs = tiles[:2]

        stats0 = core.stats()
        with fa._launch_lock:
            fa.LAUNCHES = 0
        with _kops._launch_lock:
            _kops.LAUNCHES.clear()
        # ---- the main path, through the HTTP front end -------------------
        txt = np.asarray(json.loads(http(port, "/encode_text", json.dumps(
            {"texts": PROMPTS}).encode()))["embeddings"], np.float32)
        buf = io.BytesIO()
        np.save(buf, tiles)
        img = np.load(io.BytesIO(http(port, "/encode_image_npy",
                                      buf.getvalue(),
                                      "application/octet-stream")))
        sim = np.asarray(json.loads(http(port, "/similarity", json.dumps(
            {"texts": PROMPTS[:2], "images": sim_imgs.tolist()}).encode()))
            ["logits"], np.float32)
        odd_feat = np.asarray(json.loads(http(port, "/encode_image", json.dumps(
            {"images": odd.tolist()}).encode()))["embeddings"], np.float32)
        stats = json.loads(http(port, "/stats"))
        launches = fa.LAUNCHES
        int8_launches = dict(_kops.LAUNCHES)
        # -----------------------------------------------------------------
        check_features("encode_text", txt, 3, cfg.text.hidden_size)
        check_features("encode_image_npy", img, 8, cfg.projection_dim)
        check_features("encode_image (260x300)", odd_feat, 1,
                       cfg.projection_dim)
        if sim.shape != (2, 2) or not np.isfinite(sim).all():
            raise AssertionError(f"similarity: {sim.shape}")
        # every block of every dispatch of the run went through the kernel
        img_disp = stats["image"]["dispatches"] - stats0["image"]["dispatches"]
        txt_disp = stats["text"]["dispatches"] - stats0["text"]["dispatches"]
        want = (img_disp * cfg.vision.depth
                + txt_disp * cfg.text.num_hidden_layers)
        if img_disp < 3 or txt_disp < 2 or launches < want:
            raise AssertionError(
                f"kernel launches {launches} < {want} for {img_disp} image "
                f"and {txt_disp} text dispatches")
        feats = {"text": txt, "image": img, "image_260x300": odd_feat}
        sim_err = float(np.abs(sim - img[:2] @ txt[:2].T).max())
        if sim_err > 1e-2:
            raise AssertionError(f"similarity vs features: {sim_err}")
        if int8:
            return (check_int8_server(cfg, feats, bf16_features,
                                      plain_int8_features, int8_launches,
                                      img_disp, txt_disp, launches, setup_s,
                                      sim_err),
                    core, feats)

        # the same weights without the kernel (plain attention), same bf16
        plain = KEEPModel(cfg, dtype=torch.bfloat16, use_flash=False,
                          device=device)
        plain.load_state_dict(core.model.state_dict())
        ref_core = serve.InferenceServer(plain, core.tokenizer,
                                         max_length=core.max_length,
                                         image_size=core.image_size)
        try:
            ref_txt = ref_core.encode_text(PROMPTS)
            ref_img = ref_core.encode_image(tiles)
            ref_odd = ref_core.encode_image(odd)
        finally:
            ref_core.stop()
        cos = {"text": cosine_rows(txt, ref_txt),
               "image": cosine_rows(img, ref_img),
               "image_260x300": cosine_rows(odd_feat, ref_odd)}
        for k, c in cos.items():
            if not (c >= 0.999).all():
                raise AssertionError(f"{k}: cosine vs plain attention {c}")
        result = {"setup_s": setup_s, "launches": launches,
                  "image_dispatches": img_disp, "text_dispatches": txt_disp,
                  "min_cos_vs_plain": {k: float(c.min()) for k, c in
                                       cos.items()},
                  "similarity_max_err": sim_err}
        phase("server", **result)
        return result, core, feats
    except BaseException:
        core.stop()
        raise
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def check_int8_server(cfg, feats, bf16_features, plain_features, launches,
                      img_disp, txt_disp, attention_launches, setup_s,
                      sim_err) -> dict:
    """Phase 6's checks: the int8 features against the bf16 server's
    (cosine ≥ 0.999 per row) and against the same int8 model with its
    blocks' plain versions at the JAX package's gate between two int8
    routes, in its form: > 0.9999 for the image rows' mean cosine
    (tests/test_quant.py:300) and for the cosine of the text features taken
    whole (:327); and every block of every dispatch through its tower's
    int8 kernels. The per-row cosines are reported: at full width two int8
    routes through the same weights differ by up to ~2e-4 per row on the
    text tower (the JAX package's own int8 BERT-base against the port's
    plain one, tests/test_torch_quant.py
    ``test_int8_bert_base_routes_at_full_width``), so a per-row gate there
    would fail the reference itself."""
    cos = {k: cosine_rows(v, bf16_features[k]) for k, v in feats.items()}
    for k, c in cos.items():
        if not (c >= 0.999).all():
            raise AssertionError(f"{k}: int8 cosine vs the bf16 server {c}")
    cos_plain = {k: cosine_rows(v, plain_features[k])
                 for k, v in feats.items()}
    text, ref_text = feats["text"].ravel(), plain_features["text"].ravel()
    route_gate = {"image_mean": float(np.concatenate(
                      [cos_plain["image"], cos_plain["image_260x300"]]).mean()),
                  "text_whole": float(text @ ref_text / np.linalg.norm(text)
                                      / np.linalg.norm(ref_text))}
    if not all(v > 0.9999 for v in route_gate.values()):
        raise AssertionError(f"int8 features vs the int8 model's plain "
                             f"blocks: {route_gate}")
    vit_l, bert_l = cfg.vision.depth, cfg.text.num_hidden_layers
    want = {"quantized_attention_block": img_disp * vit_l,
            "quantized_attention_block_postln": txt_disp * bert_l,
            "quantized_mlp_bsd": img_disp * vit_l + txt_disp * bert_l,
            "quantized_matmul_bsd": img_disp,   # the patch embed
            "quantized_matmul": 2 * img_disp}   # the visual head's linears
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(
                f"{name}: {launches.get(name, 0)} launches, want {n} for "
                f"{img_disp} image and {txt_disp} text dispatches")
    if attention_launches < img_disp * vit_l + txt_disp * bert_l:
        raise AssertionError(f"attention launches {attention_launches}")
    result = {"setup_s": setup_s, "launches": launches,
              "attention_launches": attention_launches,
              "image_dispatches": img_disp, "text_dispatches": txt_disp,
              "min_cos_vs_bf16_server": {k: float(c.min())
                                         for k, c in cos.items()},
              "cos_vs_int8_plain_blocks": route_gate,
              "min_row_cos_vs_int8_plain_blocks": {
                  k: float(c.min()) for k, c in cos_plain.items()},
              "similarity_max_err": sim_err}
    phase("server_int8", **result)
    return result


# ---- 10.–12. the zero-shot WSI sweep ----------------------------------------

# The WSI phases' sizes: a flat 16,384² slide (~3,300 tissue tiles of 256²;
# cut_tiles holds an int16 copy and an int64 integral image of it on the
# host, ~1.6 and 2.1 GB), the reference's screened prompt pool (1,386
# prompts, keep_tpu/zeroshot/classifier.py:414, 461) and a slide's long
# patch axis (100,000 patches on a 317 × 317 grid).
WSI_SLIDE_PX = 16384
WSI_BATCH = 256
WSI_PROMPTS = 1386
WSI_PATCHES = 100_000
WSI_GRID = 317
WSI_TOPN = 50
# segmentation's level-0 mask is drawn at 32 pixels a patch instead of 256
# (10,144² instead of 81,152²: the integral image of the full-size mask
# would take 53 GB of host memory); the patches' grid is the same
WSI_SEG_PATCH = 32
# a score this close to a decision threshold may land on either side of it
# under another summation order: such patches are counted and reported
NEAR = 1e-5


def wsi_slide(px: int, seed: int = 0) -> np.ndarray:
    """A flat synthetic H&E slide [px, px, 3] uint8 from ``seed``: a tissue
    disc (pink-purple and saturated, its colour shifted per 64-pixel block,
    with per-pixel noise) on a bright unsaturated background that
    ``io.tiles.tissue_mask`` rejects. One 1,024-row band of noise serves
    every band."""
    rng = np.random.default_rng(seed)
    nb = -(-px // 64)
    shade = rng.integers(-30, 31, (nb, nb, 3)).astype(np.int16)
    tissue = np.array([160, 80, 140], np.int16)
    band = min(px, 1024)
    noise = rng.integers(0, 48, (band, px, 3), dtype=np.uint8)
    c, r2 = (px - 1) / 2, (0.5 * px) ** 2
    xs = np.arange(px)
    img = np.empty((px, px, 3), np.uint8)
    for y0 in range(0, px, band):
        ys = np.arange(y0, min(px, y0 + band))
        nz = noise[: len(ys)]
        inside = (ys[:, None] - c) ** 2 + (xs[None] - c) ** 2 <= r2
        color = tissue + shade[ys // 64][:, xs // 64] + nz
        img[ys[0]: ys[-1] + 1] = np.where(inside[..., None], color,
                                          236 + nz // 16)
    return img


# VOCAB's words by the class whose names they make: shared, then Normal's
# and Tumor's own
WSI_WORDS = {"shared": "an h & e image of breast lung skin kidney cell . , -",
             "Normal": "normal tissue",
             "Tumor": "invasive carcinoma adeno squamous melanoma clear "
                      "renal tumor"}


def wsi_prompts(n: int, seed: int = 0) -> dict:
    """``n`` two-class prompt dicts in the reference's JSON shape, their
    class names drawn with ``seed`` from ``VOCAB``'s words, half the draws
    from the words of the class's own (``WSI_WORDS``): 3–38 words, so 5–40
    tokens with [CLS] and [SEP] (mean ~15) in a 256-token contract."""
    rng = np.random.default_rng(seed)
    shared = WSI_WORDS["shared"].split()

    def name(cls: str) -> str:
        own = WSI_WORDS[cls].split()
        k = int(np.clip(round(rng.normal(13, 6)), 3, 38))
        p = [0.5 / len(shared)] * len(shared) + [0.5 / len(own)] * len(own)
        return " ".join(rng.choice(shared + own, k, p=p))

    return {str(i): {"classnames": {c: name(c) for c in ("Normal", "Tumor")},
                     "templates": "CLASSNAME"} for i in range(n)}


def wsi_patches(stack: np.ndarray, n: int, grid: int, seed: int = 0):
    """Seeded features [n, D] and (x, y) coords of a slide's patches on a
    ``grid`` × ``grid`` lattice (holes, and 100 duplicated coordinates that
    the first-seen rule drops): inside a tumour disc the features lean
    towards the direction that tells the stack's Tumor columns from its
    Normal ones, outside away from it, at spread lengths with noise, so
    that most probabilities lie away from 0.5 and the 2×2 refinement moves
    them. Returns (features, coords, inside the disc)."""
    rng = np.random.default_rng(seed)
    dup = 100
    cells = rng.permutation(grid * grid)[: n - dup]
    cells = np.concatenate([cells, cells[:dup]])
    r, c = cells // grid, cells % grid
    coords = np.stack([c * 256, r * 256], 1).astype(np.int64)
    u = (stack[:, :, 1] - stack[:, :, 0]).mean(0)
    u = u / np.linalg.norm(u)
    mid, radius = (grid - 1) / 2, 0.3 * grid
    inside = (r - mid) ** 2 + (c - mid) ** 2 <= radius ** 2
    sign = np.where(inside, 1.0, -1.0)[:, None]
    feats = (sign * rng.uniform(0.5, 1.5, (n, 1)) * u
             + 0.02 * rng.standard_normal((n, u.size))).astype(np.float32)
    return feats, coords, inside


def seg_mask(grid: int, ps: int) -> np.ndarray:
    """The level-0 mask of ``wsi_patches``'s tumour disc at ``ps`` pixels a
    patch."""
    mid, radius = (grid - 1) / 2, 0.3 * grid
    px = (np.arange(grid * ps) + 0.5) / ps - 0.5
    return (((px[:, None] - mid) ** 2 + (px[None] - mid) ** 2
             <= radius ** 2) * 255).astype(np.uint8)


def synced_ms(torch, fn):
    """(result, wall ms) of one call of ``fn``, the card synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def tf32_on(torch):
    """cuBLAS's fp32 matmuls with TF32 on; the run's setting restored."""
    from keep_tpu_torch.ops.nn import restore_tf32, tf32_state

    saved = tf32_state()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        restore_tf32(saved)


@contextlib.contextmanager
def unguarded_fp32():
    """The sweep's fp32 products without ``ops.nn.ieee_fp32``: the control
    that shows the guard, not the card's choice of kernel, keeps TF32 out
    of them (under TF32 they must then change)."""
    from keep_tpu_torch.ops import preprocess
    from keep_tpu_torch.wsi import pipelines
    from keep_tpu_torch.zeroshot import classifier

    mods = (preprocess, pipelines, classifier)
    saved = [m.ieee_fp32 for m in mods]
    for m in mods:
        m.ieee_fp32 = contextlib.nullcontext
    try:
        yield
    finally:
        for m, guard in zip(mods, saved):
            m.ieee_fp32 = guard


def reset_launches(fa) -> None:
    from keep_tpu_torch.kernels import _kops

    with fa._launch_lock:
        fa.LAUNCHES = 0
    with _kops._launch_lock:
        _kops.LAUNCHES.clear()


def read_launches(fa) -> tuple[int, dict]:
    from keep_tpu_torch.kernels import _kops

    return fa.LAUNCHES, dict(_kops.LAUNCHES)


def pixels_255(torch, x, cfg) -> "torch.Tensor":
    """Normalised pixels back on the 0..255 scale."""
    mean = torch.tensor(cfg.mean, device=x.device)
    std = torch.tensor(cfg.std, device=x.device)
    return (x * std + mean) * 255.0


def drive_wsi_extract(torch, fa, d: str, device: str = "cuda",
                      slide_px: int = WSI_SLIDE_PX,
                      batch_size: int = WSI_BATCH) -> dict:
    """Phase 10: a flat slide → ``cut_tiles`` → ``extract_features(resize=
    True)`` with the model ``wsi.run.load_model`` loads (bf16, the fused
    attention), then with ``--int8``'s (calibration 0). Gates: the card's
    bicubic against the port's CPU ``preprocess`` on 64 tiles (≤ 1/255
    before normalisation, and the same bits with TF32 on); the features
    against the same model with plain attention on the first batch (cosine
    ≥ 0.999 per row); ``pipeline_depth`` 1 against 3 (the same bits); the
    tail-padded last batch against its rows encoded alone (cosine ≥
    0.9999); the int8 features against bf16 (cosine ≥ 0.999 per row) and,
    on the first batch, against the same int8 model with plain blocks
    (mean row cosine > 0.9999); one attention launch per block of every
    batch. The TF32 gate has a control: without the guard TF32 must move
    pixels. Returns the phase's result and what the next phases use."""
    import argparse

    from keep_tpu_torch.configs import PreprocessConfig
    from keep_tpu_torch.io.tiles import cut_tiles
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.ops.preprocess import preprocess
    from keep_tpu_torch.wsi import run as wsi_run
    from keep_tpu_torch.wsi.extract import extract_features

    cfg = PreprocessConfig()
    t0 = time.perf_counter()
    slide = wsi_slide(slide_px)
    slide_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiles, coords = cut_tiles(slide, patch_size=256, tissue_fraction=0.25)
    cut_s = time.perf_counter() - t0
    del slide
    n = len(tiles)
    if n < 2 * batch_size:
        raise AssertionError(f"{n} tissue tiles")
    args = argparse.Namespace(model=d, device=device, int8=False)
    model, tokenizer = wsi_run.load_model(args)
    depth = model.cfg.vision.depth
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def extract(m, t, **kw):
        return extract_features(m, t, batch_size=kw.pop("bs", batch_size),
                                resize=True, **kw)

    extract(model, tiles[:batch_size])  # the first call pays the setup
    sync()
    reset_launches(fa)
    # ---- the main path --------------------------------------------------
    t0 = time.perf_counter()
    feats = extract(model, tiles)
    wall = time.perf_counter() - t0
    launches, _ = read_launches(fa)
    # ----------------------------------------------------------------------
    batches = -(-n // batch_size)
    if device == "cuda" and launches != batches * depth:
        raise AssertionError(f"extract: {launches} attention launches, want "
                             f"{batches * depth}")
    check_features("extract", feats, n, model.cfg.projection_dim)

    # the card's bicubic against the port's CPU preprocess, TF32 off and on
    few = torch.from_numpy(tiles[:64])
    on_card = preprocess(few.to(device), cfg)
    cpu = preprocess(few, cfg)
    diff = (pixels_255(torch, on_card.cpu(), cfg)
            - pixels_255(torch, cpu, cfg)).abs()
    if not diff.max().item() <= 1.0 + 1e-3:
        raise AssertionError(f"bicubic card vs CPU: {diff.max().item()}/255")
    with tf32_on(torch):
        tf32_same = bool(torch.equal(preprocess(few.to(device), cfg),
                                     on_card))
        with unguarded_fp32():
            loose = preprocess(few.to(device), cfg)
    tf32_moved = (loose != on_card).float().mean().item()
    del loose
    if not tf32_same:
        raise AssertionError("bicubic: TF32 on changed the pixels")
    if device == "cuda" and tf32_moved == 0.0:
        raise AssertionError("bicubic control: TF32 on without the guard "
                             "moved no pixel, so the gate cannot see it")

    # the same model with plain attention on the first batch
    plain = KEEPModel(model.cfg, dtype=model.dtype, use_flash=False,
                      device=device)
    plain.load_state_dict(model.state_dict())
    ref = extract(plain, tiles[:batch_size])
    del plain
    cos_plain = cosine_rows(feats[:batch_size], ref)
    if not (cos_plain >= 0.999).all():
        raise AssertionError(f"extract vs plain attention: {cos_plain.min()}")
    # pipeline depth 1 against 3 on four batches and a tail
    part = tiles[: 4 * batch_size + batch_size // 3]
    d1 = extract(model, part, pipeline_depth=1)
    d3 = extract(model, part, pipeline_depth=3)
    if not np.array_equal(d1, d3):
        raise AssertionError("pipeline_depth 1 and 3 differ")
    # the tail-padded last batch against its rows encoded alone
    tail = n % batch_size or batch_size
    alone = extract(model, tiles[n - tail:], bs=tail)
    cos_tail = cosine_rows(feats[n - tail:], alone)
    if not (cos_tail >= 0.9999).all():
        raise AssertionError(f"tail rows alone: {cos_tail.min()}")

    # the bicubic alone, one batch on the card; and where the time goes
    x = torch.from_numpy(tiles[:batch_size]).to(device)
    out = {"slide_px": slide_px, "slide_s": slide_s, "cut_tiles_s": cut_s,
           "tiles": n, "batches": batches, "batch_size": batch_size,
           "tiles_per_s_bf16": n / wall, "wall_s_bf16": wall,
           "attention_launches": launches,
           "attention_launches_per_batch": launches / batches,
           "bicubic_max_abs_err_255": diff.max().item(),
           "bicubic_share_differing": (diff > 0.5).float().mean().item(),
           "bicubic_same_bits_tf32_on": tf32_same,
           "bicubic_tf32_unguarded_share_moved": tf32_moved,
           "min_cos_vs_plain_attention": float(cos_plain.min()),
           "depth_1_3_same_bits": True, "tail_rows": tail,
           "min_cos_tail_alone": float(cos_tail.min())}
    if device == "cuda":
        out["bicubic_ms_per_batch"] = cuda_ms(lambda: preprocess(x, cfg))
        out["bicubic_device_ms_per_batch"] = device_ms(
            torch, lambda: preprocess(x, cfg))
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            extract(model, tiles)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        busy = sum(kernel_ms(torch, prof).values()) / 1e3
        out["profiled_wall_s"] = prof_wall
        out["profiled_kernel_s"] = busy
        out["idle_share"] = 1.0 - busy / prof_wall if busy else "not measured"
    del x

    # the --int8 towers (calibration 0) on the same tiles
    model8, _ = wsi_run.load_model(argparse.Namespace(model=d, device=device,
                                                      int8=True))
    extract(model8, tiles[:batch_size])
    sync()
    reset_launches(fa)
    # ---- the main path, int8 ---------------------------------------------
    t0 = time.perf_counter()
    feats8 = extract(model8, tiles)
    wall8 = time.perf_counter() - t0
    attn8, launches8 = read_launches(fa)
    # ----------------------------------------------------------------------
    want8 = {"quantized_attention_block": batches * depth,
             "quantized_mlp_bsd": batches * depth,
             "quantized_matmul_bsd": batches, "quantized_matmul": 2 * batches}
    if device == "cuda":
        for k, v in want8.items():
            if launches8.get(k, 0) != v:
                raise AssertionError(f"int8 extract: {k} {launches8.get(k)} "
                                     f"launches, want {v}")
    cos8 = cosine_rows(feats8, feats)
    if not (cos8 >= 0.999).all():
        raise AssertionError(f"int8 extract vs bf16: {cos8.min()}")
    # the int8 kernels at this path's shapes (M = batch · 197) against
    # their plain versions on the first batch, at the gate between two
    # int8 routes (image rows: the mean of the per-row cosines)
    with plain_int8_blocks():
        ref8 = extract(model8, tiles[:batch_size])
    route8 = int8_route(feats8[:batch_size], ref8)
    if not route8["mean_row_cos"] > 0.9999:
        raise AssertionError(f"int8 extract vs its plain blocks: {route8}")
    out.update(tiles_per_s_int8=n / wall8, wall_s_int8=wall8,
               int8_launches=launches8, int8_attention_launches=attn8,
               min_cos_int8_vs_bf16=float(cos8.min()),
               int8_vs_plain_blocks=route8)
    if device == "cuda":
        out["card"] = card()
    phase("wsi_extract", **out)
    return {"result": out, "model": model, "model8": model8,
            "tokenizer": tokenizer, "features": feats, "coords": coords}


def drive_wsi_classifier(torch, fa, model, model8, tokenizer,
                         device: str = "cuda", n_prompts: int = WSI_PROMPTS,
                         batch_size: int = 256, max_length: int = 256
                         ) -> dict:
    """Phase 11: ``build_classifiers_batched`` over ``n_prompts`` two-class
    prompts with ``length_buckets="auto"`` and then ``None`` (flat), through
    ``wsi.run``'s text encoder; the two stacks' columns at cosine ≥ 0.9999;
    12 attention launches per text dispatch; the first batch of each width
    dispatched against the same BERT with plain attention (cosine ≥ 0.999
    per row); then the flat build with the int8 towers, whose columns hold
    cosine ≥ 0.999 against bf16, and whose batches hold > 0.9999 (taken
    whole) against the same int8 model with plain blocks."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.wsi import run as wsi_run
    from keep_tpu_torch.zeroshot import build_classifiers_batched

    prompts = wsi_prompts(n_prompts)
    label_map = {"Normal": 0, "Tumor": 1}
    layers = model.cfg.text.num_hidden_layers
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def build(m, buckets, info=None):
        enc = wsi_run._encoder(m, torch.device(device))
        calls, firsts = [], {}

        def counted(ids, mask):
            calls.append(ids.shape)
            # the first batch of each width, for the checks against plain
            firsts.setdefault(ids.shape[1], (np.array(ids), np.array(mask)))
            return enc(ids, mask)

        sync()
        reset_launches(fa)
        t0 = time.perf_counter()
        stack = build_classifiers_batched(
            counted, tokenizer, prompts, label_map, max_length=max_length,
            batch_size=batch_size, length_buckets=buckets, device=device,
            info=info)
        sync()
        wall = time.perf_counter() - t0
        launches, by_name = read_launches(fa)
        if device == "cuda" and launches != len(calls) * layers:
            raise AssertionError(f"classifier: {launches} attention launches "
                                 f"for {len(calls)} dispatches")
        return stack, wall, calls, launches, by_name, firsts

    def encoded(m, batches) -> dict:
        enc = wsi_run._encoder(m, torch.device(device))
        return {w: enc(ids, mask).float().cpu().numpy()
                for w, (ids, mask) in sorted(batches.items())}

    info: dict = {}
    # ---- the main path: the bucketed ("auto") build, then the flat one --
    auto, auto_s, auto_calls, auto_launches, _, auto_firsts = build(
        model, "auto", info)
    flat, flat_s, flat_calls, flat_launches, _, flat_firsts = build(
        model, None)
    # ----------------------------------------------------------------------
    # the kernel at each width the builds dispatched, one batch each,
    # against the same BERT with plain attention (the repo's bf16 gate)
    batches = {**flat_firsts, **auto_firsts}
    got = encoded(model, batches)
    plain = KEEPModel(model.cfg, dtype=model.dtype, use_flash=False,
                      device=device)
    plain.load_state_dict(model.state_dict())
    want = encoded(plain, batches)
    del plain
    cos_plain = {w: float(cosine_rows(got[w], want[w]).min()) for w in got}
    if not all(c >= 0.999 for c in cos_plain.values()):
        raise AssertionError(f"text tower vs plain attention by width: "
                             f"{cos_plain}")
    a, f = auto.cpu().numpy(), flat.cpu().numpy()
    cos = (a * f).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(f, axis=1))  # [P, C]
    if not (cos >= 0.9999).all():
        raise AssertionError(f"bucketed vs flat columns: {cos.min()}")
    texts = 2 * n_prompts
    lengths = np.asarray(tokenizer(
        [p["classnames"][k] for p in prompts.values()
         for k in ("Normal", "Tumor")],
        max_length=max_length)["attention_mask"]).sum(1)
    out = {"prompts": n_prompts, "texts": texts,
           "tokens_min_mean_max": [int(lengths.min()), float(lengths.mean()),
                                   int(lengths.max())],
           "plan": info.get("plan"), "method": info.get("method"),
           "chooser": {k: v for k, v in info.items()
                       if k not in ("plan", "method")},
           "prompts_per_s_auto": n_prompts / auto_s,
           "prompts_per_s_flat": n_prompts / flat_s,
           "dispatches_auto": len(auto_calls),
           "widths_auto": sorted({s[1] for s in auto_calls}),
           "dispatches_flat": len(flat_calls),
           "attention_launches_auto": auto_launches,
           "attention_launches_flat": flat_launches,
           "attention_launches_per_text_dispatch":
               flat_launches / len(flat_calls),
           "min_column_cos_auto_vs_flat": float(cos.min()),
           "max_abs_diff_auto_vs_flat": float(np.abs(a - f).max()),
           "min_row_cos_vs_plain_attention_by_width": cos_plain,
           "rows_vs_plain_by_width": {w: len(v) for w, v in got.items()}}
    # the text tower's cost a token position at full width, the figure the
    # bucket planner's cost model keys by device type (SEC_PER_TOKEN)
    if device == "cuda":
        ids = np.ones((batch_size, max_length), np.int64)
        enc = wsi_run._encoder(model, torch.device(device))
        ms = cuda_ms(lambda: enc(ids, ids), runs=5)
        out["full_width_dispatch_ms"] = ms
        out["sec_per_token_measured"] = ms / 1e3 / (batch_size * max_length)

    # ---- the int8 text tower, flat ----------------------------------------
    stack8, s8, calls8, attn8, by_name8, firsts8 = build(model8, None)
    a8 = stack8.cpu().numpy()
    cos8 = (a8 * f).sum(1) / (np.linalg.norm(a8, axis=1)
                              * np.linalg.norm(f, axis=1))
    if not (cos8 >= 0.999).all():
        raise AssertionError(f"int8 classifier vs bf16: {cos8.min()}")
    # the int8 kernels at each width dispatched against their plain
    # versions, at the gate between two int8 routes (text taken whole)
    got8 = encoded(model8, firsts8)
    with plain_int8_blocks():
        want8 = encoded(model8, firsts8)
    route8 = {w: int8_route(got8[w], want8[w]) for w in got8}
    if not all(r["whole_cos"] > 0.9999 for r in route8.values()):
        raise AssertionError(f"int8 text tower vs its plain blocks: {route8}")
    if device == "cuda":
        for k in ("quantized_attention_block_postln", "quantized_mlp_bsd"):
            if by_name8.get(k, 0) != len(calls8) * layers:
                raise AssertionError(f"int8 classifier: {k} {by_name8}")
    out.update(prompts_per_s_int8_flat=n_prompts / s8,
               int8_launches=by_name8, int8_attention_launches=attn8,
               dispatches_int8=len(calls8),
               min_column_cos_int8_vs_bf16=float(cos8.min()),
               int8_vs_plain_blocks_by_width=route8)
    phase("wsi_classifier", **out)
    return {"result": out, "stack": flat}


def _decision(name: str, card_value, cpu_value, near: int, bound: float,
              gates: dict) -> None:
    """A decision of the card against the CPU's on the same inputs: equal,
    or (only where ``near`` patches lie within ``NEAR`` of a threshold)
    apart by no more than those patches can move it (``bound``)."""
    a, b = np.asarray(card_value, np.float64), np.asarray(cpu_value,
                                                          np.float64)
    equal = bool(np.array_equal(a, b))
    diff = float(np.abs(a - b).max()) if a.size else 0.0
    gates[name] = {"equal": equal, "near_threshold": int(near),
                   "abs_diff": diff}
    if not equal and not (near and diff <= bound):
        raise AssertionError(f"{name}: card {card_value} vs CPU {cpu_value}, "
                             f"{near} patches near a threshold")


def _close_pairs(p: np.ndarray, labels: np.ndarray) -> int:
    """Pairs of one positive and one negative patch whose probabilities lie
    within ``NEAR`` of each other: the pairs whose order two summation
    orders may swap, each moving AUROC by 1 / (n_pos · n_neg)."""
    pos = np.sort(p[labels == 1])
    neg = p[labels == 0]
    return int((np.searchsorted(pos, neg + NEAR, "right")
                - np.searchsorted(pos, neg - NEAR, "left")).sum())


def drive_wsi_pipelines(torch, stack, device: str = "cuda",
                        n: int = WSI_PATCHES, grid: int = WSI_GRID) -> dict:
    """Phase 12: the screening and the three pipelines on the card at a
    slide's long axis, each held against the same port functions on the
    CPU with the same inputs (probabilities at 1e-5, the same top-50 set,
    the merged classifier at 1e-5, decisions and heatmap bytes equal with
    near-threshold patches counted), and the card's results the same with
    TF32 on, where without the guard TF32 moves the probabilities and the
    screening's scores (the control)."""
    from keep_tpu_torch.metrics.classification import roc_best_threshold
    from keep_tpu_torch.wsi import pipelines as wp
    from keep_tpu_torch.wsi.grid import CoordGrid
    from keep_tpu_torch.zeroshot import classifier as zc

    stack_cpu = stack.cpu()
    feats, coords, _ = wsi_patches(stack_cpu.numpy(), n, grid)
    seg_coords = coords // (256 // WSI_SEG_PATCH)
    mask = seg_mask(grid, WSI_SEG_PATCH)
    cls4 = torch.stack([stack_cpu[1, :, 1], stack_cpu[2, :, 1],
                        stack_cpu[3, :, 1], stack_cpu[0, :, 0]], 1)

    def run(dev: str, timed: bool) -> tuple[dict, dict]:
        f = torch.from_numpy(feats).to(dev)
        s, c4 = stack_cpu.to(dev), cls4.to(dev)
        out, ms = {}, {}

        def step(name, fn):
            if timed:
                out[name], ms[name] = synced_ms(torch, fn)
            else:
                out[name] = fn()

        step("prompt_select", lambda: zc._prompt_select_jit(s, f, WSI_TOPN))
        merged = out["prompt_select"][0]
        step("random_ensemble", lambda: zc.random_ensemble(s, WSI_TOPN))
        step("score_tiles", lambda: wp.score_tiles(merged, f))
        step("detection", lambda: wp.zero_shot_detection(
            merged, f, coords, patch_size=256, overlap=False))
        step("detection_overlap", lambda: wp.zero_shot_detection(
            merged, f, coords, patch_size=256, overlap=True))
        step("segmentation", lambda: wp.zero_shot_segment(
            merged, f, seg_coords, mask=mask, patch_size=WSI_SEG_PATCH))
        step("subtyping", lambda: wp.zero_shot_subtyping(
            c4, f, coords, patch_size=256))
        step("tumor_heatmap", lambda: wp.tumor_heatmap(
            merged, f, coords, patch_size=256))
        return out, ms

    if device == "cuda":
        run(device, timed=False)  # the first calls pay cuBLAS's setup
    card_out, ms = run(device, timed=device == "cuda")
    cpu_out, _ = run("cpu", timed=False)
    gates: dict = {}

    # the screening: scores, the same top-50 set, the merged classifier
    m_card, s_card, o_card = (t.cpu() for t in card_out["prompt_select"])
    m_cpu, s_cpu, o_cpu = cpu_out["prompt_select"]
    top_same = set(o_card.tolist()) == set(o_cpu.tolist())
    gates["top50_same_set"] = top_same
    gates["top50_same_order"] = bool(torch.equal(o_card, o_cpu))
    gates["scores_max_abs_diff"] = (s_card - s_cpu).abs().max().item()
    gates["merged_max_abs_diff"] = (m_card - m_cpu).abs().max().item()
    gates["random_ensemble_max_abs_diff"] = (
        card_out["random_ensemble"].cpu()
        - cpu_out["random_ensemble"]).abs().max().item()
    if not (top_same and gates["merged_max_abs_diff"] <= 1e-5
            and gates["random_ensemble_max_abs_diff"] <= 1e-5):
        raise AssertionError(f"screening card vs CPU: {gates}")
    probs = card_out["score_tiles"].cpu()
    p_cpu = cpu_out["score_tiles"]
    gates["probs_max_abs_diff"] = (probs - p_cpu).abs().max().item()
    if not gates["probs_max_abs_diff"] <= 1e-5:
        raise AssertionError(f"probabilities card vs CPU: {gates}")
    p1 = p_cpu[:, 1].numpy()
    gates["probs_within_0.05_of_half"] = float((np.abs(p1 - 0.5)
                                                <= 0.05).mean())

    # the decisions, with the patches near their thresholds
    g256 = CoordGrid.from_coords(coords, 256)
    for name, overlap in (("detection", False), ("detection_overlap", True)):
        kept = wp.refined_tumor_probs(m_cpu, torch.from_numpy(feats), g256,
                                      overlap).numpy()
        near = int((np.abs(kept - 0.5) <= NEAR).sum())
        _decision(name, card_out[name], cpu_out[name], near,
                  near / len(kept) + 1e-7, gates)
    gseg = CoordGrid.from_coords(seg_coords, WSI_SEG_PATCH)
    p_seg = wp.refined_tumor_probs(m_cpu, torch.from_numpy(feats), gseg,
                                   True).numpy()
    labels = wp.patch_labels_from_mask(mask, gseg.kept_coords(seg_coords),
                                       WSI_SEG_PATCH)
    _, thd = roc_best_threshold(labels, p_seg)
    pairs = _close_pairs(p_seg, labels)
    n_pairs = float((labels == 1).sum()) * float((labels == 0).sum())
    near_thd = int((np.abs(p_seg - thd) <= NEAR).sum())
    _decision("segmentation_auroc", card_out["segmentation"][0],
              cpu_out["segmentation"][0], pairs, pairs / n_pairs + 1e-12,
              gates)
    # a patch that crosses the threshold repaints k low-resolution pixels
    k = (WSI_SEG_PATCH / 16) ** 2
    painted = (np.count_nonzero(mask[::16, ::16])
               + float((p_seg > thd).sum()) * k)
    _decision("segmentation_dice", card_out["segmentation"][1],
              cpu_out["segmentation"][1], near_thd + pairs,
              4 * k * (near_thd + pairs) / painted, gates)
    from keep_tpu_torch.wsi.grid import refine_grid

    g4, occ = g256.scatter(wp.score_tiles(cls4, torch.from_numpy(feats)))
    refined4 = g256.gather(refine_grid(g4, occ))
    top2 = torch.topk(refined4, 2, -1).values
    near_sub = int(((top2[:, 0] - top2[:, 1]) <= NEAR).sum())
    frac = np.sort(cpu_out["subtyping"][1][:-1])
    label_near = near_sub if frac[-1] - frac[-2] <= 2 * near_sub / len(
        refined4) else 0
    _decision("subtype_label", card_out["subtyping"][0],
              cpu_out["subtyping"][0], label_near, 3.0, gates)
    _decision("subtype_fractions", card_out["subtyping"][1],
              cpu_out["subtyping"][1], near_sub,
              near_sub / len(refined4) + 1e-7, gates)
    hm_card, hm_cpu = card_out["tumor_heatmap"], cpu_out["tumor_heatmap"]
    heat, hocc = wp.probability_heatmap(m_cpu, torch.from_numpy(feats),
                                        coords, patch_size=256)
    v = np.clip(heat[hocc > 0], 0.0, 1.0) * 255.0
    near_hm = int((np.abs(v - np.floor(v) - 0.5) <= 255 * NEAR).sum())
    differing = int((hm_card != hm_cpu).sum())
    gates["heatmap"] = {"shape": list(hm_card.shape),
                        "equal": bool(np.array_equal(hm_card, hm_cpu)),
                        "near_rounding": near_hm,
                        "differing_pixels": differing}
    cell = 256 // 16  # pixels a side of one patch's cell
    if differing > near_hm * cell * cell:
        raise AssertionError(f"heatmap card vs CPU: {gates['heatmap']}")

    # TF32 on: the card gives the same results; the control: without the
    # guard TF32 moves the probabilities and the screening's scores
    f_dev, s_dev = torch.from_numpy(feats).to(device), stack_cpu.to(device)
    with tf32_on(torch):
        tf32_out, _ = run(device, timed=False)
        with unguarded_fp32():
            loose = {"score_tiles": wp.score_tiles(m_card.to(device), f_dev),
                     "screening_scores": zc._prompt_select_jit(
                         s_dev, f_dev, WSI_TOPN)[1]}
    control = {"score_tiles": (loose["score_tiles"]
                               != card_out["score_tiles"]).float().mean().item(),
               "screening_scores": (loose["screening_scores"]
                                    != card_out["prompt_select"][1]
                                    ).float().mean().item()}
    del f_dev, s_dev, loose
    if device == "cuda" and not all(v > 0 for v in control.values()):
        raise AssertionError(f"TF32 control: without the guard TF32 moved "
                             f"nothing, so the gate cannot see it: {control}")
    same = {}
    for k, v in card_out.items():
        w = tf32_out[k]
        if isinstance(v, tuple) and isinstance(v[0], torch.Tensor):
            same[k] = all(torch.equal(a, b) for a, b in zip(v, w))
        elif isinstance(v, torch.Tensor):
            same[k] = bool(torch.equal(v, w))
        elif isinstance(v, tuple):
            same[k] = all(np.array_equal(a, b) for a, b in zip(v, w))
        else:
            same[k] = bool(np.array_equal(v, w))
    if not all(same.values()):
        raise AssertionError(f"TF32 on changed: {same}")
    out = {"patches": n, "grid": [grid, grid], "topn": WSI_TOPN,
           "seg_patch_px": WSI_SEG_PATCH, "seg_mask_px": int(mask.shape[0]),
           "tumor_prob": card_out["detection"],
           "tumor_prob_overlap": card_out["detection_overlap"],
           "auroc_dice": list(card_out["segmentation"]),
           "subtype": [card_out["subtyping"][0],
                       card_out["subtyping"][1].tolist()],
           "gates": gates, "same_with_tf32_on": same,
           "tf32_unguarded_share_moved": control, "ms": ms}
    if device == "cuda":
        out["ms_total"] = sum(ms.values())
        out["card"] = card()
    phase("wsi_pipelines", **out)
    return out


def drive_wsi(torch, fa, d: str, device: str = "cuda", **sizes) -> dict:
    """Phases 10–12 on the model in ``d``. ``sizes`` shrink them for a
    rehearsal on the CPU (``slide_px``, ``batch_size``, ``n_prompts``,
    ``n``, ``grid``)."""
    ext = drive_wsi_extract(torch, fa, d, device, **{
        k: sizes[k] for k in ("slide_px", "batch_size") if k in sizes})
    cls = drive_wsi_classifier(
        torch, fa, ext["model"], ext["model8"], ext["tokenizer"], device,
        **{k: sizes[k] for k in ("n_prompts",) if k in sizes})
    del ext["model"], ext["model8"]
    if device == "cuda":
        torch.cuda.empty_cache()
    pipes = drive_wsi_pipelines(torch, cls["stack"], device, **{
        k: sizes[k] for k in ("n", "grid") if k in sizes})
    return {"extract": ext["result"], "classifier": cls["result"],
            "pipelines": pipes}


def kernel_ms(torch, prof) -> dict[str, float]:
    """Device ms by kernel name (first 80 characters) of a torch.profiler
    trace."""
    by_kernel = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        key = ev.key[:80]  # names that share 80 characters add up
        by_kernel[key] = (by_kernel.get(key, 0.0)
                          + ev.self_device_time_total / 1e3)
    return by_kernel


def throughput(torch, core, rng, int8: bool = False) -> dict:
    """Serving throughput at bucket 128 through the server core (queue, H2D,
    dispatch, fetch), two callers at a time so that double buffering works,
    plus a device-time breakdown of one bucket-128 image dispatch. For the
    bf16 server (phase 5) the dispatches are also timed with plain attention
    on the same weights; for the int8 server (phase 7) the breakdown is also
    summed by kernel family."""
    tiles = rng.integers(0, 256, (128, 224, 224, 3), dtype=np.uint8)
    texts = [PROMPTS[i % 3] for i in range(128)]

    def rate(fn, items: int, calls: int = 6, callers: int = 2) -> float:
        fn()  # warm
        errors = []

        def caller():
            try:
                for _ in range(calls // callers):
                    fn()
            except BaseException as e:  # re-raised below, in the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=caller) for _ in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return items * calls / (time.perf_counter() - t0)

    img_rate = rate(lambda: core.encode_image(tiles), 128)
    txt_rate = rate(lambda: core.encode_text(texts), 128)

    # device time of one bucket-128 dispatch of each tower, with the kernel
    # and with plain attention (same weights), and the image dispatch's
    # device time by kernel
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.ops.preprocess import normalize_only

    model = core.model
    models = [("int8", model)] if int8 else [("kernel", model)]
    if not int8:
        plain = KEEPModel(model.cfg, dtype=model.dtype, use_flash=False,
                          device="cuda")
        plain.load_state_dict(model.state_dict())
        models.append(("plain", plain))
    px = torch.from_numpy(tiles).cuda()
    ids = torch.zeros(128, 256, dtype=torch.long, device="cuda")
    mask = torch.ones_like(ids)
    dev_ms = {}
    with torch.inference_mode():
        for tag, m in models:
            suffix = tag if int8 else f"{tag}_attention"
            dev_ms[f"image_b128_{suffix}"] = cuda_ms(
                lambda: m.encode_image(normalize_only(px)), runs=10)
            dev_ms[f"text_b128x256_{suffix}"] = cuda_ms(
                lambda: m.encode_text(ids, mask), runs=10)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.encode_image(normalize_only(px))
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as text_prof:
            model.encode_text(ids, mask)
            torch.cuda.synchronize()
    from scripts.torch_dispatch_profile import by_family

    by_kernel = kernel_ms(torch, prof)
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    attn = sum(v for k, v in by_kernel.items() if "slab_attention" in k)
    text_kernels = kernel_ms(torch, text_prof)
    # the int8 blocks' attention runs the wgmma body, and no other
    profiles = (("image", by_kernel), ("text", text_kernels))
    wgmma = {tag: sum(v for k, v in kms.items()
                      if "slab_attention_wgmma" in k) for tag, kms in profiles}
    others = [k for _, kms in profiles for k in kms
              if "slab_attention" in k and "slab_attention_wgmma" not in k]
    if int8 and total and (others or not all(wgmma.values())):
        raise AssertionError(f"int8 dispatches: the wgmma body {wgmma} ms, "
                             f"other attention kernels {others}")
    out = {"card": card(), "image_tiles_per_s_bucket128": img_rate,
           "text_prompts_per_s_bucket128x256": txt_rate,
           "device_ms": dev_ms,
           "image_b128_profiled_device_ms": total if total else "not measured",
           "attention_kernel_share_image_b128":
               attn / total if total else "not measured",
           "image_b128_top_kernels_ms": top,
           "image_b128_ms_by_family": by_family(by_kernel),
           "text_b128x256_profiled_device_ms": sum(text_kernels.values()),
           "text_b128x256_ms_by_family": by_family(text_kernels),
           "attention_wgmma_body_ms": wgmma}
    phase("numbers_int8" if int8 else "numbers", **out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from keep_tpu_torch import serve
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.kernels import _build
    from keep_tpu_torch.kernels import flash_attention as fa
    from keep_tpu_torch.kernels import ln_matmul as lm

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    phase("device", name=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(card(), flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=time.perf_counter() - t0,
          compiled=_build.BUILD_SECONDS is not None,
          library=_build.library_path().name)

    # 3. kernels vs plain at the serving shapes, and the three opt-in paths
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, f32_rows = check_kernel(fa, torch, gen)
    heads_rows, heads_launches = check_heads(fa, torch, gen)
    int8_rows, _ = check_int8_kernels(torch, gen)
    ln_rows = check_ln_matmul(lm, torch, gen)
    cfg = KEEPConfig()
    fused = drive_fuse_ln(torch, fa, lm, cfg)

    # 4.–7. the bf16 and the int8 server, end to end, and their numbers
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d_init:
        write_model(d, torch, cfg)
        served, core, feats = drive_server(torch, fa, serve, cfg, d)
        try:
            throughput(torch, core, np.random.default_rng(1))
        finally:
            core.stop()
        del core
        torch.cuda.empty_cache()
        # the int8 scheme on these weights, whose blocks all move the
        # stream: measured and reported, not gated
        drift = served_features(torch, serve, cfg, d, quantize=True)
        phase("int8_drift", weights="random, every block moving the stream",
              min_cos_vs_bf16_server={
                  k: float(cosine_rows(v, feats[k]).min())
                  for k, v in drift.items()})
        # the int8 server, gated at cos >= 0.999 on weights with the
        # statistics the repo's gate is measured on (keep.init)
        write_model(d_init, torch, cfg, keep_init=True)
        ref = served_features(torch, serve, cfg, d_init, quantize=False)
        ref8 = served_features(torch, serve, cfg, d_init, quantize=True,
                               plain_blocks=True)
        served8, core8, _ = drive_server(torch, fa, serve, cfg, d_init,
                                         bf16_features=ref,
                                         plain_int8_features=ref8)
        try:
            throughput(torch, core8, np.random.default_rng(1), int8=True)
        finally:
            core8.stop()
        del core8
        torch.cuda.empty_cache()
        # 10.–12. the zero-shot WSI sweep on the same weights
        wsi = drive_wsi(torch, fa, d_init)
        torch.cuda.empty_cache()

    # 8.–9. the attention backward, then training through the CLI
    bwd_rows = check_bwd_kernel(fa, torch, gen)
    with tempfile.TemporaryDirectory() as d_train:
        trained = drive_train(torch, fa, d_train,
                              train_config(d_train, steps_per_epoch=4),
                              blocks=cfg.vision.depth
                              + cfg.text.num_hidden_layers, steps_per_epoch=4)

    print(json.dumps({"kernels": kernel_line(
        rows, bwd_rows, heads_rows, heads_launches, int8_rows, ln_rows,
        fused, served, served8, trained, f32_rows, wsi)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_line(rows, bwd_rows, heads_rows, heads_launches, int8_rows,
                ln_rows, fused, served, served8, trained,
                f32_rows, wsi) -> list[dict]:
    """One entry per TPU kernel: its launches on the main path that runs it,
    and, at ViT-L B=32 in bf16 (the int8 kernels: the first shape of their
    phase), its time, its plain version's, its bound and the one PyTorch
    call that computes the same function (null where there is none). The
    attention sub-blocks also carry their attention's rows (``f32_rows``,
    the bf16 → fp32 form at their tower's shapes). The kernels of the WSI
    sweep carry their launches on it (phases 10–11, bf16 and int8)."""
    def pick(rs, shape="vit_l16"):
        return next(r for r in rs if r["shape"] == shape and r["B"] == 32
                    and r["dtype"] == "bfloat16")

    def entry(name, source, replaces, launches, r, err, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"), **extra}

    vit = pick(rows)
    kernels = [entry(
        "attention_qkv_slab", SOURCE, REPLACES, served["launches"], vit,
        max(r["max_abs_err"] for r in rows),
        library_call="torch.nn.functional.scaled_dot_product_attention",
        library_kernel=vit["library_kernel"],
        launches_int8_path=served8["attention_launches"],
        launches_train=trained["fwd_launches"],
        launches_wsi_path={
            "extract": wsi["extract"]["attention_launches"],
            "classifier_auto": wsi["classifier"]["attention_launches_auto"],
            "classifier_flat": wsi["classifier"]["attention_launches_flat"]},
        shapes=rows)]
    vit_bwd = pick(bwd_rows)
    kernels.append(entry(
        "attention_qkv_slab_bwd", BWD_SOURCE, BWD_REPLACES,
        trained["bwd_launches"], vit_bwd,
        max(r["max_abs_err"] for r in bwd_rows),
        library_call="scaled_dot_product_attention backward through "
                     "autograd (retain_graph; the forward not timed)",
        library_kernel=vit_bwd["library_kernel"], shapes=bwd_rows))
    vit_heads = pick(heads_rows)
    kernels.append(entry(
        "attention_qkv_heads", SOURCE, HEADS_REPLACES, heads_launches,
        vit_heads, max(r["max_abs_err"] for r in heads_rows),
        library_call="torch.nn.functional.scaled_dot_product_attention",
        library_kernel=vit_heads["library_kernel"],
        flash_attention_ms=vit_heads["flash_attention_ms"],
        shapes=heads_rows))
    ln = ln_rows[0]
    kernels.append({
        "name": "ln_matmul", "route": "cuda", "source": LN_MATMUL_SOURCE,
        "body": LN_MATMUL_BODY, "replaces": LN_MATMUL_REPLACES,
        "launches": fused["ln_matmul_launches"],
        "max_abs_err": max(max(r["max_abs_err_fp32"], r["max_abs_err_bf16"])
                           for r in ln_rows),
        "ms": ln["ms"], "plain_ms": ln["plain_ms_bf16"],
        "bound_ms": ln["bound_ms"], "bound_by": ln["bound_by"],
        "library_ms": None, "unfused_ms": ln["unfused_ms"],
        "gemm_library_ms": ln["gemm_library_ms"],
        "max_abs_err_on_path": fused["ln_matmul_calls_vs_plain_max_abs_err"],
        "shapes": ln_rows})
    tower_of = {"quantized_attention_block": "vit_l16",
                "quantized_attention_block_postln": "bert_base"}
    for kname, (module, cu, replaces) in INT8_KERNELS.items():
        shapes = int8_rows[kname]["shapes"]
        launches = (int8_rows[kname]["launches"] if kname == "quantized_mlp"
                    else served8["launches"][kname])
        kernels.append({
            "name": kname, "route": "cuda", "source": CSRC + "int8_gemm.cu",
            "sources": [CSRC + f for f in cu] + [CSRC + "kops.cuh", module],
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": shapes[0]["ms_bf16"], "plain_ms": shapes[0]["plain_ms_bf16"],
            "bound_ms": shapes[0]["bound_ms_bf16"],
            "bound_by": shapes[0]["bound_by"], "library_ms": None,
            "int8_code_diff_share": max(r["int8_code_diff_share"]
                                        for r in shapes),
            "shapes": shapes})
        wsi_int8 = {"extract": wsi["extract"]["int8_launches"],
                    "classifier": wsi["classifier"]["int8_launches"]}
        kernels[-1]["launches_wsi_int8_path"] = {
            k: v.get(kname, 0) for k, v in wsi_int8.items()}
        if kname in tower_of:
            kernels[-1]["attention_bf16_to_fp32"] = [
                r for r in f32_rows if r["shape"] == tower_of[kname]]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
