#!/usr/bin/env python3
"""Times the port's bf16 attention forward (#1 ``attention_qkv_slab``, #2
``attention_qkv_heads`` / ``flash_attention``, and the int8 blocks'
bf16 → fp32 form) on one NVIDIA GPU at the shapes ``chip_smoke.py``'s
phases 3, 3e and 25 take, beside ``F.scaled_dot_product_attention`` on the
same values and the bound.

    python3 scripts/torch_attention_shapes_bench.py [--runs 7] [--calls 10]
        [--out f.json] [--edges 257,273,320 --widths 64,80]
        [--bwd [--train]] [--dtype float32]

Shapes (name, B, S, H, Dh, padded key bias): ViT-L/16 (S = 197) and
BERT-base (S = 256, a ragged key mask) at B = 32 and 128; the zoo's head
widths at S = 257 (ViT-H 80, ViT-g 88, ViT-bigG 104, ViT-e 112) and Dh =
64 at 577 and 785; the wide shapes of phase 25 at B = 32; and every edge
length of ``EDGE_S`` at Dh = 64 and 80 (B = 32, H = 16); with ``--edges``
only those lengths at the ``--widths`` (B = 32, H = 16). For each, in bf16:
the slab kernel's time (the median over ``--runs`` of CUDA events around
``--calls`` calls back to back, over the calls: device time wherever a
call outlasts the host's ~30 µs to launch the next; ``--calls 1`` times
single calls, host included, as ``chip_smoke.cuda_ms`` does) and its
device time (``dev_ms``: the profiler's kernel time over ``--calls``
calls, which host time never enters, also for the fp32-out form and
SDPA; each beside its ``_source``, ``"events"`` where no whole profiler
session came and events around the calls back to back stand in), the
split-heads and [B, H, S, Dh] kernels' (the towers', zoo's
and wide shapes), the fp32-out form's, SDPA's (its head views of the slab)
and the bound: the larger of the two products' 4·S²·Dh operations a head
over 989 TFLOP/s and q, k, v read once plus the output (bf16, or fp32 for
the fp32-out form) written once over 3.35 TB/s. A checkout whose kernel
refuses a shape prints ``"refused"`` with its error, so the same file
times another checkout of the package in the same call (run it from that
checkout's root with ``PYTHONPATH=.``). Prints the card's name and power
limit, then one JSON line per shape. Needs an NVIDIA GPU; imports no JAX.

``--bwd`` times the backward (#1b ``attention_qkv_slab_bwd``) instead, in
bf16 with dout in bf16 and the key bias the kernel always takes (zeros,
or BERT's ragged -1e9 mask): at ``BWD_SHAPES`` (chip_smoke.py's phase 8:
ViT-L/16 and BERT-base at B = 32 and 128; phase 25's six: Dh 64 at S =
577 / 785, Dh 80 / 88 / 104 / 112 at S = 257, B = 32, H = 16) and at
every ``EDGE_S`` length at Dh 64 and 80 (B = 32, H = 16; ``--edges`` /
``--widths`` pick others). For each: its events and profiler device ms,
SDPA's backward on the slab's head views through autograd (the graph
kept, so that only the backward is timed; the same mask) in both, the
longest kernel of SDPA's backward, the largest distance from the plain
version on unmasked rows beside 1e-2 of the largest plain gradient (the
bf16 gate), and the bound (``chip_smoke.attention_bound(backward=True)``'s
10·S²·Dh operations a head, 7 values of B·S·H·Dh in bf16 and the bias
moved). ``--train`` also runs chip_smoke.py's phase 9 (``drive_train``
of the checkout it is run from: the full-width KEEP trained at batch 128,
the last unfrozen step traced) and prints its ``slab_attention`` and
``slab_attention_bwd`` family ms, ms per unfrozen step and peak memory.

``--dtype float32`` times the fp32 forms instead (the slab, dout and the
key bias in fp32; TF32 off for the plain versions and SDPA): forward rows
without the fp32-out form, each with whether the kernel gave the plain
version's bits on valid rows (``bits_equal_plain``: its gate where S ≤
1024) and SDPA's longest kernel (``library_kernel``); backward rows held
to the fp32 gate (``within_gate``: atol 2e-4, rtol 1e-4). The forward's
bound counts its operations at fp32's 67 TFLOP/s (its route, the CUDA
cores); the backward's counts each product as three TF32 products at
495 TFLOP/s (its route, split TF32 on the tensor cores). With
``--train`` phase 9 runs at ``precision: fp32``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
HBM_BYTES_PER_S = 3.35e12
EDGE_S = [1, 15, 16, 17, 64, 197, 256, 257, 320, 321, 512, 513, 575, 576,
          577, 640, 641, 785, 1025]
# (name, B, S, H, Dh, padded, every layout)
SHAPES = ([(name, b, s, h, 64, padded, True) for b in (32, 128)
           for name, s, h, padded in (("vit_l16", 197, 16, False),
                                      ("bert_base", 256, 12, True))]
          + [("vit_h14", 64, 257, 16, 80, False, True),
             ("vit_g14", 64, 257, 16, 88, False, True),
             ("vit_bigg14", 32, 257, 16, 104, False, True),
             ("vit_e14", 32, 257, 16, 112, False, True),
             ("vit_l14_336", 32, 577, 16, 64, False, True),
             ("keep_448", 32, 785, 16, 64, False, True),
             ("wide_vit_h14", 32, 257, 16, 80, False, False),
             ("wide_vit_g14", 32, 257, 16, 88, False, False),
             ("dh128", 32, 257, 16, 128, False, False)]
          + [(f"edge_dh{dh}", 32, s, 16, dh, False, False)
             for dh in (64, 80) for s in EDGE_S])
# the backward's shapes (name, B, S, H, Dh, padded): phase 8's four, then
# phase 25's six
BWD_SHAPES = ([(name, b, s, h, 64, padded) for b in (32, 128)
               for name, s, h, padded in (("vit_l16", 197, 16, False),
                                          ("bert_base", 256, 12, True))]
              + [("keep_384", 32, 577, 16, 64, False),
                 ("keep_448", 32, 785, 16, 64, False),
                 ("vit_h14", 32, 257, 16, 80, False),
                 ("vit_g14", 32, 257, 16, 88, False),
                 ("vit_bigg14", 32, 257, 16, 104, False),
                 ("vit_e14", 32, 257, 16, 112, False)])


def events_ms(fn, runs: int, calls: int, warmup: int = 3) -> float:
    """Median over ``runs`` of the CUDA-event time of ``calls`` calls back
    to back, over ``calls``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def device_ms(fn, calls: int, tries: int = 3) -> tuple[float, str]:
    ms, source, _ = device_kernels(fn, calls, tries)
    return ms, source


def device_kernels(fn, calls: int, tries: int = 3, per_launch: int = 1
                   ) -> tuple[float, str, dict[str, float]]:
    """The device time of one call of ``fn`` (ms) and where it came from.
    ``"profiler"``: its kernels' time in a profiler session of ``calls``
    calls, over the calls. The profiler on the card's machine now and then
    records no kernel of a session, or only some: a session is kept only
    if it holds as many device records as the calls issued, a whole number
    a call and at least ``per_launch`` records for each attention launch
    the port counted in it (#1b's launch is two kernels), else it is taken
    again. After ``tries`` sessions short of that,
    ``"events"``: events around the calls back to back. Also returns the
    session's device ms a call by kernel name (empty for events)."""
    from torch.profiler import ProfilerActivity, profile

    from keep_tpu_torch.kernels import flash_attention as fa

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        n0 = fa.LAUNCHES + fa.HEADS_LAUNCHES + fa.BWD_LAUNCHES
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        issued = fa.LAUNCHES + fa.HEADS_LAUNCHES + fa.BWD_LAUNCHES - n0
        records = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in records)
        if count and count % calls == 0 and count >= issued * per_launch:
            by_kernel = {e.key: e.self_device_time_total / 1e3 / calls
                         for e in records}
            return sum(by_kernel.values()), "profiler", by_kernel
    return events_ms(fn, 1, calls, warmup=0), "events", {}


def bound_ms(b: int, s: int, h: int, dh: int, out_bytes: int = 2,
             padded: bool = False, dtype=torch.bfloat16) -> tuple[float, str]:
    """chip_smoke.attention_bound: the forward's 4·S²·Dh operations a head
    at the input type's peak; q, k, v read and the output written."""
    size = torch.finfo(dtype).bits // 8
    ops = 4 * b * h * s * s * dh / PEAK[dtype]
    moved = (b * s * h * dh * (3 * size + out_bytes) + padded * b * s * 4
             ) / HBM_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= moved else (moved * 1e3,
                                                           "bytes")


def bwd_bound_ms(b: int, s: int, h: int, dh: int,
                 dtype=torch.bfloat16) -> tuple[float, str]:
    """chip_smoke.attention_bound(backward=True): the score recompute and
    four products, 10·S²·Dh a head, at the route's peak (989 TFLOP/s bf16;
    fp32 in split TF32, three TF32 products each at 495); q, k, v, dout
    read and dq, dk, dv written (7 · B·S·H·Dh values) and the fp32 bias
    read (the kernel always takes one), over 3.35 TB/s."""
    ops = 10 * b * h * s * s * dh * (
        3 / PEAK_TF32 if dtype == torch.float32 else 1 / PEAK[dtype])
    moved = (7 * b * s * h * dh * (torch.finfo(dtype).bits // 8)
             + b * s * 4) / HBM_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= moved else (moved * 1e3,
                                                           "bytes")


def bwd_rows(shapes, runs: int, calls: int,
             dtype=torch.bfloat16) -> list[dict]:
    """#1b and SDPA's backward at ``shapes`` (name, B, S, H, Dh, padded) in
    ``dtype``: one JSON line each."""
    from keep_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, s, h, dh, padded in shapes:
        qkv = torch.randn(b, s, 3 * h * dh, device="cuda",
                          generator=gen).to(dtype)
        do = torch.randn(b, s, h * dh, device="cuda",
                         generator=gen).to(dtype)
        valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
        row = {"shape": name, "B": b, "S": s, "H": h, "Dh": dh,
               "padded": padded, "dtype": str(dtype)[6:]}
        try:
            got = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
        except (ValueError, RuntimeError) as e:
            print(json.dumps({**row, "refused": str(e)}), flush=True)
            continue
        ref = fa.attention_qkv_slab_bwd_reference(qkv, kb, do, h)
        g, r = got.float()[valid], ref.float()[valid]
        row.update(max_abs_err=(g - r).abs().max().item(),
                   finite=bool(torch.isfinite(got).all()))
        if dtype == torch.float32:
            row["within_gate"] = torch.allclose(got, ref, atol=2e-4,
                                                rtol=1e-4)
        else:
            row["gate"] = 1e-2 * r.abs().max().item()
        del got, ref, g, r
        kernel = lambda: fa.attention_qkv_slab_bwd(qkv, kb, do, h)  # noqa
        q, k, v = (t.detach().requires_grad_() for t in
                   qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4))
        mask = kb[:, None, None, :].to(dtype) if padded else None
        out = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)
        do4 = do.view(b, s, h, dh).transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, (q, k, v), do4, retain_graph=True)
        row["ms"] = events_ms(kernel, runs, calls)
        row["library_ms"] = events_ms(sdpa_bwd, runs, calls)
        row["dev_ms"], row["dev_ms_source"], by_kernel = device_kernels(
            kernel, calls, per_launch=2)
        row["dev_ms_by_kernel"] = by_kernel
        (row["library_dev_ms"], row["library_dev_ms_source"],
         lib_kernels) = device_kernels(sdpa_bwd, calls)
        row["library_kernel"] = (max(lib_kernels, key=lib_kernels.get)
                                 if lib_kernels else "not measured")
        row["bound_ms"], row["bound_by"] = bwd_bound_ms(b, s, h, dh, dtype)
        row["calls"] = calls
        print(json.dumps(row), flush=True)
        rows.append(row)
        del qkv, do, kb, out, q, k, v
        torch.cuda.empty_cache()
    return rows


def train_row(precision: str = "amp_bf16") -> dict:
    """chip_smoke.py's phase 9 from this checkout at ``precision``: its
    ``slab_attention`` and ``slab_attention_bwd`` family ms in the traced
    unfrozen step, ms per unfrozen step and peak memory."""
    import tempfile

    import chip_smoke as cs
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.kernels import flash_attention as fa

    cfg = KEEPConfig()
    blocks = cfg.vision.depth + cfg.text.num_hidden_layers
    with tempfile.TemporaryDirectory() as d:
        raw = cs.train_config(d, steps_per_epoch=4)
        raw["model"]["precision"] = precision
        out = cs.drive_train(torch, fa, d, raw, blocks=blocks,
                             steps_per_epoch=4)
    fams = out["traced_unfrozen_step"]["ms_by_family"]
    # the forward's kernels by name among the step's longest, for a
    # checkout whose families leave its fp32 forward out
    forward = sum(ms for k, ms in out["traced_unfrozen_step"]["top_kernels_ms"]
                  if "attention_f32" in k
                  or ("slab_attention" in k and "bwd" not in k))
    row = {"shape": "phase9_train", "precision": precision,
           "slab_attention_bwd_ms": fams.get("slab_attention_bwd"),
           "slab_attention_ms": fams.get("slab_attention") or forward,
           "device_busy_ms": out["traced_unfrozen_step"]["device_busy_ms"],
           "ms_per_unfrozen_step": out["ms_per_unfrozen_step"],
           "ms_per_frozen_step": out["ms_per_frozen_step"],
           "peak_memory_gb": out["peak_memory_gb"],
           "bwd_launches": out["bwd_launches"]}
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--edges", help="time only these comma-separated "
                    "lengths (B = 32, H = 16) at --widths")
    ap.add_argument("--widths", default="64,80",
                    help="head widths of --edges (default 64,80)")
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward (#1b) and SDPA's instead")
    ap.add_argument("--train", action="store_true",
                    help="with --bwd, also run chip_smoke.py's phase 9")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the forms to time")
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    shapes = SHAPES
    if args.edges:
        shapes = [(f"edge_dh{dh}", 32, int(s), 16, int(dh), False, False)
                  for dh in args.widths.split(",")
                  for s in args.edges.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from keep_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    if args.bwd:
        widths = [int(w) for w in args.widths.split(",")]
        edges = ([int(x) for x in args.edges.split(",")] if args.edges
                 else EDGE_S)
        shapes = (([] if args.edges else BWD_SHAPES)
                  + [(f"edge_dh{dh}", 32, s, 16, dh, False)
                     for dh in widths for s in edges])
        rows = bwd_rows(shapes, args.runs, args.calls, dtype)
        if args.train:
            rows.append(train_row("fp32" if dtype == torch.float32
                                  else "amp_bf16"))
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "rows": rows}, f)
        return
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, s, h, dh, padded, layouts in shapes:
        qkv = torch.randn(b, s, 3 * h * dh, device="cuda", generator=gen)
        qkv = qkv.to(dtype)
        kb = mask = None
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            kb = (torch.arange(s, device="cuda")[None] >= lens[:, None]
                  ).float() * -1e9
            mask = kb[:, None, None, :].to(dtype)
        row = {"shape": name, "B": b, "S": s, "H": h, "Dh": dh,
               "padded": padded, "dtype": args.dtype}
        try:
            got = fa.attention_qkv_slab(qkv, kb, num_heads=h)
        except ValueError as e:
            print(json.dumps({**row, "refused": str(e)}), flush=True)
            continue
        ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h)
        f32 = dict(num_heads=h, out_dtype=torch.float32)
        q, k, v = qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
        run = lambda fn: events_ms(fn, args.runs, args.calls)  # noqa: E731
        slab = lambda: fa.attention_qkv_slab(qkv, kb, num_heads=h)  # noqa
        slab32 = lambda: fa.attention_qkv_slab(qkv, kb, **f32)  # noqa
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask)
        row.update(
            max_abs_err=(got.float() - ref.float()).abs().max().item(),
            ms=run(slab), library_ms=run(sdpa))
        timed = [("dev_ms", slab), ("library_dev_ms", sdpa)]
        if dtype == torch.float32:
            valid = (torch.ones(b, s, dtype=torch.bool, device="cuda")
                     if kb is None else kb == 0)
            row["bits_equal_plain"] = torch.equal(got[valid], ref[valid])
            _, _, lib = device_kernels(sdpa, 1)
            row["library_kernel"] = (max(lib, key=lib.get) if lib
                                     else "not measured")
        else:
            row["f32_out_ms"] = run(slab32)
            timed.append(("f32_out_dev_ms", slab32))
        for key, fn in timed:
            row[key], row[f"{key}_source"] = device_ms(fn, args.calls)
        if layouts:
            lanes = [t.contiguous() for t in qkv.split(h * dh, dim=-1)]
            bhsd = [t.view(b, s, h, dh).transpose(1, 2) for t in lanes]
            bias4 = None if kb is None else kb[:, None, None, :]
            row.update(
                heads_ms=run(lambda: fa.attention_qkv_heads(
                    *lanes, kb, num_heads=h)),
                flash_attention_ms=run(lambda: fa.flash_attention(
                    *bhsd, bias4)),
                plain_ms=run(lambda: fa.attention_qkv_slab_reference(
                    qkv, kb, num_heads=h)))
        size = torch.finfo(dtype).bits // 8
        row["bound_ms"], row["bound_by"] = bound_ms(b, s, h, dh, size,
                                                    padded, dtype)
        if dtype == torch.bfloat16:
            row["f32_out_bound_ms"], _ = bound_ms(b, s, h, dh, 4, padded)
        row["calls"] = args.calls
        print(json.dumps(row), flush=True)
        rows.append(row)
        del qkv, ref, got
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f)


if __name__ == "__main__":
    main()
