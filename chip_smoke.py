#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``keep_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (a failing phase raises, and the script
exits non-zero without a result line):

1. device   — needs CUDA; prints the card and its power limit; TF32 off.
2. build    — compiles the CUDA kernels from ``keep_tpu_torch/kernels/csrc``.
3. kernel   — ``attention_qkv_slab`` against its plain PyTorch version at the
   serving shapes (ViT-L: B=32, S=197, H=16, no bias; BERT-base: B=32,
   S=256, H=12, padded key bias), in fp32 (atol = rtol = 2e-5) and bf16
   (max |Δ| < 0.05 on unpadded query rows), each timed with CUDA events.
4. server   — a full-width KEEP (ViT-L/16 + BERT-base) with random weights
   written in the released checkpoint layout, loaded by
   ``keep_tpu_torch.serve.build_server`` (bf16, fused attention), warmed up
   and driven over HTTP. The served features must be finite unit vectors of
   width 768 that agree (cosine ≥ 0.999) with the same weights run without
   the kernel, and the kernel's launch count must show that every block of
   every dispatch went through it.
5. numbers  — image and text throughput at bucket 128, and the device-time
   share of the attention kernel, beside the card's name and power limit.

Then one JSON line describing the kernels, and last the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def check_kernel(fa, torch, gen) -> list[dict]:
    shapes = [("vit_l16", 32, 197, 16, False), ("bert_base", 32, 256, 12, True)]
    rows = []
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
            row = {"shape": name, "B": b, "S": s, "H": h,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            phase("kernel", **row)
            rows.append(row)
    return rows


def write_model(d: str, torch, cfg, device: str = "cuda") -> None:
    from keep_tpu_torch.compat.torch_loader import random_keep_state_dict

    gen = torch.Generator(device=device).manual_seed(0)
    sd = random_keep_state_dict(cfg, gen, device=device)
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


def drive_server(torch, fa, serve, cfg, d: str, device: str = "cuda"):
    """Phase 4. Returns the phase's result and the running server core;
    the caller stops the core."""
    from keep_tpu_torch.models.keep import KEEPModel

    t0 = time.perf_counter()
    core, httpd = serve.build_server(["--model-dir", d, "--port", "0",
                                      "--device", device])
    setup_s = time.perf_counter() - t0
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(0)
        size = cfg.vision.img_size
        tiles = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
        odd = rng.integers(0, 256, (1, 260, 300, 3), dtype=np.uint8)
        sim_imgs = tiles[:2]

        stats0 = core.stats()
        with fa._launch_lock:
            fa.LAUNCHES = 0
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
        sim_err = float(np.abs(sim - img[:2] @ txt[:2].T).max())
        for k, c in cos.items():
            if not (c >= 0.999).all():
                raise AssertionError(f"{k}: cosine vs plain attention {c}")
        if sim_err > 1e-2:
            raise AssertionError(f"similarity vs features: {sim_err}")
        result = {"setup_s": setup_s, "launches": launches,
                  "image_dispatches": img_disp, "text_dispatches": txt_disp,
                  "min_cos_vs_plain": {k: float(c.min()) for k, c in
                                       cos.items()},
                  "similarity_max_err": sim_err}
        phase("server", **result)
        return result, core
    except BaseException:
        core.stop()
        raise
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def throughput(torch, core, rng) -> dict:
    """Serving throughput at bucket 128 through the server core (queue, H2D,
    dispatch, fetch), two callers at a time so that double buffering works,
    plus a device-time breakdown of one bucket-128 image dispatch."""
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
    plain = KEEPModel(model.cfg, dtype=model.dtype, use_flash=False,
                      device="cuda")
    plain.load_state_dict(model.state_dict())
    px = torch.from_numpy(tiles).cuda()
    ids = torch.zeros(128, 256, dtype=torch.long, device="cuda")
    mask = torch.ones_like(ids)
    dev_ms = {}
    with torch.inference_mode():
        for tag, m in (("kernel", model), ("plain", plain)):
            dev_ms[f"image_b128_{tag}_attention"] = cuda_ms(
                lambda: m.encode_image(normalize_only(px)), runs=10)
            dev_ms[f"text_b128x256_{tag}_attention"] = cuda_ms(
                lambda: m.encode_text(ids, mask), runs=10)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.encode_image(normalize_only(px))
            torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        by_kernel[ev.key[:80]] = ev.self_device_time_total / 1e3  # ms
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    attn = sum(v for k, v in by_kernel.items() if "slab_attention" in k)
    out = {"card": card(), "image_tiles_per_s_bucket128": img_rate,
           "text_prompts_per_s_bucket128x256": txt_rate,
           "device_ms": dev_ms,
           "image_b128_profiled_device_ms": total if total else "not measured",
           "attention_kernel_share_image_b128":
               attn / total if total else "not measured",
           "image_b128_top_kernels_ms": top}
    phase("numbers", **out)
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

    # 3. kernel vs plain at the serving shapes
    rows = check_kernel(fa, torch, torch.Generator(device="cuda").manual_seed(0))

    # 4. + 5. the server, end to end, and its numbers
    cfg = KEEPConfig()
    with tempfile.TemporaryDirectory() as d:
        write_model(d, torch, cfg)
        served, core = drive_server(torch, fa, serve, cfg, d)
    try:
        throughput(torch, core, np.random.default_rng(1))
    finally:
        core.stop()

    vit_bf16 = next(r for r in rows
                    if r["shape"] == "vit_l16" and r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "attention_qkv_slab", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": vit_bf16["ms"], "plain_ms": vit_bf16["plain_ms"],
        "shapes": rows}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
