"""Closed-loop offline tile extraction: ``wsi.extract.extract_features`` fed
from a seeded pool of uint8 tiles, cycled until the window ends, then
drained.

Traffic parameters (``traffic/<mix>.json``): ``tile`` (side of a uint8 RGB
tile), ``pool`` (tiles in the pool, a multiple of ``batch_size``),
``batch_size``, ``resize`` (the bicubic resize to the model's size on the
device), ``trace_seconds`` (the window of a traced run, at most
``--seconds``), ``rows_per_block`` (the reference's block of tiles).

Set-up: the weights on the device from the seed, the served model, the pool
(made on the device from the seed and brought to the host, where a slide
reader would leave it), and one pass of the pool through the pipeline,
which builds the kernels and warms every shape the window uses.

Output check: every row the window returned is held against the reference's
features of its tile (the pool is cycled, so row r is tile r mod pool).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import program, weights
from benchmark.reference import keep_ref
from benchmark.trace import span, traced


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5EED7113)
    t = traffic["tile"]
    pool = torch.randint(0, 256, (traffic["pool"], t, t, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    return pool.cpu().numpy()


def reference_features(cell, pool: np.ndarray, quant_bits) -> torch.Tensor:
    """The reference's features of every pool tile, on the cell's device."""
    cfg = cell.config
    sd = weights.make_state_dict(cfg["model"], cell.seed, cell.device)
    tiles = torch.from_numpy(pool).to(cell.device)
    return keep_ref.image_features(
        sd, cfg["model"], tiles, preprocess_cfg=cfg["preprocess"],
        block_gelu=cfg["block_gelu"], head_gelu=cfg["head_gelu"],
        quant_bits=quant_bits,
        rows_per_block=cell.traffic["rows_per_block"])


def widest_gap(feats: np.ndarray, ref: torch.Tensor) -> float:
    """The largest 1 − cos between a returned row and its tile's reference
    row (rows of the cycled pool); 2, the widest there is, for a
    non-finite row."""
    got = torch.from_numpy(feats).to(ref.device).float()
    want = ref[torch.arange(got.shape[0], device=ref.device) % ref.shape[0]]
    if not torch.isfinite(got).all():
        return 2.0
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    return float((1.0 - cos).max())


def run_extract(model, pool: np.ndarray, traffic: dict,
                seconds: float) -> tuple[np.ndarray, float, int]:
    """The window: chunks of the pool in turn until ``seconds`` have passed,
    then the drain. Returns (features, window seconds, tiles submitted)."""
    from keep_tpu_torch.wsi import extract as wsi_extract

    bs = traffic["batch_size"]
    nb = pool.shape[0] // bs
    sent = [0]

    def feed(deadline):
        j = 0
        while time.perf_counter() < deadline:
            with span("feed"):
                chunk = pool[(j % nb) * bs: (j % nb + 1) * bs]
            sent[0] += chunk.shape[0]
            yield chunk
            j += 1

    t0 = time.perf_counter()
    with span("extract_features"):
        feats = wsi_extract.extract_features(model, feed(t0 + seconds),
                                             batch_size=bs,
                                             resize=traffic["resize"])
    return feats, time.perf_counter() - t0, sent[0]


def setup(cell):
    """The served model and the tile pool, warmed: every kernel built and
    every shape of the window run once."""
    from keep_tpu_torch.wsi import extract as wsi_extract

    traffic, cfg = cell.traffic, cell.config
    if traffic["pool"] % traffic["batch_size"]:
        raise ValueError("the pool must be a whole number of batches")
    sd = weights.make_state_dict(cfg["model"], cell.seed, cell.device)
    model = program.build_keep(cfg, sd, cell.device)
    del sd
    pool = make_pool(traffic, cell.seed, cell.device)
    wsi_extract.extract_features(model, pool,
                                 batch_size=traffic["batch_size"],
                                 resize=traffic["resize"])
    if cell.device == "cuda":
        torch.cuda.synchronize()
    return model, pool


def free(model) -> None:
    del model
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, outcome) -> None:
    traffic = cell.traffic
    model, pool = setup(cell)
    outcome.e2e["setup_s"] = time.perf_counter() - cell.t_start

    seconds = (min(cell.seconds, traffic["trace_seconds"]) if cell.trace
               else cell.seconds)
    before = program.launches()
    with traced(cell.trace) as trace:
        feats, window_s, sent = run_extract(model, pool, traffic, seconds)
    outcome.launches = {k: v - before[k]
                        for k, v in program.launches().items()}
    trace.window_s = window_s
    outcome.trace, outcome.window_s = trace, window_s
    outcome.attempted, outcome.failed = sent, sent - feats.shape[0]
    outcome.e2e["tiles_per_s"] = feats.shape[0] / window_s
    outcome.work = {"tiles": int(feats.shape[0]),
                    "batch_size": traffic["batch_size"],
                    "batches": -(-sent // traffic["batch_size"])}
    if cell.device == "cuda":
        outcome.memory_peak_bytes = torch.cuda.max_memory_allocated()

    # the program's state is freed before the reference runs
    free(model)
    keep_ref.no_tf32()
    ref = reference_features(cell, pool, cell.config["quant_bits"])
    gap = widest_gap(feats, ref) if feats.shape[0] == sent else 2.0
    outcome.checks.append({"name": "max_1mcos", "value": gap,
                           "limit": cell.limits["max_1mcos"]["limit"]})


# ---- the readings behind the limits (benchmark/control.py) --------------------


def program_reading(cell) -> dict:
    """One short window at the cell's load, every returned row held to the
    reference."""
    model, pool = setup(cell)
    feats, _, sent = run_extract(model, pool, cell.traffic, cell.seconds)
    free(model)
    keep_ref.no_tf32()
    ref = reference_features(cell, pool, cell.config["quant_bits"])
    return {"max_1mcos": widest_gap(feats, ref) if feats.shape[0] == sent
            else 2.0}


def control_reading(cell) -> dict:
    """The next precision below the configuration's over the same tiles:
    for bf16 the program's own int8 path (``KEEPModel.quantize()``), held to
    the same fp32 reference; for int8 the reference's W4A4 form in the
    program's place, held to its W8A8 form."""
    from keep_tpu_torch.wsi import extract as wsi_extract

    pool = make_pool(cell.traffic, cell.seed, cell.device)
    bits = cell.config["quant_bits"]
    keep_ref.no_tf32()
    ref = reference_features(cell, pool, bits)
    if bits is None:
        cfg = dict(cell.config, precision="int8")
        sd = weights.make_state_dict(cfg["model"], cell.seed, cell.device)
        model = program.build_keep(cfg, sd, cell.device)
        del sd
        feats = wsi_extract.extract_features(
            model, pool, batch_size=cell.traffic["batch_size"],
            resize=cell.traffic["resize"])
        free(model)
    else:
        feats = reference_features(cell, pool, bits // 2).cpu().numpy()
    return {"max_1mcos": widest_gap(feats, ref)}


FAULTS: dict = {}
