"""Open-loop serving through ``serve.InferenceServer``, called in process as
``serve --int8`` builds it (without HTTP): Poisson arrivals at a fixed rate,
a mix of image requests (uint8 tiles at the model's size) and text requests
(prompt strings), each timed from its due time.

Traffic parameters (``traffic/<mix>.json``): ``rate_per_s``; ``image_share``;
``image_tiles`` ([least, most] tiles an image request, log-uniform);
``text_prompts`` ([least, most] prompts a text request) and
``prompt_tokens`` ([least, most] WordPiece tokens a prompt, [CLS] and [SEP]
included); ``tile_pool`` (distinct tiles, drawn from by every image
request); ``buckets`` and ``max_delay_ms`` (the server's); ``workers``
(caller threads); ``drain_seconds`` (how long past the window a request may
still finish); ``checked_requests`` (requests held to the reference);
``trace_seconds``.

Every seed gets the same requests, sizes and gaps between arrivals, in its
own order: the seed changes the order, the tiles and the words, not the
work. The tokenizer's vocabulary is written by the benchmark (``vocab``),
so that the reference tokenizes the same strings on its own.

Output check: a sample of the window's requests drawn from the seed, with
the largest image request and the longest text request in it; each
returned row against the reference's row (W8A8 in fp32 with the
configuration's GELU; the reference tokenizes the strings itself).
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import program, weights
from benchmark.reference import keep_ref
from benchmark.reference.wordpiece import WordPiece
from benchmark.trace import span, traced

SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
            103: "[MASK]"}
WORK_SEED = 0x5E27E  # the sizes and gaps every seed shares


def write_vocab(path: str, size: int) -> list[str]:
    """A WordPiece vocabulary of ``size`` entries in BERT's layout (the
    special tokens at their ids, then whole words and ``##`` pieces, drawn
    once from a fixed seed); returns the whole words."""
    rng = np.random.default_rng(0xB0CAB)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    seen, words, rows = set(), [], []
    for i in range(size):
        if i in SPECIALS:
            rows.append(SPECIALS[i])
        elif i < 104:
            rows.append(f"[unused{i}]")
        else:
            while True:
                piece = i % 5 == 0
                w = "".join(rng.choice(letters, rng.integers(2, 9)))
                tok = "##" + w if piece else w
                if tok not in seen:
                    break
            seen.add(tok)
            rows.append(tok)
            if not piece:
                words.append(w)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    return words


def make_schedule(traffic: dict, seconds: float, seed: int) -> list[dict]:
    """The window's requests in due order: ``due`` (seconds from the start),
    ``kind``, ``size`` (tiles or prompts)."""
    rate = traffic["rate_per_s"]
    n = max(1, int(round(rate * seconds)))
    work = np.random.default_rng(WORK_SEED)
    gaps = work.exponential(1.0 / rate, n)
    image = work.random(n) < traffic["image_share"]
    lo, hi = traffic["image_tiles"]
    tiles = np.clip(np.floor(np.exp(work.uniform(np.log(lo), np.log(hi + 1),
                                                 n))), lo, hi).astype(int)
    plo, phi = traffic["text_prompts"]
    prompts = work.integers(plo, phi + 1, n)
    order = np.random.default_rng(seed)
    g = gaps[order.permutation(n)]
    r = order.permutation(n)
    due = np.concatenate([[0.0], np.cumsum(g)[:-1]])
    return [{"due": float(due[i]), "kind": "image" if image[r[i]] else "text",
             "size": int(tiles[r[i]] if image[r[i]] else prompts[r[i]])}
            for i in range(n)]


def make_payloads(schedule: list, traffic: dict, words: list, seed: int,
                  pool: np.ndarray) -> None:
    """Fills each request's tiles (pool indices) or prompt strings."""
    rng = np.random.default_rng(seed ^ 0x9A71)
    tlo, thi = traffic["prompt_tokens"]
    for req in schedule:
        if req["kind"] == "image":
            req["tiles"] = rng.integers(0, len(pool), req["size"])
            continue
        prompts = []
        for _ in range(req["size"]):
            n = int(rng.integers(tlo, thi + 1)) - 2  # [CLS] and [SEP]
            ws = [words[i] for i in rng.integers(0, len(words), n)]
            prompts.append(" ".join(ws))
        req["prompts"] = prompts


def make_pool(traffic: dict, size: int, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5EED7113)
    return torch.randint(0, 256, (traffic["tile_pool"], size, size, 3),
                         generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()


class Served:
    """The served model behind ``InferenceServer``, warmed."""

    def __init__(self, cell, vocab_path: str):
        from keep_tpu_torch.factory import get_tokenizer
        from keep_tpu_torch.serve import InferenceServer

        cfg, traffic = cell.config, cell.traffic
        sd = weights.make_state_dict(cfg["model"], cell.seed, cell.device)
        self.model = program.build_keep(cfg, sd, cell.device)
        del sd
        m = cfg["model"]
        self.max_length = min(m["max_text_length"],
                              m["text"]["max_position_embeddings"])
        self.core = InferenceServer(
            self.model, get_tokenizer("bert", vocab_path),
            max_length=self.max_length, image_size=m["vision"]["img_size"],
            buckets=tuple(traffic["buckets"]),
            max_delay_ms=traffic["max_delay_ms"])
        self.core.warmup()

    def close(self) -> None:
        self.core.stop()


def run_window(core, schedule: list, pool: np.ndarray, traffic: dict,
               keep: set) -> dict:
    """Sends every request at its due time from ``traffic['workers']``
    caller threads and waits for each, at most ``drain_seconds`` past the
    last due time. Returns latencies (seconds, None for a request that
    failed or never came), the results of the requests in ``keep``, the
    generator's largest lateness and the window's span."""
    n = len(schedule)
    lat: list = [None] * n
    out: dict = {}
    lock = threading.Lock()

    def call(i: int, due: float) -> None:
        req = schedule[i]
        try:
            if req["kind"] == "image":
                got = core.encode_image(pool[req["tiles"]])
            else:
                got = core.encode_text(req["prompts"])
        except Exception:  # a failed request counts as over any limit
            return
        done = time.perf_counter()
        with lock:
            lat[i] = done - due
            if i in keep:
                out[i] = got

    lag = 0.0
    with ThreadPoolExecutor(max_workers=traffic["workers"]) as ex:
        futures = []
        t0 = time.perf_counter() + 0.01
        with span("send"):
            for i, req in enumerate(schedule):
                due = t0 + req["due"]
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                lag = max(lag, time.perf_counter() - due)
                futures.append(ex.submit(call, i, due))
        end = t0 + schedule[-1]["due"]
        with span("drain"):
            for f in futures:
                left = end + traffic["drain_seconds"] - time.perf_counter()
                try:
                    f.result(timeout=max(left, 0.0))
                except TimeoutError:
                    break
    return {"latency": lat, "results": out, "lag_s": lag,
            "span_s": max(end - t0, 1e-9),
            "last_done_s": time.perf_counter() - t0}


def p95_ms(latency: list, give_up_s: float) -> float:
    """The 95th percentile over all requests, a request that failed or
    never came taken at ``give_up_s`` (over any limit)."""
    vals = [give_up_s if v is None else v for v in latency]
    return float(np.percentile(vals, 95)) * 1e3


def checked(schedule: list, seed: int, k: int) -> set:
    """The requests held to the reference: ``k`` drawn from the seed, and
    the largest image request and the longest text request."""
    rng = np.random.default_rng(seed ^ 0xC4EC)
    pick = set(rng.choice(len(schedule), min(k, len(schedule)),
                          replace=False).tolist())
    for kind in ("image", "text"):
        idx = [i for i, r in enumerate(schedule) if r["kind"] == kind]
        if idx:
            pick.add(max(idx, key=lambda i: (
                schedule[i]["size"],
                sum(len(p) for p in schedule[i].get("prompts", ())))))
    return pick


def reference_gaps(cell, schedule: list, results: dict, pool: np.ndarray,
                   vocab_path: str, quant_bits) -> dict:
    """The widest 1 − cos of each tower's returned rows against the
    reference's (2 where a checked request has no rows)."""
    cfg = cell.config
    dev = cell.device
    m = cfg["model"]
    sd = weights.make_state_dict(m, cell.seed, dev)
    gaps = {"image": 0.0, "text": 0.0}
    img = [i for i in sorted(results) if schedule[i]["kind"] == "image"]
    txt = [i for i in sorted(results) if schedule[i]["kind"] == "text"]
    if img:
        tower = keep_ref.ImageTower(sd, m, block_gelu=cfg["block_gelu"],
                                    head_gelu=cfg["head_gelu"],
                                    quant_bits=quant_bits)
        pc = cfg["preprocess"]
        for i in img:
            tiles = torch.from_numpy(pool[schedule[i]["tiles"]]).to(dev)
            px = keep_ref.normalize(tiles, pc["mean"], pc["std"])
            gaps["image"] = max(gaps["image"],
                                _gap(results[i], tower(px)))
        del tower
    if txt:
        tok = WordPiece(vocab_path)
        L = min(m["max_text_length"], m["text"]["max_position_embeddings"])
        tower = keep_ref.TextTower(sd, m, block_gelu=cfg["block_gelu"],
                                   quant_bits=quant_bits)
        for i in txt:
            enc = [tok.encode(p, L) for p in schedule[i]["prompts"]]
            ids = torch.tensor([e[0] for e in enc], device=dev)
            mask = torch.tensor([e[1] for e in enc], device=dev)
            gaps["text"] = max(gaps["text"], _gap(results[i], tower(ids, mask)))
    return gaps


def _gap(got: np.ndarray, want: torch.Tensor) -> float:
    g = torch.from_numpy(np.asarray(got)).to(want.device).float()
    if g.shape != want.shape or not torch.isfinite(g).all():
        return 2.0
    cos = torch.nn.functional.cosine_similarity(g, want, dim=-1)
    return float((1.0 - cos).max())


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pad_counts(stats: dict) -> tuple[int, int]:
    """(rows computed, rows served) over both towers of ``stats()``."""
    computed = sum(int(b) * h for t in ("image", "text")
                   for b, h in stats[t]["bucket_hits"].items())
    return computed, sum(stats[t]["served"] for t in ("image", "text"))


def run(cell, outcome) -> None:
    traffic, cfg = cell.traffic, cell.config
    tmp = tempfile.mkdtemp(prefix="bench_vocab_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        words = write_vocab(vocab, cfg["model"]["text"]["vocab_size"])
        size = cfg["model"]["vision"]["img_size"]
        served = Served(cell, vocab)
        pool = make_pool(traffic, size, cell.seed, cell.device)
        seconds = (min(cell.seconds, traffic["trace_seconds"]) if cell.trace
                   else cell.seconds)
        schedule = make_schedule(traffic, seconds, cell.seed)
        make_payloads(schedule, traffic, words, cell.seed, pool)
        keep = checked(schedule, cell.seed, traffic["checked_requests"])
        if cell.device == "cuda":
            torch.cuda.synchronize()
        outcome.e2e["setup_s"] = time.perf_counter() - cell.t_start

        before = program.launches()
        c0, s0 = pad_counts(served.core.stats())
        with traced(cell.trace) as trace:
            got = run_window(served.core, schedule, pool, traffic, keep)
        c1, s1 = pad_counts(served.core.stats())
        outcome.launches = {k: v - before[k]
                            for k, v in program.launches().items()}
        trace.window_s = got["last_done_s"]
        outcome.trace, outcome.window_s = trace, got["span_s"]
        lat = got["latency"]
        outcome.attempted = len(lat)
        outcome.failed = sum(v is None for v in lat)
        give_up = got["span_s"] + traffic["drain_seconds"]
        outcome.e2e["p95_ms"] = p95_ms(lat, give_up)
        outcome.work = {"requests": len(lat), "rows_computed": c1 - c0,
                        "rows_served": s1 - s0, "lag_s": got["lag_s"]}
        if cell.device == "cuda":
            outcome.memory_peak_bytes = torch.cuda.max_memory_allocated()
        served.close()
        del served
        free()
        keep_ref.no_tf32()
        gaps = reference_gaps(cell, schedule, got["results"], pool, vocab,
                              cfg["quant_bits"])
        missing = keep - set(got["results"])
        for tower in ("image", "text"):
            name = f"{tower}_1mcos"
            value = 2.0 if missing else gaps[tower]
            outcome.checks.append({"name": name, "value": value,
                                   "limit": cell.limits[name]["limit"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the readings behind the limits (benchmark/control.py) --------------------


def _short_window(cell):
    """A short window at the cell's load: (schedule, results, pool, vocab
    dir); the caller removes the vocab dir."""
    traffic, cfg = cell.traffic, cell.config
    tmp = tempfile.mkdtemp(prefix="bench_vocab_")
    vocab = os.path.join(tmp, "vocab.txt")
    words = write_vocab(vocab, cfg["model"]["text"]["vocab_size"])
    served = Served(cell, vocab)
    pool = make_pool(traffic, cfg["model"]["vision"]["img_size"], cell.seed,
                     cell.device)
    schedule = make_schedule(traffic, cell.seconds, cell.seed)
    make_payloads(schedule, traffic, words, cell.seed, pool)
    keep = checked(schedule, cell.seed, traffic["checked_requests"])
    got = run_window(served.core, schedule, pool, traffic, keep)
    served.close()
    del served
    free()
    return schedule, got["results"], pool, tmp, vocab


def program_reading(cell) -> dict:
    schedule, results, pool, tmp, vocab = _short_window(cell)
    try:
        keep_ref.no_tf32()
        gaps = reference_gaps(cell, schedule, results, pool, vocab,
                              cell.config["quant_bits"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {f"{k}_1mcos": v for k, v in gaps.items()}


def control_reading(cell) -> dict:
    """The reference's W4A4 form in the program's place, on the requests a
    short window checks, held to its W8A8 form."""
    traffic, cfg = cell.traffic, cell.config
    tmp = tempfile.mkdtemp(prefix="bench_vocab_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        words = write_vocab(vocab, cfg["model"]["text"]["vocab_size"])
        pool = make_pool(traffic, cfg["model"]["vision"]["img_size"],
                         cell.seed, cell.device)
        schedule = make_schedule(traffic, cell.seconds, cell.seed)
        make_payloads(schedule, traffic, words, cell.seed, pool)
        keep = checked(schedule, cell.seed, traffic["checked_requests"])
        keep_ref.no_tf32()
        low = reference_rows(cell, schedule, keep, pool, vocab,
                             cfg["quant_bits"] // 2)
        gaps = reference_gaps(cell, schedule, low, pool, vocab,
                              cfg["quant_bits"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {f"{k}_1mcos": v for k, v in gaps.items()}


def reference_rows(cell, schedule, keep, pool, vocab_path, quant_bits):
    """The reference's rows of the requests in ``keep``, at ``quant_bits``."""
    cfg, dev = cell.config, cell.device
    m = cfg["model"]
    sd = weights.make_state_dict(m, cell.seed, dev)
    image = keep_ref.ImageTower(sd, m, block_gelu=cfg["block_gelu"],
                                head_gelu=cfg["head_gelu"],
                                quant_bits=quant_bits)
    text = keep_ref.TextTower(sd, m, block_gelu=cfg["block_gelu"],
                              quant_bits=quant_bits)
    tok = WordPiece(vocab_path)
    L = min(m["max_text_length"], m["text"]["max_position_embeddings"])
    pc = cfg["preprocess"]
    out = {}
    with torch.no_grad():
        for i in keep:
            req = schedule[i]
            if req["kind"] == "image":
                px = keep_ref.normalize(
                    torch.from_numpy(pool[req["tiles"]]).to(dev),
                    pc["mean"], pc["std"])
                out[i] = image(px).cpu().numpy()
            else:
                enc = [tok.encode(p, L) for p in req["prompts"]]
                out[i] = text(torch.tensor([e[0] for e in enc], device=dev),
                              torch.tensor([e[1] for e in enc],
                                           device=dev)).cpu().numpy()
    return out


FAULTS: dict = {}


def sweep(cell, rates: list) -> list:
    """The knee's search, made once when the cell is defined: one server,
    a window of ``cell.seconds`` at each rate in turn. Each row: the rate,
    p50 and p95 (ms), failures, the generator's lateness and the backlog's
    trend (the median latency of the last quarter of requests over the
    first quarter's). Stops at the first rate that fails a request or
    whose backlog more than doubles."""
    traffic, cfg = cell.traffic, cell.config
    tmp = tempfile.mkdtemp(prefix="bench_vocab_")
    rows = []
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        words = write_vocab(vocab, cfg["model"]["text"]["vocab_size"])
        served = Served(cell, vocab)
        pool = make_pool(traffic, cfg["model"]["vision"]["img_size"],
                         cell.seed, cell.device)
        for rate in rates:
            t = dict(traffic, rate_per_s=rate)
            schedule = make_schedule(t, cell.seconds, cell.seed)
            make_payloads(schedule, t, words, cell.seed, pool)
            c0, s0 = pad_counts(served.core.stats())
            got = run_window(served.core, schedule, pool, t, set())
            c1, s1 = pad_counts(served.core.stats())
            lat = got["latency"]
            done = [v for v in lat if v is not None]
            q = max(1, len(lat) // 4)
            first = [v for v in lat[:q] if v is not None]
            last = [v for v in lat[-q:] if v is not None]
            rows.append({
                "rate_per_s": rate, "requests": len(lat),
                "failed": len(lat) - len(done),
                "p50_ms": float(np.median(done)) * 1e3 if done else None,
                "p95_ms": p95_ms(lat, got["span_s"] + t["drain_seconds"]),
                "lag_s": got["lag_s"],
                "backlog_trend": (float(np.median(last) / np.median(first))
                                  if first and last else None),
                "pad_share": 100.0 * (c1 - c0 - (s1 - s0)) / max(c1 - c0, 1)})
            if rows[-1]["failed"] or (rows[-1]["backlog_trend"] or 0) > 2.0:
                break  # past the knee: higher rates only pile up a queue
        served.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows
