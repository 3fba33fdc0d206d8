"""Batching inference server for the KEEP API (counterpart of
``keep_tpu/serve.py``).

- **Fixed batch buckets.** Every request is padded up to the nearest bucket
  (default 1/8/32/128), and ``warmup()`` runs each bucket once before the
  server accepts traffic.
- **Micro-batching.** Requests queue; a dispatcher thread per tower drains up
  to the largest bucket every ``max_delay_ms`` (or at once when a full
  bucket waits), runs one device dispatch, and fans the results back out.
- **Double buffering.** ``launch`` copies the padded batch from pinned host
  memory to the card without waiting and returns the unfinished CUDA
  result; ``fetch`` (``.cpu().numpy()``) waits for it one dispatch later, so
  the host assembles batch N+1 while the card computes batch N.
- **Data parallelism** (``mesh=``, ``--mesh-dp N``): the model is
  replicated on each of the mesh's N cards, every bucket is rounded up to a
  multiple of N, and a dispatch splits into N contiguous chunks, each
  copied to its card and launched on that card's current stream without a
  host sync between them; the fetch takes the chunks back in order.

HTTP layer (stdlib ``ThreadingHTTPServer``):
POST /encode_text      {"texts": ["...", ...]}           → {"embeddings": [[...]]}
POST /encode_image     {"images": [[H,W,3] uint8 lists]} → {"embeddings": [[...]]}
POST /encode_image_npy <raw .npy uint8 [N,H,W,3] body>   → raw .npy fp32 [N,D]
POST /similarity       {"texts": [...], "images": [...]} → {"logits": [[...]]}
GET  /healthz, GET /stats

CLI: ``python -m keep_tpu_torch.serve --model-dir <released checkpoint>
[--int8]`` serves the bf16 model with the fused attention kernel on the
card, or with ``--int8`` the W8A8 model (``KEEPModel.quantize``) through the
int8 megakernels of both towers. ``--precision-policy auto`` (the default)
measures the round trip to the card (``utils.rtt.measure_rtt``):
co-located, int8 serves every bucket; on a link above
``rtt.RTT_COLOCATED_MS`` it times B=1 int8 and bf16 image dispatches
(``rtt.pick_by_probe``) and serves image bucket 1 from the bf16 model
(``alt_model`` / ``alt_buckets``) only when bf16 wins by more than the
probe's margin; otherwise the bf16 weights are dropped before warmup.
``all-int8`` serves int8 everywhere. ``--lora <checkpoints dir>``
merges the adapters a LoRA fine-tune wrote (``train/lora.py``) into the
model at startup, with the scale ``--lora-scale`` or, by default, the run's
``params.txt``; with ``--int8`` the merged fp32 values are quantized.
``--mesh-dp N`` serves over the first N cards (the JAX server's flag; with
``--int8``, ``--lora`` and the int8 artifact too).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from keep_tpu_torch.configs import PreprocessConfig
from keep_tpu_torch.ops.preprocess import (crop_window, normalize_only,
                                           resized_output_size)
from keep_tpu_torch.parallel import batch_sharding, make_mesh, replicate

_BUCKETS = (1, 8, 32, 128)


def _bucket(n: int, buckets=_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _Request:
    __slots__ = ("payload", "event", "result", "error")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error = None


class BatchQueue:
    """Micro-batching front of one device function: callers enqueue items,
    the dispatcher drains, pads to a bucket and runs one dispatch.

    A dispatch is split into ``launch`` (host→device copy and the
    asynchronous device call, returning an unfetched handle) and ``fetch``
    (waits, returns numpy), so that batch N+1 is assembled and uploaded
    while batch N computes."""

    def __init__(self, launch, max_batch: int, max_delay_ms: float = 3.0,
                 name: str = "q", fetch=None, bucket_of=None):
        self.launch = launch  # (np stacked [N, ...]) -> handle
        self.fetch = fetch or (lambda h: h)  # handle -> np [N, D]
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.q: queue.Queue[_Request] = queue.Queue()
        self._held: _Request | None = None
        self.name = name
        self.served = 0
        self.dispatches = 0
        self.bucket_of = bucket_of  # raw batch size -> padded bucket
        self.bucket_hits: dict[int, int] = {}
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=f"batcher-{name}")
        self.thread.start()

    def submit(self, items: np.ndarray) -> np.ndarray:
        """Blocking: returns the results for this caller's items. Requests
        larger than the biggest bucket are split into bucket-sized chunks."""
        if len(items) > self.max_batch:
            return np.concatenate([
                self.submit(items[i: i + self.max_batch])
                for i in range(0, len(items), self.max_batch)
            ], axis=0)
        r = _Request(items)
        self.q.put(r)
        r.event.wait()
        if r.error is not None:
            raise r.error
        return r.result

    def _collect(self, block: bool):
        # a request held back because it would have overflowed the bucket
        # leads the next batch
        first = self._held
        self._held = None
        if first is None:
            try:
                first = self.q.get(timeout=0.1 if block else 0)
            except queue.Empty:
                return None
        batch = [first]
        count = len(first.payload)
        deadline = time.time() + self.max_delay
        while count < self.max_batch:
            timeout = deadline - time.time()
            if timeout <= 0:
                break
            try:
                r = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if count + len(r.payload) > self.max_batch:
                self._held = r
                break
            batch.append(r)
            count += len(r.payload)
        return batch

    def _launch(self, batch):
        try:
            stacked = np.concatenate([r.payload for r in batch], axis=0)
            return self.launch(stacked), len(stacked)
        except Exception as e:  # the batch's callers get the error
            for r in batch:
                r.error = e
                r.event.set()
            return None, 0

    def _resolve(self, batch, handle, n):
        try:
            out = self.fetch(handle)
            self.served += n
            self.dispatches += 1
            if self.bucket_of is not None:
                b = self.bucket_of(n)
                self.bucket_hits[b] = self.bucket_hits.get(b, 0) + 1
            off = 0
            for r in batch:
                k = len(r.payload)
                r.result = out[off: off + k]
                off += k
        except Exception as e:  # the batch's callers get the error
            for r in batch:
                r.error = e
        finally:
            for r in batch:
                r.event.set()

    def _loop(self):
        inflight = None  # (batch, handle, n) computing on the device
        while not self._stop.is_set():
            batch = self._collect(block=inflight is None)
            if batch is not None:
                handle, n = self._launch(batch)
                nxt = (batch, handle, n) if handle is not None else None
            else:
                nxt = None
            if inflight is not None:
                self._resolve(*inflight)
            inflight = nxt
        if inflight is not None:
            self._resolve(*inflight)
        # fail the stragglers so that no caller waits on a stopped queue
        leftovers = [self._held] if self._held is not None else []
        self._held = None
        while True:
            try:
                leftovers.append(self.q.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            r.error = RuntimeError(f"batch queue '{self.name}' stopped")
            r.event.set()

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=5)


def _fetch(handle: list) -> np.ndarray:
    """The features of one chunk per mesh device, in order."""
    if len(handle) == 1:
        return handle[0].cpu().numpy()
    return np.concatenate([h.cpu().numpy() for h in handle])


class InferenceServer:
    """Model-side server core (HTTP-free; ``make_http_server`` wraps it).
    The model's device is the device of its parameters.

    ``mesh`` (``parallel.make_mesh``): a tuple of devices to serve over, the
    model replicated on each; buckets round up to multiples of its size.

    ``alt_model`` / ``alt_buckets``: the per-bucket precision policy.
    ``alt_buckets`` maps a tower (``"image"``, ``"text"``) to the buckets
    that ``alt_model`` serves in place of ``model`` (``{"image": (1,)}``
    serves image bucket 1 from the bf16 model beside an int8 primary);
    ``alt_model`` is replicated over the mesh as ``model`` is, and
    ``warmup`` runs, for every (tower, bucket), the model that serves it."""

    def __init__(self, model, tokenizer, *, max_length: int = 256,
                 image_size: int = 224, buckets=_BUCKETS,
                 max_delay_ms: float = 3.0, mesh=None,
                 alt_model=None, alt_buckets=None):
        self.alt_buckets = {k: frozenset(v)
                            for k, v in (alt_buckets or {}).items()}
        if any(self.alt_buckets.values()) and alt_model is None:
            raise ValueError("alt_buckets given without alt_model")
        n = 1 if mesh is None else len(mesh)
        if n > 1:
            buckets = sorted({max(b, n) + (-max(b, n)) % n for b in buckets})
        self.buckets = tuple(buckets)
        # fail fast on a policy bucket that can never be hit: a typo, or a
        # bucket the mesh rounding removed, would serve the primary model
        # where the policy asked for the other
        for tower, alts in self.alt_buckets.items():
            if tower not in ("image", "text"):
                raise ValueError(
                    f"alt_buckets tower {tower!r} unknown (must be 'image' "
                    f"or 'text') — a typo here would silently serve the "
                    f"primary model for every request")
            stray = alts - set(self.buckets)
            if stray:
                raise ValueError(
                    f"alt_buckets[{tower!r}] contains {sorted(stray)} not in "
                    f"the compiled buckets {self.buckets} (mesh rounding "
                    f"rewrites buckets to multiples of the dp axis)")
        self.model = model
        self.alt_model = alt_model
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = image_size
        self.device = next(model.parameters()).device
        # without a mesh: the model's own device, a mesh of one
        self.mesh = (self.device,) if mesh is None else tuple(mesh)
        self._replicas = replicate(self.mesh, model)
        self._alt_replicas = (None if alt_model is None
                              else replicate(self.mesh, alt_model))
        self._pcfg = PreprocessConfig(size=image_size)
        _b_of = lambda n: _bucket(n, self.buckets)  # noqa: E731
        self.text_q = BatchQueue(self._launch_text, self.buckets[-1],
                                 max_delay_ms, "text", fetch=_fetch,
                                 bucket_of=_b_of)
        self.image_q = BatchQueue(self._launch_image, self.buckets[-1],
                                  max_delay_ms, "image", fetch=_fetch,
                                  bucket_of=_b_of)
        self.started = time.time()

    @staticmethod
    def _put(host: torch.Tensor, device: torch.device) -> torch.Tensor:
        if device.type != "cuda":
            return host.to(device)
        return host.pin_memory().to(device, non_blocking=True)

    def _padded(self, arr: np.ndarray) -> torch.Tensor:
        """The batch padded to its bucket, on the host; padded tail rows are
        computed and never read back."""
        n = len(arr)
        pad = np.zeros((_bucket(n, self.buckets) - n,) + arr.shape[1:],
                       arr.dtype)
        return torch.from_numpy(np.concatenate([arr, pad], 0))

    def _replicas_for(self, tower: str, n: int) -> list:
        """The replicas of the model that serves ``n`` rows of ``tower``."""
        if _bucket(n, self.buckets) in self.alt_buckets.get(tower, ()):
            return self._alt_replicas
        return self._replicas

    def _dispatch(self, arr: np.ndarray, encode, tower: str):
        """Starts ``encode(model, device batch)`` on the padded batch, with
        the model that serves its (tower, bucket), and returns the unfetched
        result, one tensor a mesh device: each chunk copied to its card and
        launched there."""
        host = self._padded(arr)
        out = []
        with torch.inference_mode():
            for rows, device, m in zip(batch_sharding(self.mesh, len(host)),
                                       self.mesh,
                                       self._replicas_for(tower, len(arr))):
                with (torch.cuda.device(device) if device.type == "cuda"
                      else contextlib.nullcontext()):
                    out.append(encode(m, self._put(host[rows], device)))
        return out

    def _launch_text(self, ids_mask: np.ndarray):
        return self._dispatch(
            ids_mask.astype(np.int64),
            lambda m, im: m.encode_text(im[:, 0], im[:, 1]),  # unfetched
            "text")

    def _launch_image(self, tiles_u8: np.ndarray):
        # tiles travel as raw uint8 and are normalised on the device inside
        # this dispatch; only the [N, D] features come back
        return self._dispatch(
            tiles_u8,
            lambda m, px: m.encode_image(normalize_only(px, self._pcfg)),
            "image")

    # -- public API ---------------------------------------------------------

    def encode_text(self, texts: list[str]) -> np.ndarray:
        enc = self.tokenizer(texts, max_length=self.max_length)
        ids_mask = np.stack(
            [np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])],
            axis=1)  # [N, 2, S]: one queue payload carries both
        return self.text_q.submit(ids_mask)

    def encode_image(self, images: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W, 3] (any H/W) → [N, D] unit features. Model-size
        tiles go to the device as they are; other sizes are resized on the
        host with PIL (bicubic shortest side, then center crop: the
        published eval transform)."""
        arr = np.asarray(images)
        if arr.ndim == 3:
            arr = arr[None]
        s = self.image_size
        if arr.shape[1:3] != (s, s):
            from PIL import Image

            tiles = []
            for im in arr:
                h, w = im.shape[:2]
                oh, ow = resized_output_size(h, w, s)
                pil = Image.fromarray(im).resize((ow, oh), Image.BICUBIC)
                top, left = crop_window(oh, s), crop_window(ow, s)
                tiles.append(np.asarray(pil)[top: top + s, left: left + s])
            arr = np.stack(tiles)
        return self.image_q.submit(np.ascontiguousarray(arr, np.uint8))

    def similarity(self, texts: list[str], images: np.ndarray) -> np.ndarray:
        # the two towers have their own queues: encode concurrently
        out: dict = {}

        def _img():
            try:
                out["img"] = self.encode_image(images)
            except Exception as e:  # surfaced to the caller below
                out["err"] = e

        t = threading.Thread(target=_img)
        t.start()
        txt = self.encode_text(texts)
        t.join()
        if "err" in out:
            raise out["err"]
        return out["img"] @ txt.T

    def warmup(self) -> None:
        """Runs every bucket of both towers once before serving, each on the
        model that serves it."""
        for b in self.buckets:
            self.encode_text(["warmup"] * b)
            self.encode_image(
                np.zeros((b, self.image_size, self.image_size, 3), np.uint8))

    def stats(self) -> dict:
        return {
            "uptime_s": round(time.time() - self.started, 1),
            "text": {"served": self.text_q.served,
                     "dispatches": self.text_q.dispatches,
                     "bucket_hits": dict(self.text_q.bucket_hits)},
            "image": {"served": self.image_q.served,
                      "dispatches": self.image_q.dispatches,
                      "bucket_hits": dict(self.image_q.bucket_hits)},
            "buckets": list(self.buckets),
            "mesh": len(self.mesh),
        }

    def stop(self):
        self.text_q.stop()
        self.image_q.stop()


def make_http_server(core: InferenceServer, port: int = 0,
                     host: str = "127.0.0.1") -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, core.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if self.path == "/encode_image_npy":
                    # binary path: the body is one .npy uint8 [N, H, W, 3]
                    arr = np.load(io.BytesIO(self.rfile.read(n)),
                                  allow_pickle=False)
                    out = core.encode_image(np.asarray(arr, np.uint8))
                    buf = io.BytesIO()
                    np.save(buf, np.asarray(out, np.float32))
                    body = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/encode_text":
                    out = core.encode_text(list(req["texts"]))
                    self._json(200, {"embeddings": out.tolist()})
                elif self.path == "/encode_image":
                    imgs = np.asarray(req["images"], np.uint8)
                    out = core.encode_image(imgs)
                    self._json(200, {"embeddings": out.tolist()})
                elif self.path == "/similarity":
                    out = core.similarity(
                        list(req["texts"]), np.asarray(req["images"], np.uint8))
                    self._json(200, {"logits": out.tolist()})
                else:
                    self._json(404, {"error": f"no route {self.path}"})
            except Exception as e:  # a bad request must not stop the server
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def lora_scale_for(lora_dir: str, scale: float | None) -> float:
    """The LoRA scale α / r: ``scale`` when given, else from the training
    run's ``params.txt`` (``solver.lora_alpha / lora_rank``) in
    ``lora_dir`` or beside it; exits naming ``--lora-scale`` when there is
    neither, so that a wrong scale is never served."""
    if scale is not None:
        return scale
    for cand in (os.path.join(lora_dir, "params.txt"),
                 os.path.join(os.path.dirname(lora_dir.rstrip("/")),
                              "params.txt")):
        if os.path.exists(cand):
            with open(cand) as f:
                solver = json.load(f).get("solver", {})
            rank = int(solver.get("lora_rank") or 0)
            if rank > 0:
                scale = float(solver.get("lora_alpha", 16.0)) / rank
                print(f"LoRA scale {scale} from {cand}", flush=True)
                return scale
            break
    raise SystemExit(
        f"--lora: no params.txt with solver.lora_rank found near "
        f"{lora_dir}; pass --lora-scale (alpha / rank)")


def build_server(argv=None):
    """Parses the CLI, loads the model, builds and warms the server core and
    binds the HTTP server. Returns ``(core, httpd)``; nothing is served yet."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-dir", required=True,
                    help="released-checkpoint dir (config.json + "
                         "pytorch_model.bin + vocab.txt)")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--max-delay-ms", type=float, default=3.0)
    ap.add_argument("--int8", action="store_true",
                    help="serve the W8A8 megakernel path")
    ap.add_argument("--precision-policy", choices=("auto", "all-int8"),
                    default="auto",
                    help="with --int8: 'auto' measures the link and, "
                         "where its round trip sets B=1 latency, times B=1 "
                         "int8 against bf16 image dispatches and serves "
                         "image bucket 1 from the winner (int8 keeps its "
                         "seat within 10%%); co-located, int8 at every "
                         "bucket, as 'all-int8' always")
    ap.add_argument("--lora", default="",
                    help="LoRA adapter checkpoint dir (the training CLI's "
                         "checkpoints/ with solver.lora_rank > 0), merged "
                         "into the base weights at startup")
    ap.add_argument("--lora-scale", type=float, default=None,
                    help="alpha / rank used in training; default: read "
                         "solver.lora_alpha / lora_rank from the run's "
                         "params.txt beside the checkpoint dir")
    ap.add_argument("--mesh-dp", type=int, default=0,
                    help="serve over the first N cards (data parallel: the "
                         "model replicated, each dispatch split N ways)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the "
                         "CPU")
    mesh = None
    if args.mesh_dp:
        # the cards from the first (or the one --device names); on the CPU
        # the one CPU device
        present = ([device] if device.type != "cuda" or device.index
                   is not None else None)
        mesh = make_mesh(args.mesh_dp, devices=present)
        device = mesh[0]

    from keep_tpu_torch.compat.export import QUANTIZED_SUBDIR
    from keep_tpu_torch.factory import get_tokenizer
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.utils import rtt

    artifact = os.path.isdir(os.path.join(args.model_dir, QUANTIZED_SUBDIR))
    if args.lora and artifact:
        raise SystemExit(
            "--lora cannot merge adapters into a quantized artifact (int8 "
            "kernels); merge into the fp model first, then quantize + "
            "save_quantized")
    # --precision-policy auto decides image bucket 1's precision by
    # measurement: on a link whose round trip sets small-batch latency the
    # B=1 winner flips with the link's jitter, so the real int8 and bf16
    # dispatches are timed; co-located, int8 wins at every bucket and
    # nothing is probed. Not under --mesh-dp, nor for the int8 artifact
    # (no bf16 weights to fall back on), as in the JAX server.
    policy = (args.int8 and args.precision_policy == "auto" and not mesh
              and not artifact)
    link = rtt.measure_rtt(device=device) if policy else None
    probe = policy and rtt.rtt_dominated(link)
    # the published quick-start setting: bf16 with the fused attention
    # kernel; --int8 quantizes from the checkpoint's fp32 values (the load
    # quantizes its own model unless the bf16 one is still needed), unless
    # the dir carries the int8 deploy artifact, which loads as it is
    model = KEEPModel.from_pretrained(
        args.model_dir, dtype=torch.bfloat16, use_flash=True, device=device,
        quantize=args.int8 and not args.lora and not probe)
    if args.lora:
        # merged into the fp32 values, rounded once into the stored
        # weights; --int8 then quantizes the merged fp32 values
        from keep_tpu_torch.train import checkpoint as ckpt
        from keep_tpu_torch.train import lora

        scale = lora_scale_for(args.lora, args.lora_scale)
        restored = ckpt.restore(args.lora)
        lora.merge_into_model(model, restored["params"], scale)
        print(f"merged LoRA adapters from {args.lora} (epoch "
              f"{restored['epoch']}, scale {scale})", flush=True)
    bf16_model = None
    if args.int8 and not artifact and (args.lora or probe):
        bf16_model, model = model, model.quantize()
    alt_model, alt_buckets = None, None
    if args.int8 and artifact:
        # the pre-calibrated deploy artifact (compat.export.save_quantized):
        # already int8, nothing to quantize
        print("model dir carries a quantized artifact; serving it as-is",
              flush=True)
    elif probe:
        size = model.cfg.vision.img_size
        px = torch.zeros((1, size, size, 3), dtype=torch.uint8, device=device)
        pcfg = PreprocessConfig(size=size)

        def b1(m):
            def run():
                with torch.inference_mode():
                    return m.encode_image(normalize_only(px, pcfg)).cpu()
            return run

        choice, meds = rtt.pick_by_probe(
            {"int8": b1(model), "bf16": b1(bf16_model)}, default="int8")
        if choice == "bf16":
            alt_model, alt_buckets = bf16_model, {"image": (1,)}
        print(f"precision policy: relay RTT median {link['median_ms']:.1f} "
              f"ms — B=1 image probe int8 {meds['int8']:.1f} / bf16 "
              f"{meds['bf16']:.1f} ms → image bucket 1 served {choice} "
              f"(--precision-policy all-int8 to override)", flush=True)
    elif policy:
        print(f"precision policy: co-located — int8 at every bucket (RTT "
              f"median {link['median_ms']:.3f} ms)", flush=True)
    # the policy did not pick the bf16 weights: drop them before warmup, so
    # that no bf16 copy stays on the card
    del bf16_model
    tokenizer = get_tokenizer("bert", args.model_dir)
    max_len = min(model.cfg.max_text_length,
                  model.cfg.text.max_position_embeddings)
    core = InferenceServer(model, tokenizer, max_length=max_len,
                           image_size=model.cfg.vision.img_size,
                           max_delay_ms=args.max_delay_ms, mesh=mesh,
                           alt_model=alt_model, alt_buckets=alt_buckets)
    try:
        core.warmup()
        httpd = make_http_server(core, args.port, args.host)
    except BaseException:
        core.stop()
        raise
    return core, httpd


def serve_forever(core: InferenceServer,
                  httpd: ThreadingHTTPServer) -> None:
    """Serves until interrupted, then stops the batchers and the socket."""
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        core.stop()


def main(argv=None) -> int:
    core, httpd = build_server(argv)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}", flush=True)
    serve_forever(core, httpd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
