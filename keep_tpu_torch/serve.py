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

HTTP layer (stdlib ``ThreadingHTTPServer``):
POST /encode_text      {"texts": ["...", ...]}           → {"embeddings": [[...]]}
POST /encode_image     {"images": [[H,W,3] uint8 lists]} → {"embeddings": [[...]]}
POST /encode_image_npy <raw .npy uint8 [N,H,W,3] body>   → raw .npy fp32 [N,D]
POST /similarity       {"texts": [...], "images": [...]} → {"logits": [[...]]}
GET  /healthz, GET /stats

CLI: ``python -m keep_tpu_torch.serve --model-dir <released checkpoint>
[--int8]`` serves the bf16 model with the fused attention kernel on the
card, or with ``--int8`` the W8A8 model (``KEEPModel.quantize``) through the
int8 megakernels of both towers. ``--precision-policy {auto,all-int8}`` is
accepted; co-located with the card, both serve int8 at every bucket, which
is the JAX server's co-located branch. ``--lora <checkpoints dir>``
merges the adapters a LoRA fine-tune wrote (``train/lora.py``) into the
model at startup, with the scale ``--lora-scale`` or, by default, the run's
``params.txt``; with ``--int8`` the merged fp32 values are quantized. The
JAX server's ``--mesh-dp`` is not ported yet and is refused.
"""

from __future__ import annotations

import argparse
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


def _fetch(handle: torch.Tensor) -> np.ndarray:
    return handle.cpu().numpy()


class InferenceServer:
    """Model-side server core (HTTP-free; ``make_http_server`` wraps it).
    The model's device is the device of its parameters."""

    def __init__(self, model, tokenizer, *, max_length: int = 256,
                 image_size: int = 224, buckets=_BUCKETS,
                 max_delay_ms: float = 3.0):
        self.model = model
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = image_size
        self.buckets = tuple(buckets)
        self.device = next(model.parameters()).device
        self._pcfg = PreprocessConfig(size=image_size)
        _b_of = lambda n: _bucket(n, self.buckets)  # noqa: E731
        self.text_q = BatchQueue(self._launch_text, self.buckets[-1],
                                 max_delay_ms, "text", fetch=_fetch,
                                 bucket_of=_b_of)
        self.image_q = BatchQueue(self._launch_image, self.buckets[-1],
                                  max_delay_ms, "image", fetch=_fetch,
                                  bucket_of=_b_of)
        self.started = time.time()

    def _pad_put(self, arr: np.ndarray) -> torch.Tensor:
        """Pads to the bucket and starts the copy to the device; padded tail
        rows are computed and never read back."""
        n = len(arr)
        pad = np.zeros((_bucket(n, self.buckets) - n,) + arr.shape[1:],
                       arr.dtype)
        host = torch.from_numpy(np.concatenate([arr, pad], 0))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _launch_text(self, ids_mask: np.ndarray) -> torch.Tensor:
        im = self._pad_put(ids_mask.astype(np.int64))
        with torch.inference_mode():
            return self.model.encode_text(im[:, 0], im[:, 1])  # unfetched

    def _launch_image(self, tiles_u8: np.ndarray) -> torch.Tensor:
        # tiles travel as raw uint8 and are normalised on the device inside
        # this dispatch; only the [N, D] features come back
        px = self._pad_put(tiles_u8)
        with torch.inference_mode():
            return self.model.encode_image(normalize_only(px, self._pcfg))

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
        """Runs every bucket of both towers once before serving."""
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


_NOT_PORTED = {"mesh_dp": "--mesh-dp"}


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
                    help="with --int8: co-located with the card, 'auto' "
                         "serves int8 at every bucket, as 'all-int8' does")
    ap.add_argument("--lora", default="",
                    help="LoRA adapter checkpoint dir (the training CLI's "
                         "checkpoints/ with solver.lora_rank > 0), merged "
                         "into the base weights at startup")
    ap.add_argument("--lora-scale", type=float, default=None,
                    help="alpha / rank used in training; default: read "
                         "solver.lora_alpha / lora_rank from the run's "
                         "params.txt beside the checkpoint dir")
    ap.add_argument("--mesh-dp", type=int, default=0, help="not ported yet")
    args = ap.parse_args(argv)
    for dest, flag in _NOT_PORTED.items():
        if getattr(args, dest):
            ap.error(f"{flag} is not ported to the PyTorch server yet; "
                     f"serve it with python -m keep_tpu.serve")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the "
                         "CPU")

    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

    # the published quick-start setting: bf16 with the fused attention
    # kernel; --int8 quantizes from the checkpoint's fp32 values
    model = KEEPModel.from_pretrained(args.model_dir, dtype=torch.bfloat16,
                                      use_flash=True, device=device,
                                      quantize=args.int8 and not args.lora)
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
        if args.int8:
            model = model.quantize()
    if args.int8 and args.precision_policy == "auto":
        # the JAX server measures a relay's round trip here; with the card
        # in the same host there is no relay, and its co-located branch
        # serves int8 at every bucket
        print("precision policy: co-located — int8 at every bucket",
              flush=True)
    tokenizer = WordPieceTokenizer.from_pretrained(args.model_dir)
    max_len = min(model.cfg.max_text_length,
                  model.cfg.text.max_position_embeddings)
    core = InferenceServer(model, tokenizer, max_length=max_len,
                           image_size=model.cfg.vision.img_size,
                           max_delay_ms=args.max_delay_ms)
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
