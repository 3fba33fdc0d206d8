"""Background-thread iterator prefetch (double buffering), counterpart of
``keep_tpu/utils/prefetch.py``.

Overlaps host-side work (image decode and tokenization in training) with
device compute. Depth 2 keeps exactly one item in flight.
"""

from __future__ import annotations


class Prefetcher:
    """Iterate ``iterable`` on a daemon thread, buffering ``depth`` items;
    exceptions from the producer re-raise in the consumer."""

    def __init__(self, iterable, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None
        self._closed = threading.Event()

        def put(item) -> bool:
            # bounded put that notices a departed consumer: if the consumer
            # exited early (exception mid-sweep), stop producing instead of
            # blocking forever on the full queue holding buffered items
            while not self._closed.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterable:
                    if not put(item):
                        return
            except BaseException as e:  # propagate to the consumer
                self._err = e
            finally:
                put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="keep-tpu-torch-prefetch")
        self._thread.start()

    def __iter__(self):
        if self._closed.is_set():
            # the producer already exited; a second pass would block on an
            # empty queue forever — fail fast (one Prefetcher per epoch)
            raise RuntimeError("Prefetcher is single-use; construct a new "
                               "one per iteration")
        try:
            while True:
                item = self._q.get()
                if item is self._sentinel:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            # generator closed (normal exhaustion, break, or an exception in
            # the consuming loop) → release the producer
            self._closed.set()
