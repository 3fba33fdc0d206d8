"""Dispatch round-trip and transfer-rate calibration, and the measured A/B
policy rule (counterpart of ``keep_tpu/utils/rtt.py``).

Policies that compare few-dispatch paths (the bucketed-vs-flat text plan of
``zeroshot.classifier``, the server's B=1 image precision) need the fixed
cost of one dispatch and of fetching its result. With the card in the same
host that cost is small, and the JAX package's co-located branches apply;
this module measures it on the card:

- ``measure_rtt``: timed null round trips (a scalar add on the device, then
  ``.item()``) → median / p95 / min milliseconds, memoised per process.
- ``rtt_dominated``: above ``RTT_COLOCATED_MS`` the link, not the kernel,
  sets small-batch latency (never the case for a card in the host).
- ``measure_bandwidth``: timed host→device and device→host copies, the
  download into pinned memory.
- ``pick_by_probe`` / ``pick_from_medians``: time real blocking calls and
  keep the default unless a challenger beats it by more than
  ``PROBE_MARGIN`` (``serve``'s ``--precision-policy auto`` on a link whose
  round trip is above ``RTT_COLOCATED_MS``).

On the CPU the round trip and the copies are host work and are timed the
same way.
"""

from __future__ import annotations

import time

import torch

# Above this median round trip the deployment is link-bound: one dispatch's
# time is mostly link, and policies should avoid extra dispatches.
RTT_COLOCATED_MS = 3.0

_memo: dict = {}
_bw_memo: dict = {}


def default_device(device=None) -> torch.device:
    """``device``, or by default the card when there is one: where a
    measurement of the link is taken."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_rtt(n: int = 12, refresh: bool = False, device=None) -> dict:
    """Time ``n`` null round trips → {median_ms, p95_ms, min_ms, n}.

    Each sample is one scalar add on ``device`` (default: the card when there
    is one) and a blocking ``.item()``: the smallest unit of work that goes
    to the device and back. Memoised per process and device
    (``refresh=True`` measures again)."""
    device = default_device(device)
    key = str(device)
    if key in _memo and not refresh:
        return _memo[key]
    x = torch.zeros((), dtype=torch.float32, device=device)
    (x + 1.0).item()  # the first launch pays the context's setup
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        (x + 1.0).item()
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    _memo[key] = {
        "median_ms": samples[n // 2],
        "p95_ms": samples[min(n - 1, int(round(0.95 * (n - 1))))],
        "min_ms": samples[0],
        "n": n,
    }
    return _memo[key]


def rtt_dominated(rtt: dict | None = None) -> bool:
    """True when the measured link floor, not the kernel, bounds B=1 latency."""
    rtt = rtt or measure_rtt()
    return rtt["median_ms"] > RTT_COLOCATED_MS


# A challenger must beat the default by more than this factor: two paths of
# the same cost trade places from run to run on a jittery link, so the
# default keeps its seat inside the margin and a wrong pick costs at most
# ~10%.
PROBE_MARGIN = 1.10


def pick_from_medians(medians_ms: dict, default: str,
                      margin: float = PROBE_MARGIN) -> str:
    """Keeps ``default`` unless some candidate's median beats it by more
    than ``margin``."""
    best = min(medians_ms, key=medians_ms.get)
    if best != default and medians_ms[best] * margin < medians_ms[default]:
        return best
    return default


def pick_by_probe(candidates: dict, *, n: int = 5, default: str | None = None,
                  margin: float = PROBE_MARGIN) -> tuple[str, dict]:
    """Times zero-argument blocking callables and picks one by the data.

    Each candidate runs once untimed (the warm call), then ``n`` timed
    calls → its median ms. With ``default`` the choice is
    :func:`pick_from_medians`'s (a challenger needs a win by more than
    ``margin``); without it the plain minimum wins. A candidate blocks
    until its result is on the host (on the card: fetched with ``.cpu()``).
    Returns ``(choice, medians_ms)``."""
    meds = {}
    for name, fn in candidates.items():
        fn()  # warm, untimed
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        meds[name] = ts[n // 2] * 1e3
    if default is None:
        return min(meds, key=meds.get), meds
    return pick_from_medians(meds, default, margin), meds


def measure_bandwidth(mb: float = 8.0, reps: int = 3, refresh: bool = False,
                      device=None) -> dict:
    """Host↔device transfer rate → {upload_mb_per_s, download_mb_per_s, mb}.

    Best of ``reps`` copies of an ``mb``-sized fp32 buffer each way: up from
    pinned host memory, down into a pinned host buffer (the way
    ``wsi.extract`` fetches features). Memoised per process and device."""
    device = default_device(device)
    key = str(device)
    if key in _bw_memo and not refresh:
        return _bw_memo[key]
    n = int(mb * 2**20 // 4)
    pin = device.type == "cuda"
    host = torch.randn(n, generator=torch.Generator().manual_seed(0))
    back = torch.empty(n)
    if pin:
        host, back = host.pin_memory(), back.pin_memory()
    dev = host.to(device)  # warm the allocator and the route
    _sync(device)
    ups, downs = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        dev = host.to(device, non_blocking=pin)
        _sync(device)
        ups.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back.copy_(dev, non_blocking=pin)
        _sync(device)
        downs.append(time.perf_counter() - t0)
    _bw_memo[key] = {"upload_mb_per_s": mb / min(ups),
                     "download_mb_per_s": mb / min(downs), "mb": mb}
    return _bw_memo[key]
