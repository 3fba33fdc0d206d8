"""``keep_tpu_torch.utils.profiling`` and ``utils.golden`` against the JAX
package's (``keep_tpu/utils/{profiling,golden}.py``): the throughput
meter's numbers on one clock, the trace file, and the golden bundles'
round trips (the frozen ``tests/golden/*.npz`` read by both)."""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from keep_tpu.utils import golden as jgolden
from keep_tpu.utils import profiling as jprof
from keep_tpu_torch.utils import golden, profiling

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _fake_clock(monkeypatch, times):
    it = iter(times)
    for mod in (profiling, jprof):
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(it))


def test_throughput_meter_matches_jax(monkeypatch):
    ts = [0.0, 0.5, 1.0, 2.0, 2.5, 4.0]
    _fake_clock(monkeypatch, ts + ts)
    got = []
    for cls in (profiling.ThroughputMeter, jprof.ThroughputMeter):
        m = cls(window=4)
        assert m.samples_per_sec == 0.0
        rates = []
        for n in (8, 8, 16, 8, 4, 32):
            m.update(n)
            rates.append(m.samples_per_sec)
        got.append((rates, m.per_device(4)))
    assert got[0] == got[1]
    assert got[0][0][-1] == pytest.approx((8 + 4 + 32) / 3.0)


def test_per_device_defaults_to_the_cards_seen(monkeypatch):
    _fake_clock(monkeypatch, [0.0, 1.0])
    m = profiling.ThroughputMeter()
    m.update(1)
    m.update(10)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert m.per_device() == 10.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        (x @ x).sum()
    path = tmp_path / "prof" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any("aten::mm" in k.key for k in prof.key_averages())


def test_golden_helpers_match_jax(tmp_path):
    tree = {"a": {"b": np.arange(6).reshape(2, 3), "c": np.float32(2.5)},
            "d": np.array([True, False])}
    assert {k: v.tolist() for k, v in golden.flatten_tree(tree).items()} == \
        {k: v.tolist() for k, v in jgolden.flatten_tree(tree).items()}
    for mod, other in ((golden, jgolden), (jgolden, golden)):
        path = str(tmp_path / f"{mod.__name__}.npz")
        mod.save_bundle(path, tree)
        back = other.load_bundle(path)
        np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
        assert back["a"]["c"].shape == () and back["a"]["c"] == 2.5
    cases = ["", "plain", "nul\x00byte", "中文", "a" * 300]
    assert golden.unpack_strings(jgolden.pack_strings(cases)) == cases
    assert jgolden.unpack_strings(golden.pack_strings(cases)) == cases
    with pytest.raises(ValueError, match="separator"):
        golden.flatten_tree({"x/y": np.zeros(1)})


@pytest.mark.parametrize("name", sorted(p.name for p in GOLDEN.glob("*.npz")))
def test_frozen_bundles_read_alike(name):
    a = golden.flatten_tree(golden.load_bundle(str(GOLDEN / name)))
    b = jgolden.flatten_tree(jgolden.load_bundle(str(GOLDEN / name)))
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    assert os.path.getsize(GOLDEN / name) > 0
