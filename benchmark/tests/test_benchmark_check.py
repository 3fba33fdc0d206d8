"""The output check decides ``correct`` by the cell's own limit: a sound run
passes it; a run whose answers were altered where they are produced fails
it; the control, one precision below the configuration's, fails it. At a
small size on the CPU here, and at the cell's own size on the card (marked
``gpu``)."""

import subprocess
import sys

import numpy as np
import pytest

import smallcell
from benchmark import harness
from benchmark.drivers import extract

CELLS = ("keep-bf16.extract", "keep-int8.extract")
# narrow enough for the CPU, deep and wide enough that the control's
# rounding adds up as it does at full size
SMALL = dict(width=256, heads=4, depth=4)


def limit(workload):
    return harness.load_json(harness.HERE / "limits" /
                             f"{workload}.json")["max_1mcos"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    _, cell = smallcell.small_cell(workload, seed=11, **SMALL)
    out = smallcell.run(cell)
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted == out.work["tiles"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_is_not_correct(workload, monkeypatch):
    from keep_tpu_torch.wsi import extract as wsi_extract

    real = wsi_extract.extract_features

    def altered(model, tiles, **kw):
        feats = real(model, tiles, **kw)
        if not isinstance(tiles, np.ndarray):  # the window's feed
            i = len(feats) // 2
            feats[i] = np.roll(feats[i], 1)
        return feats

    monkeypatch.setattr(wsi_extract, "extract_features", altered)
    _, cell = smallcell.small_cell(workload, seed=12, **SMALL)
    out = smallcell.run(cell)
    assert out.work["tiles"] > 0
    assert not out.correct, out.checks


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    _, cell = smallcell.small_cell(workload, seed=13, **SMALL)
    lim = limit(workload)
    assert extract.program_reading(cell)["max_1mcos"] <= lim
    assert extract.control_reading(cell)["max_1mcos"] > lim


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", workload,
         "--seeds", "101", "--control-seeds", "101", "102", "103"],
        cwd=smallcell.ROOT, capture_output=True, text=True, timeout=1800,
        check=True).stdout
    import json

    rows = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    lim = limit(workload)
    assert all(r["max_1mcos"] <= lim for r in rows if r["kind"] == "program")
    assert all(r["max_1mcos"] > lim for r in rows if r["kind"] == "control")
