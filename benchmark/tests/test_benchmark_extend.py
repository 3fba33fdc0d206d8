"""A later change adds a configuration, a traffic mix, a per-layer metric and
a cell as new files and entries: the harness runs them with no existing
file edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import smallcell


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copy(smallcell.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(smallcell.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"

    conf = json.loads((b / "configs" / "keep-bf16.json").read_text())
    conf["name"] = "keep-narrow"
    conf["model"]["vision"].update(embed_dim=128, depth=2, num_heads=2)
    conf["model"]["text"].update(hidden_size=64, num_hidden_layers=1,
                                 num_attention_heads=1, intermediate_size=128,
                                 vocab_size=100, max_position_embeddings=64)
    conf["model"]["projection_dim"] = 32
    (b / "configs" / "keep-narrow.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "extract.json").read_text())
    traffic.update(pool=8, batch_size=4, rows_per_block=4, trace_seconds=0.3)
    (b / "traffic" / "extract-small.json").write_text(json.dumps(traffic))
    (b / "limits" / "keep-narrow.extract-small.json").write_text(
        json.dumps({"max_1mcos": {"limit": 1e-2}}))
    (b / "metrics" / "tiles_returned.extract.py").write_text(
        "def read(cell, outcome):\n    return outcome.work.get('tiles')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "keep-narrow", "source": "test",
                             "file": "benchmark/configs/keep-narrow.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "keep-narrow.extract-small",
                               "config": "keep-narrow",
                               "traffic": "extract-small", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("keep-narrow.extract-small")
    bench["per_layer"][0]["workloads"].append("keep-narrow.extract-small")
    bench["per_layer"].append({"name": "tiles_returned.extract", "unit": "tiles",
                               "better": "higher", "source": "host_clock",
                               "layer": "model", "moves": "tiles_per_s",
                               "workloads": ["keep-narrow.extract-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        f"sys.path.append({str(smallcell.ROOT)!r})\n"
        "from benchmark import harness\n"
        "assert harness.HERE.parent.as_posix() == sys.path[0]\n"
        "bench = harness.load_benchmark(harness.HERE.parent)\n"
        "cell = harness.make_cell(bench, 'keep-narrow.extract-small', seed=3,"
        " seconds=0.3, trace=True, device='cpu', t_start=time.perf_counter())\n"
        "out = harness.Outcome()\n"
        "harness.driver(cell).run(cell, out)\n"
        "print(json.dumps({'correct': out.correct,"
        " 'metrics': harness.read_per_layer(bench, cell, out)}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["tiles_returned.extract"]["value"] > 0
    assert "mfu.extract" in res["metrics"]
    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before
