"""No run imports JAX or the JAX package, compared by whole top-level
names, and the reference imports nothing of the program either."""

import json
import subprocess
import sys

import smallcell
from benchmark import harness

FORBIDDEN_IN_REFERENCE = ("jax", "jaxlib", "flax", "keep_tpu",
                          "keep_tpu_torch")


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "keep_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "keep_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in harness.forbidden_modules()


def _modules_after(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=smallcell.ROOT, check=True,
        capture_output=True, text=True, timeout=600).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_reference_imports_nothing_of_either_package():
    code = ("import sys, json; import benchmark.reference.keep_ref; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _modules_after(code)
    assert not set(tops) & set(FORBIDDEN_IN_REFERENCE)


def test_a_run_imports_no_jax():
    code = ("import sys, json\n"
            "sys.path.insert(0, 'benchmark/tests')\n"
            "import smallcell\n"
            "from benchmark import harness\n"
            "for w in ('keep-bf16.extract', 'keep-int8.extract'):\n"
            "    smallcell.run(smallcell.small_cell(w)[1])\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = set(_modules_after(code))
    assert "keep_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
