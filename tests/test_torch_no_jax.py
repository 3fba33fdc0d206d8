"""The port, chip_smoke.py and the port's card scripts never import JAX or
the JAX package: the machine with the GPU has no JAX."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "keep_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "torch_attention_exp_share.py",
    REPO / "scripts" / "torch_dispatch_profile.py",
    REPO / "scripts" / "torch_screening_bench.py"]


def test_imports_leave_jax_unloaded():
    code = (
        "import sys\n"
        "import keep_tpu_torch, keep_tpu_torch.serve, chip_smoke\n"
        "import scripts.torch_dispatch_profile\n"
        "import keep_tpu_torch.models, keep_tpu_torch.compat, "
        "keep_tpu_torch.kernels, keep_tpu_torch.ops, keep_tpu_torch.text\n"
        "import keep_tpu_torch.quant, keep_tpu_torch.models.keep\n"
        "from keep_tpu_torch.kernels import _kops, ln_matmul, qblock, "
        "qmatmul, qmlp\n"
        "import keep_tpu_torch.train.main, keep_tpu_torch.utils.writers\n"
        "from keep_tpu_torch.train import (checkpoint, config, data, eval, "
        "freeze, lora, loss, optim, schedules, sync, trainer)\n"
        "import keep_tpu_torch.wsi.run, keep_tpu_torch.wsi.extract, "
        "keep_tpu_torch.wsi.cohort, keep_tpu_torch.wsi.pipelines\n"
        "import keep_tpu_torch.zeroshot, keep_tpu_torch.zeroshot.prompts, "
        "keep_tpu_torch.metrics, keep_tpu_torch.io.tiles, "
        "keep_tpu_torch.io.h5, keep_tpu_torch.utils.rtt\n"
        "from keep_tpu_torch.ops.preprocess import preprocess\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'keep_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "keep_tpu"), (
                f"{path.name}:{node.lineno} imports {n}")


def test_chip_smoke_without_gpu_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
