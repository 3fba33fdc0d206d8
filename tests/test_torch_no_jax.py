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
    REPO / "scripts" / "torch_screening_bench.py",
    REPO / "scripts" / "torch_calibration_sweep.py",
    REPO / "scripts" / "torch_attention_shapes_bench.py",
    REPO / "scripts" / "torch_smoke_phases.py",
    REPO / "tests" / "card_attention_model.py"]


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
        "import keep_tpu_torch.io.wsi, keep_tpu_torch.io._native, "
        "keep_tpu_torch.io.fast_decode, keep_tpu_torch.wsi.cascade\n"
        "from keep_tpu_torch.ops.preprocess import preprocess\n"
        "import keep_tpu_torch.factory, keep_tpu_torch.presets, "
        "keep_tpu_torch.compat.openai, keep_tpu_torch.models.clip, "
        "keep_tpu_torch.models.text_transformer, keep_tpu_torch.text.bpe, "
        "keep_tpu_torch.zeroshot.openclip, "
        "keep_tpu_torch.zeroshot.imagenet_metadata\n"
        "from keep_tpu_torch.models import (coca, convnext, eva, hf_text, "
        "kep, moe, pmc_clip, poolers, resnet, swin, t5, vit_relpos)\n"
        "from keep_tpu_torch.compat import (aot, composite, export, hub, "
        "registry)\n"
        "import keep_tpu_torch.text.fast_tokenizer, "
        "keep_tpu_torch.utils.golden, keep_tpu_torch.utils.profiling, "
        "keep_tpu_torch.kernels._library\n"
        "from keep_tpu_torch.parallel import fsdp, mesh, multihost, pp, sp, "
        "tp\n"
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


@pytest.mark.parametrize("name", ["chip_smoke.py",
                                  "scripts/torch_smoke_phases.py"])
def test_smoke_scripts_define_each_name_once(name):
    """A module-level function or constant of the card's smoke scripts is
    defined once: a second ``def`` of a name replaces the first for every
    phase that calls it."""
    tree = ast.parse((REPO / name).read_text(), name)
    seen: dict = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        else:
            continue
        for n in names:
            assert n not in seen, (f"{name}: {n} defined at lines "
                                   f"{seen[n]} and {node.lineno}")
            seen[n] = node.lineno


def test_reader_and_calibration_run_with_jax_blocked(tmp_path):
    """The pyramid reader, the decoder, the cascade and the calibration
    import and run in a process where importing ``jax`` or ``keep_tpu``
    fails, as on the card's machine: the native library is built, a
    pyramid written, read and tiled, an image decoded, a tiny model
    calibrated."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'keep_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "from keep_tpu_torch.io import _native, fast_decode, wsi\n"
        "from keep_tpu_torch.io.tiles import iter_wsi_tiles\n"
        "from keep_tpu_torch.wsi import cascade, extract, run\n"
        "from keep_tpu_torch import configs, quant\n"
        "from keep_tpu_torch.models.keep import KEEPModel\n"
        "_native.build_native()\n"
        "img = np.full((256, 256, 3), 250, np.uint8)\n"
        "img[32:224, 32:224] = (170, 70, 130)\n"
        f"p = {str(tmp_path / 'p.tif')!r}\n"
        "wsi.write_pyramid(p, img, tile=64, min_size=64)\n"
        "with wsi.open_slide(p) as s:\n"
        "    assert s.backend == 'native' and s.level_count == 3\n"
        "    tiles = np.concatenate([t for t, _ in iter_wsi_tiles(\n"
        "        s, patch_size=32, chunk=16)])\n"
        "assert len(tiles) == 36\n"
        "from PIL import Image\n"
        f"q = {str(tmp_path / 'q.png')!r}\n"
        "Image.fromarray(img).save(q)\n"
        "assert (fast_decode.decode_image(q) == img).all()\n"
        "cfg = configs.KEEPConfig(vision=configs.ViTConfig(img_size=32, "
        "patch_size=16, embed_dim=32, depth=1, num_heads=2), "
        "text=configs.BertConfig(vocab_size=32, hidden_size=32, "
        "num_hidden_layers=1, num_attention_heads=2, intermediate_size=64, "
        "max_position_embeddings=32), projection_dim=32)\n"
        "m = KEEPModel.init(cfg, torch.Generator().manual_seed(0))\n"
        "q8 = m.quantize(calib_pixels=torch.randn(2, 32, 32, 3), "
        "calib_text=torch.randint(1, 32, (2, 8)))\n"
        "assert quant.is_quantized(q8)\n"
        "from keep_tpu_torch import factory\n"
        "from keep_tpu_torch.models.text_transformer import "
        "TextTransformerConfig\n"
        "clip = factory.create_model('clip-vit-b-16', device='cpu', "
        "vision=configs.ViTConfig(img_size=32, patch_size=16, embed_dim=32, "
        "depth=1, num_heads=2, layerscale_init=None), "
        "text=TextTransformerConfig(vocab_size=32, context_length=8, "
        "width=32, heads=2, layers=1, output_dim=16), embed_dim=16)\n"
        "out = clip(torch.zeros(1, 48, 48, 3), torch.ones(1, 8, "
        "dtype=torch.long))\n"
        "assert out['image_features'].shape == (1, 16)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'keep_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _listing(d: pathlib.Path) -> list:
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in d.iterdir())


def test_native_build_writes_nothing_under_native(tmp_path, monkeypatch):
    """The port compiles ``native/*.cpp`` into its own build directory: a
    fresh build leaves ``native/`` as it was, file for file."""
    from keep_tpu_torch.io import _native

    before = _listing(_native.NATIVE_DIR)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    lib = pathlib.Path(_native.build_native())
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    assert _listing(_native.NATIVE_DIR) == before


def test_native_build_failure_names_what_is_missing(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output."""
    from keep_tpu_torch.io import _native

    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "LIBS", ("-lkeep_no_such_library",))
    with pytest.raises(RuntimeError, match="keep_no_such_library"):
        _native.build_native()
    assert not list((tmp_path / "build").glob("*.so"))


def test_chip_smoke_without_gpu_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
