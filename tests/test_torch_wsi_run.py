"""The port's WSI CLI (``keep_tpu_torch.wsi.run``) against the JAX CLI
(``keep_tpu.wsi.run``) on the same tiny model directory, prompts, h5 slide
and PNG slide, on the CPU (``--device cpu``).

Both CLIs load the model in bf16. To hold everything the CLIs do after the
load to the fp32 tolerance, most cases replace both ``load_model``s with
the same loader in fp32: then the h5 features agree at 2e-5 and every
printed line (tumour probability, AUROC / Dice, subtype, cohort JSON,
heatmap) is the same. The bf16 and int8 loads themselves are held at the
repo's gates (cosine ≥ 0.999 per row against the JAX CLI's features).
Each flag the port refuses names its ROADMAP item."""

import json
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from keep_tpu.compat.export import save_pretrained
from keep_tpu.configs import BertConfig, KEEPConfig, ViTConfig
from keep_tpu.factory import get_tokenizer
from keep_tpu.models import keep
from keep_tpu.wsi import run as jrun
from keep_tpu.zeroshot import build_classifiers_batched
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer
from keep_tpu_torch.wsi import run as trun

# a ViT at the published 224² (patch 32, so 49 tokens): the CLI's bicubic
# resize targets 224 and the port's ViT runs at its native size only
TINY = KEEPConfig(
    vision=ViTConfig(img_size=224, patch_size=32, embed_dim=32, depth=2,
                     num_heads=2),
    text=BertConfig(vocab_size=32, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=64,
                    max_position_embeddings=64),
    projection_dim=32,
)
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] normal tissue tumor melanoma "
         "cutaneous skin cancer malignant .").split()
TEXT = ["--text-batch-size", "8", "--max-length", "32"]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("wsi_cli")
    params = keep.init(jax.random.PRNGKey(0), TINY)
    save_pretrained(str(d / "model"), params, TINY)
    (d / "model" / "vocab.txt").write_text("\n".join(VOCAB))
    prompts = {
        str(i): {"classnames": {"Normal": "normal tissue", "Tumor": t},
                 "templates": "CLASSNAME."}
        for i, t in enumerate(["cutaneous melanoma", "skin cancer",
                               "malignant melanoma", "tumor tissue"])}
    json.dump(prompts, open(d / "prompts.json", "w"))
    rng = np.random.default_rng(0)
    side = 10
    coords = np.array([((i % side) * 256, (i // side) * 256)
                       for i in range(100)], np.int64)
    # features along ± the direction that tells the prompts' Tumor column
    # from their Normal one (tumour on the left half), at spread lengths:
    # the random tiny text tower gives columns so alike that random
    # features would put every probability within 0.01 of 0.5, where the
    # two packages' fp32 sums (~1e-7 apart) could swap two patches' ranks
    # and move a printed AUROC
    jmodel = keep.KEEPModel(params=params, cfg=TINY)
    stack = np.asarray(build_classifiers_batched(
        lambda i, m: jmodel.encode_text(jnp.asarray(i), jnp.asarray(m)),
        get_tokenizer("bert", str(d / "model")), prompts,
        {"Normal": 0, "Tumor": 1}, max_length=32, batch_size=8,
        length_buckets=None))
    u = (stack[:, :, 1] - stack[:, :, 0]).mean(0)
    u /= np.linalg.norm(u)
    sign = np.where(coords[:, 0] < 5 * 256, 1.0, -1.0)[:, None]
    feats = (sign * rng.uniform(0.5, 1.5, (100, 1)) * u
             + 0.1 * rng.standard_normal((100, 32))).astype(np.float32)
    with h5py.File(d / "slide.h5", "w") as f:
        f.create_dataset("features", data=feats)
        f.create_dataset("coords", data=coords)
    mask = np.zeros((side * 256, side * 256), np.uint8)
    mask[:, : 5 * 256] = 255
    np.save(d / "mask.npy", mask)
    img = np.full((640, 640, 3), 250, np.uint8)
    img[64:576, 64:576] = rng.integers(80, 200, (512, 512, 3)).astype(np.uint8)
    Image.fromarray(img).save(d / "slide.png")
    return d


def _jax_fp32(args, calib_pixels=None):
    model = keep.KEEPModel.from_pretrained(args.model, dtype=jnp.float32)
    if getattr(args, "int8", False):
        model = model.quantize(calib_pixels=calib_pixels)
    return model, get_tokenizer("bert", args.model)


def _port_fp32(args):
    model = KEEPModel.from_pretrained(args.model, dtype=torch.float32,
                                      use_flash=True, device=args.device,
                                      quantize=getattr(args, "int8", False))
    return model, WordPieceTokenizer.from_pretrained(args.model)


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(jrun, "load_model", _jax_fp32)
    monkeypatch.setattr(trun, "load_model", _port_fp32)


def _both(capsys, argv):
    jrun.main(argv)
    ref = capsys.readouterr().out
    trun.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    return got, ref


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("task,extra", [
    ("detection", []),
    ("detection", ["--threshold", "0.3", "--no-screening"]),
    ("segmentation", ["--patch-size", "256"]),
    ("subtyping", ["--label-map", '{"Tumor": 0}', "--topn", "2"]),
    ("subtyping", ["--label-map", '{"Tumor": 0}', "--no-screening"]),
], ids=["detection", "detection-noscreen", "segmentation", "subtyping",
        "subtyping-noscreen"])
def test_single_slide_prints_what_jax_prints(fixtures, fp32, capsys, tmp_path,
                                             task, extra):
    d = fixtures
    argv = [task, "--model", str(d / "model"), "--prompts",
            str(d / "prompts.json"), "--h5", str(d / "slide.h5"),
            "--topn", "3", "--heatmap-out", str(tmp_path / "hm.png")] + TEXT
    if task == "segmentation":
        argv += ["--mask", str(d / "mask.npy")]
    got, ref = _both(capsys, argv + extra)
    assert got == ref
    key = {"detection": "Tumor probability:", "segmentation": "AUROC:",
           "subtyping": "Predicted subtype:"}[task]
    assert key in got and "Heatmap" in got


@pytest.mark.parametrize("task", ["detection", "segmentation", "subtyping"])
def test_heatmaps_are_the_jax_cli_bytes(fixtures, fp32, capsys, tmp_path,
                                        task):
    d = fixtures
    argv = [task, "--model", str(d / "model"), "--prompts",
            str(d / "prompts.json"), "--h5", str(d / "slide.h5"),
            "--topn", "3", "--patch-size", "256"] + TEXT
    if task == "segmentation":
        argv += ["--mask", str(d / "mask.npy")]
    if task == "subtyping":
        argv += ["--label-map", '{"Tumor": 0}']
    jrun.main(argv + ["--heatmap-out", str(tmp_path / "j.png")])
    trun.main(argv + ["--heatmap-out", str(tmp_path / "t.png"),
                      "--device", "cpu"])
    capsys.readouterr()
    a = np.asarray(Image.open(tmp_path / "t.png"))
    b = np.asarray(Image.open(tmp_path / "j.png"))
    assert a.shape == (160, 160) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("task", ["detection", "segmentation", "subtyping"])
def test_cohort_json_is_the_jax_clis(fixtures, fp32, capsys, tmp_path, task):
    import pandas as pd

    d = fixtures
    src = tmp_path / "cohort"
    (src / "h5_files").mkdir(parents=True)
    (src / "masks").mkdir()
    rng = np.random.default_rng(3)
    for i, sid in enumerate(("s0", "s1", "s2")):
        with h5py.File(d / "slide.h5") as f, \
                h5py.File(src / "h5_files" / f"{sid}.h5", "w") as g:
            g.create_dataset("features", data=f["features"][:] + 0.2 * i
                             * rng.standard_normal((100, 32)).astype(
                                 np.float32))
            g.create_dataset("coords", data=f["coords"][:])
        shutil.copy(d / "mask.npy", src / "masks" / f"{sid}.npy")
    labels = {"detection": ["Normal", "Tumor", "Tumor"],
              "segmentation": ["Tumor"] * 3,
              "subtyping": ["Tumor"] * 3}[task]
    pd.DataFrame({"slide_id": ["s0", "s1", "s2"], "Diagnosis": labels}
                 ).to_csv(src / "cohort.csv", index=False)
    argv = [task, "--model", str(d / "model"), "--prompts",
            str(d / "prompts.json"), "--cohort-csv", str(src / "cohort.csv"),
            "--data-source", str(src), "--topn", "2",
            "--patch-size", "256"] + TEXT
    if task == "segmentation":
        argv += ["--mask-dir", str(src / "masks")]
    if task == "subtyping":
        argv += ["--label-map", '{"Tumor": 0}']
    got, ref = _both(capsys, argv)
    assert got == ref
    rec = json.loads(got[got.index("{"):])
    assert rec["n"] == 3


def _extract(capsys, main, d, out, extra=()):
    main(["extract", "--model", str(d / "model"), "--image",
          str(d / "slide.png"), "--out", str(out), "--batch-size", "4"]
         + list(extra))
    assert "wrote" in capsys.readouterr().out
    with h5py.File(out) as f:
        return f["features"][:], f["coords"][:]


def test_extract_writes_the_jax_clis_h5(fixtures, fp32, capsys, tmp_path):
    """PNG slide → tissue tiles → bicubic 256 → 224 → features: the coords
    exactly, the fp32 features at 2e-5; then detection on that h5."""
    d = fixtures
    jf, jc = _extract(capsys, jrun.main, d, tmp_path / "j.h5")
    tf, tc = _extract(capsys, trun.main, d, tmp_path / "t.h5",
                      ["--device", "cpu"])
    assert len(tc) == 4
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tf, jf, atol=2e-5, rtol=2e-5)
    argv = ["detection", "--model", str(d / "model"), "--prompts",
            str(d / "prompts.json"), "--max-length", "16",
            "--no-screening"]
    jrun.main(argv + ["--h5", str(tmp_path / "j.h5")])
    ref = capsys.readouterr().out
    trun.main(argv + ["--h5", str(tmp_path / "t.h5"), "--device", "cpu"])
    assert capsys.readouterr().out == ref


def test_extract_slide_dir(fixtures, fp32, capsys, tmp_path):
    d = fixtures
    slides = tmp_path / "slides"
    slides.mkdir()
    shutil.copy(d / "slide.png", slides / "a.png")
    shutil.copy(d / "slide.png", slides / "b.png")
    out = tmp_path / "out"
    trun.main(["extract", "--model", str(d / "model"), "--slide-dir",
               str(slides), "--out-dir", str(out), "--batch-size", "4",
               "--device", "cpu"])
    assert "wrote 8 features across 2 slides" in capsys.readouterr().out
    for stem in ("a", "b"):
        with h5py.File(out / "h5_files" / f"{stem}.h5") as f:
            assert f["features"].shape == (4, 32)


def test_bf16_extract_within_the_bf16_gate(fixtures, capsys, tmp_path):
    """The CLIs' own bf16 loads (the port's with its kernels' plain
    versions, the JAX one on XLA): features at cosine ≥ 0.999 per row."""
    d = fixtures
    jf, _ = _extract(capsys, jrun.main, d, tmp_path / "j.h5")
    tf, _ = _extract(capsys, trun.main, d, tmp_path / "t.h5",
                     ["--device", "cpu"])
    assert _cos(tf, jf).min() >= 0.999


def test_int8_extract_within_the_int8_gate(fixtures, capsys, tmp_path):
    """``--int8 --int8-calib 0``: the port's int8 towers against the JAX
    CLI's, and against the bf16 features, at cosine ≥ 0.999 per row."""
    d = fixtures
    flags = ["--int8", "--int8-calib", "0"]
    jf, _ = _extract(capsys, jrun.main, d, tmp_path / "j.h5", flags)
    tf, _ = _extract(capsys, trun.main, d, tmp_path / "t.h5",
                     flags + ["--device", "cpu"])
    bf, _ = _extract(capsys, trun.main, d, tmp_path / "b.h5",
                     ["--device", "cpu"])
    assert _cos(tf, jf).min() >= 0.999
    assert _cos(tf, bf).min() >= 0.999


def test_int8_detection_runs(fixtures, capsys):
    d = fixtures
    trun.main(["detection", "--model", str(d / "model"), "--prompts",
               str(d / "prompts.json"), "--h5", str(d / "slide.h5"),
               "--topn", "2", "--int8", "--device", "cpu"] + TEXT)
    prob = float(capsys.readouterr().out.strip().split()[-1])
    assert 0.0 <= prob <= 1.0


def _refused(capsys, argv, item):
    with pytest.raises(SystemExit):
        trun.main(argv + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert item in err, err


def test_refuses_mesh_dp(fixtures, capsys, tmp_path):
    d = fixtures
    _refused(capsys, ["extract", "--model", str(d / "model"), "--image",
                      str(d / "slide.png"), "--out", str(tmp_path / "x.h5"),
                      "--mesh-dp"], "item 10")


def test_refuses_cascade_margin(fixtures, capsys):
    d = fixtures
    _refused(capsys, ["detection", "--model", str(d / "model"), "--prompts",
                      str(d / "prompts.json"), "--h5", str(d / "slide.h5"),
                      "--cascade-margin", "0.1"], "item 13")


def test_refuses_detection_on_an_image(fixtures, capsys):
    d = fixtures
    _refused(capsys, ["detection", "--model", str(d / "model"), "--prompts",
                      str(d / "prompts.json"), "--image",
                      str(d / "slide.png")], "item 13")


def test_refuses_int8_calibration(fixtures, capsys, tmp_path):
    d = fixtures
    argv = ["extract", "--model", str(d / "model"), "--image",
            str(d / "slide.png"), "--out", str(tmp_path / "x.h5"), "--int8"]
    _refused(capsys, argv, "item 7")
    _refused(capsys, argv + ["--int8-calib", "8"], "--int8-calib 0")


@pytest.mark.parametrize("suffix", [".tif", ".svs"])
def test_refuses_pyramidal_slides(fixtures, capsys, tmp_path, suffix):
    d = fixtures
    img = Image.open(d / "slide.png")
    path = tmp_path / f"slide{suffix}"
    # two pages: a level-0 image and its 2× downsample, as a pyramid has
    img.save(path, format="TIFF", save_all=True,
             append_images=[img.resize((320, 320))])
    _refused(capsys, ["extract", "--model", str(d / "model"), "--image",
                      str(path), "--out", str(tmp_path / "x.h5")], "item 13")
    slides = tmp_path / "dir"
    slides.mkdir()
    shutil.copy(path, slides / path.name)
    _refused(capsys, ["extract", "--model", str(d / "model"), "--slide-dir",
                      str(slides), "--out-dir", str(tmp_path / "o")],
             "item 13")


def test_flat_tiff_is_read_as_an_image(fixtures, fp32, capsys, tmp_path):
    d = fixtures
    Image.open(d / "slide.png").save(tmp_path / "flat.tif")
    trun.main(["extract", "--model", str(d / "model"), "--image",
               str(tmp_path / "flat.tif"), "--out", str(tmp_path / "f.h5"),
               "--batch-size", "4", "--device", "cpu"])
    assert "wrote 4 features" in capsys.readouterr().out


def test_without_a_card_raises_unless_cpu_is_asked(fixtures, monkeypatch):
    d = fixtures
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        trun.main(["detection", "--model", str(d / "model"), "--prompts",
                   str(d / "prompts.json"), "--h5", str(d / "slide.h5")])


def test_usage_errors_match_jax(fixtures):
    d = fixtures
    for argv in (["extract", "--model", str(d / "model")],
                 ["detection", "--model", str(d / "model"), "--h5",
                  str(d / "slide.h5")],
                 ["segmentation", "--model", str(d / "model"), "--prompts",
                  str(d / "prompts.json"), "--h5", str(d / "slide.h5")]):
        with pytest.raises(SystemExit):
            trun.main(argv + ["--device", "cpu"])
