"""``keep_tpu_torch.compat.hub`` against the JAX package's (twins of
``tests/test_hub.py``): for one state dict, the same file set, the same
``open_clip_config.json``, the same README, the same weights in each
format with their dtypes kept, and the repo registered in the port's
registry."""

import json
import os

import numpy as np
import pytest
import torch

from keep_tpu.compat import hub as jhub
from keep_tpu_torch.compat import hub, registry

CARD = {"license": "apache-2.0", "description": "A CLIP model for pathology.",
        "details": {"Dataset": "OpenPath",
                    "Architecture": ["ViT-L-16", "BERT-base"],
                    "Training": {"epochs": 10, "batch": 128}},
        "usage": "```python\nmodel.encode_image(x)\n```",
        "citation": ["@article{keep2026}", "@misc{openclip}"]}


def _sd():
    rng = np.random.default_rng(0)
    return {"visual.proj": rng.standard_normal((4, 2)).astype(np.float32),
            "logit_scale": np.asarray(3.2, np.float32),
            "text.position_ids": np.arange(6, dtype=np.int64),
            "mask": np.array([True, False, True]),
            "f64": rng.standard_normal(3)}


@pytest.mark.parametrize("card", [CARD, {}, {"details": {"Dataset": "X"}}])
def test_generate_readme_matches_jax(card):
    assert hub.generate_readme(card, "KEEP-demo") == jhub.generate_readme(
        card, "KEEP-demo")


@pytest.mark.parametrize("safe", [False, True, "both"])
def test_save_for_hub_matches_jax(tmp_path, safe):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("[PAD]\n[UNK]\nhello\n")
    kw = dict(model_config={"embed_dim": 2, "vision_cfg": {"width": 4}},
              tokenizer_files=[str(vocab)], safe_serialization=safe)
    jhub.save_for_hub(str(tmp_path / "jax"), _sd(), **kw)
    hub.save_for_hub(str(tmp_path / "port"),
                     {k: torch.from_numpy(np.asarray(v)) for k, v in
                      _sd().items()}, **kw)
    a, b = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert (a / hub.HF_CONFIG_NAME).read_text() == \
        (b / hub.HF_CONFIG_NAME).read_text()
    with np.load(a / "weights.npz") as za, np.load(b / "weights.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k])
    if safe in (False, "both"):
        ja = torch.load(a / hub.HF_WEIGHTS_NAME, weights_only=True)
        tb = torch.load(b / hub.HF_WEIGHTS_NAME, weights_only=True)
        assert sorted(ja) == sorted(tb)
        for k in ja:
            # the JAX writer's np.ascontiguousarray turns a 0-d entry into
            # [1]; the port keeps each entry's shape
            assert tuple(tb[k].shape) == np.asarray(_sd()[k]).shape, k
            assert ja[k].dtype == tb[k].dtype, k
            assert torch.equal(ja[k].reshape(tb[k].shape), tb[k]), k
    if safe in (True, "both"):
        from safetensors.numpy import load_file

        sa = load_file(str(a / hub.HF_SAFE_WEIGHTS_NAME))
        sb = load_file(str(b / hub.HF_SAFE_WEIGHTS_NAME))
        for k in sa:
            assert sa[k].dtype == sb[k].dtype, k
            np.testing.assert_array_equal(sa[k].reshape(sb[k].shape), sb[k])


def test_bf16_entries_keep_their_dtype(tmp_path):
    sd = {"w": torch.randn(3, 2).bfloat16()}
    hub.save_for_hub(str(tmp_path), sd, safe_serialization="both")
    back = torch.load(tmp_path / hub.HF_WEIGHTS_NAME, weights_only=True)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                              sd["w"])
    from safetensors.torch import load_file

    assert torch.equal(load_file(str(tmp_path / hub.HF_SAFE_WEIGHTS_NAME))
                       ["w"], sd["w"])
    with np.load(tmp_path / "weights.npz") as z:
        # numpy reads an ml_dtypes bfloat16 entry back as 2-byte records:
        # the bits are the tensor's
        assert z["w"].dtype.itemsize == 2
        np.testing.assert_array_equal(z["w"].view(np.int16),
                                      sd["w"].view(torch.int16).numpy())


def test_push_to_hub_layout_and_registry(tmp_path, monkeypatch):
    """The local hub tree as the JAX package writes it (README generated
    only when absent) and the repo resolvable by name in the port's
    registry."""
    monkeypatch.setattr(registry, "_runtime", {})
    monkeypatch.setenv("KEEP_TPU_HOME", str(tmp_path / "home"))
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in _sd().items()}
    kw = dict(model_config={"embed_dim": 2}, model_card={"description": "d"})
    repo = hub.push_to_hub("acme/keep-demo", sd,
                           hub_root=str(tmp_path / "port"), **kw)
    jrepo = jhub.push_to_hub("acme/keep-demo", _sd(),
                             hub_root=str(tmp_path / "jax"), register=False,
                             **kw)
    assert sorted(os.listdir(repo)) == sorted(os.listdir(jrepo))
    for f in ("README.md", hub.HF_CONFIG_NAME):
        assert open(os.path.join(repo, f)).read() == \
            open(os.path.join(jrepo, f)).read()
    assert registry.resolve("acme/keep-demo") == repo
    with open(os.path.join(repo, "README.md"), "w") as f:
        f.write("CUSTOM")
    hub.push_to_hub("acme/keep-demo", sd, hub_root=str(tmp_path / "port"),
                    register=False)
    assert open(os.path.join(repo, "README.md")).read() == "CUSTOM"
    cfg = json.loads(open(os.path.join(repo, hub.HF_CONFIG_NAME)).read())
    assert cfg["preprocess_cfg"]["mean"] == [0.485, 0.456, 0.406]
    with pytest.raises(ValueError, match="owner/name"):
        hub.push_to_hub("nade", sd, hub_root=str(tmp_path / "port"))
