"""``keep_tpu_torch.compat.{export,registry}``, ``factory.create_model(
pretrained=...)`` and the int8 deploy artifact, against the JAX package:

- ``to_keep_state_dict`` of the port's model equals the JAX package's of
  the same parameters bit for bit, and inverts ``load_keep_state_dict``;
- the port's ``save_pretrained`` loads in JAX's ``KEEPModel.from_pretrained``
  with the features at 2e-5 (fp32);
- both packages' registries give the same paths and sha verdicts on one
  ``KEEP_TPU_HOME`` (twins of ``tests/test_cohort_and_export.py``; only
  ``file://`` URLs and cache hits, nothing leaves the machine);
- the int8 artifact round-trips its codes and features bit for bit, its
  calibrated codes stand to JAX's as ``test_torch_calibration.py`` holds
  them, and ``serve --int8`` serves it as it is.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.compat import export as jexport
from keep_tpu.compat import registry as jreg
from keep_tpu.models import keep as jkeep
from keep_tpu_torch import factory
from keep_tpu_torch.compat import export, registry
from keep_tpu_torch.compat.torch_loader import (from_jax_params,
                                                load_keep_state_dict)
from keep_tpu_torch.configs import KEEPConfig
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.quant import is_quantized
from tests.test_keep_api import TINY as JTINY
from tests.test_torch_calibration import (CFG as CAL_CFG, CODE_SHARE,
                                          _calib, _codes_against_jax)
from tests.test_torch_calibration import JCFG as CAL_JCFG

TINY = KEEPConfig.from_hf_dict(jexport._config_dict(JTINY))


@pytest.fixture(scope="module")
def jparams():
    return jkeep.init(jax.random.PRNGKey(3), JTINY)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _port(jparams, cfg=TINY, **kw) -> KEEPModel:
    m = KEEPModel(cfg, device="cpu", **kw)
    m.load_state_dict(from_jax_params(_np_tree(jparams), cfg))
    return m.eval()


def test_config_dicts_agree():
    assert export._config_dict(TINY) == jexport._config_dict(JTINY)


def test_to_keep_state_dict_matches_jax(jparams):
    want = jexport.to_keep_state_dict(_np_tree(jparams), JTINY)
    for got in (export.to_keep_state_dict(_port(jparams)),
                export.to_keep_state_dict(
                    from_jax_params(_np_tree(jparams), TINY), TINY)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=k)
            assert got[k].dtype == torch.float32, k


def test_to_keep_state_dict_inverts_the_loader(jparams):
    """released layout → port → released layout, bit for bit; a bf16 model
    exports the fp32 values it was loaded from."""
    sd = export.to_keep_state_dict(_port(jparams))
    back = export.to_keep_state_dict(load_keep_state_dict(sd, TINY), TINY)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    b16 = _port(jparams, dtype=torch.bfloat16)
    got = export.to_keep_state_dict(b16)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(ValueError, match="save_quantized"):
        export.to_keep_state_dict(_port(jparams).quantize())


def test_save_pretrained_loads_in_jax(jparams, tmp_path, rng):
    """The port's files load in the JAX package's ``from_pretrained``: the
    features agree at 2e-5 (fp32), and the port reads them back exactly."""
    port = _port(jparams)
    d = str(tmp_path / "model")
    export.save_pretrained(d, port)
    jm = jkeep.KEEPModel.from_pretrained(d)
    assert jm.cfg == JTINY
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, JTINY.text.vocab_size, (2, 12))
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    with torch.no_grad():
        got_i = port.encode_image(torch.from_numpy(x)).numpy()
        got_t = port.encode_text(torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(np.asarray(jm.encode_image(jnp.asarray(x))),
                               got_i, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(jm.encode_text(jnp.asarray(ids), jnp.asarray(mask))),
        got_t, atol=2e-5, rtol=2e-5)
    back = KEEPModel.from_pretrained(d, device="cpu")
    assert all(torch.equal(back.state_dict()[k], v)
               for k, v in port.state_dict().items())


# ---- the registry, both packages on one KEEP_TPU_HOME ----------------------


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("KEEP_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setattr(registry, "_runtime", {})
    monkeypatch.setattr(jreg, "_runtime", {})
    return tmp_path / "home"


def _both(fn):
    """fn(registry module) on both packages: the same result or the same
    exception type and message."""
    out = []
    for mod in (registry, jreg):
        try:
            out.append(("ok", fn(mod)))
        except Exception as e:  # compared, then re-raised by the caller
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1], out
    return out[0]


def test_registry_resolve_matches_jax(home, tmp_path):
    home.mkdir()
    assert _both(lambda r: r.cache_home()) == ("ok", str(home))
    assert _both(lambda r: r.resolve("keep"))[0] == "FileNotFoundError"
    assert _both(lambda r: r.resolve("nope"))[0] == "KeyError"
    ckpt = tmp_path / "model.bin"
    ckpt.write_bytes(b"weights!")
    good = registry.sha256_file(str(ckpt))
    assert good == jreg.sha256_file(str(ckpt))
    for r in (registry, jreg):
        r.register("m", str(ckpt), source="local", sha256=good, kind="file")
        r.register("bad", str(ckpt), sha256="0" * 64, kind="file")
    assert _both(lambda r: r.resolve("m")) == ("ok", str(ckpt))
    assert _both(lambda r: r.resolve("bad"))[0] == "ValueError"
    (home / "registry.json").write_text(json.dumps(
        {"extra": {"path": "sub", "kind": "dir", "source": "s"}}))
    (home / "sub").mkdir()
    assert _both(lambda r: r.resolve("extra")) == ("ok", str(home / "sub"))
    assert _both(lambda r: sorted(r.entries())) == (
        "ok", ["bad", "extra", "keep", "knowledge_bert", "m", "uni"])


def test_download_and_fetch_match_jax(home, tmp_path):
    """``file://`` fetch → sha verify → cache; a cache hit returns without
    fetching; a bad checksum raises; URL-carrying file entries fetch on
    first resolve. Run on the port first, then on the JAX package from a
    fresh cache, with the same results."""
    src = tmp_path / "src" / "weights.bin"
    src.parent.mkdir()
    src.write_bytes(b"release-weights-v1")
    sha = registry.sha256_file(str(src))
    url = src.as_uri()
    results = []
    for r in (registry, jreg):
        got = r.download_pretrained_from_url(url, expected_sha256=sha)
        assert open(got, "rb").read() == b"release-weights-v1"
        assert r.download_pretrained_from_url(url,
                                              expected_sha256=sha[:12]) == got
        r.register("kb-url", "kb/knowledge_bert.pt", kind="file", sha256=sha,
                   url=url)
        p = r.resolve("kb-url")
        results.append((got, p, r.fetch(p), r.fetch("kb-url"), r.fetch(url)))
        (home / "downloads" / "weights.bin").unlink()
        (home / "kb" / "knowledge_bert.pt").unlink()
    assert results[0] == results[1]
    src.write_bytes(b"corrupted")
    for r in (registry, jreg):
        with pytest.raises(RuntimeError, match="sha256"):
            r.download_pretrained_from_url(url, expected_sha256=sha)


def test_create_model_pretrained_by_name_path_and_url(home, tmp_path,
                                                      jparams):
    """``create_model("keep", pretrained=...)`` through ``registry.fetch``:
    a local path, a registry name (the builtin ``keep`` entry under
    ``KEEP_TPU_HOME``, and a registered one) and a ``file://`` URL of a
    weights file all give the source model's weights exactly; the config
    comes from ``config.json`` with the caller's overrides on top."""
    port = _port(jparams)
    d = home / "KEEP"
    export.save_pretrained(str(d), port)
    want = port.state_dict()
    registry.register("tiny-keep", str(d), kind="dir")
    for ref in (str(d), "keep", "tiny-keep"):
        m = factory.create_model("keep", pretrained=ref, device="cpu")
        assert m.cfg == TINY
        assert all(torch.equal(m.state_dict()[k], v) for k, v in want.items())
    m = factory.create_model("keep", pretrained="keep", device="cpu",
                             max_text_length=16)
    assert m.cfg.max_text_length == 16 and m.cfg.vision == TINY.vision
    bare = factory.create_model(
        "keep", pretrained=(d / "pytorch_model.bin").as_uri(), device="cpu",
        vision=TINY.vision, text=TINY.text,
        projection_dim=TINY.projection_dim)
    assert all(torch.equal(bare.state_dict()[k], v) for k, v in want.items())
    with pytest.raises(NotImplementedError):
        factory.create_model("coca", pretrained="tiny-keep", device="cpu")


# ---- the int8 deploy artifact ----------------------------------------------


def _features(m, x, ids, mask):
    with torch.no_grad():
        return (m.encode_image(torch.from_numpy(x)),
                m.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_artifact_roundtrip_bit_for_bit(jparams, tmp_path, rng, dtype):
    """save_quantized → from_pretrained: every code, scale and parameter,
    and the features on the megakernel path, equal bit for bit; the
    artifact sits beside the released files, not under the JAX package's
    ``quantized/``, and loads as it is with ``quantize=True`` too."""
    px = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, JTINY.text.vocab_size, (3, 12))
    mask = np.ones_like(ids)
    mask[2, 5:] = 0
    src = _port(jparams, dtype=getattr(torch, dtype), use_flash=True,
                gelu_approx=True)
    q = src.quantize(calib_pixels=px[:2], calib_text=(ids, mask))
    d = tmp_path / "model"
    export.save_pretrained(str(d), src)
    export.save_quantized(str(d), q)
    assert (d / export.QUANTIZED_SUBDIR / export.QUANTIZED_FILE).exists()
    assert not (d / "quantized").exists()
    for kw in ({}, {"quantize": True}):
        back = KEEPModel.from_pretrained(str(d), use_flash=True, device="cpu",
                                         **kw)
        assert is_quantized(back) and back.dtype == q.dtype
        sd, want = back.state_dict(), q.state_dict()
        assert sorted(sd) == sorted(want)
        for k, v in want.items():
            assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
        for a, b in zip(_features(back, px[2:], ids, mask),
                        _features(q, px[2:], ids, mask)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="already-quantized"):
        export.save_quantized(str(d), src)


def test_int8_artifact_codes_match_jax_calibration(tmp_path):
    """The calibrated artifact's codes, read back, stand to the JAX
    package's calibrated ``quantize`` as ``test_calibrated_quantize_codes_
    match_jax`` holds the in-memory model's: within 1 in ≤ 1e-4 of the
    entries, scales and pre_scales at rtol 1e-6."""
    jp = jkeep.init(jax.random.PRNGKey(0), CAL_JCFG)
    px, ids, mask = _calib()
    jm = jkeep.KEEPModel(params=jp, cfg=CAL_JCFG).quantize(
        calib_pixels=jnp.asarray(px), calib_text=(jnp.asarray(ids),
                                                  jnp.asarray(mask)))
    port = KEEPModel(CAL_CFG, device="cpu")
    port.load_state_dict(from_jax_params(_np_tree(jp), CAL_CFG))
    export.save_quantized(str(tmp_path), port.quantize(
        calib_pixels=px, calib_text=(ids, mask)))
    back = KEEPModel.from_pretrained(str(tmp_path), device="cpu")
    moved = total = 0
    for prefix in ("visual", "text"):
        mv, tot = _codes_against_jax(getattr(back, prefix),
                                     jm.params[prefix], prefix)
        moved, total = moved + mv, total + tot
    assert moved <= CODE_SHARE * total


def _artifact_dir(jparams, tmp_path, rng):
    from chip_smoke import VOCAB

    src = _port(jparams, dtype=torch.bfloat16, use_flash=True)
    d = tmp_path / "model"
    export.save_pretrained(str(d), src)
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    q = src.quantize()
    export.save_quantized(str(d), q)
    return d, q


def test_serve_int8_serves_the_artifact_as_is(jparams, tmp_path, rng,
                                              capsys, monkeypatch):
    """``serve --int8`` on a dir with the artifact prints the JAX server's
    line, quantizes nothing, and serves the artifact's model; ``--lora``
    over it exits as the JAX server does (its merge needs float weights)."""
    from keep_tpu_torch import quant, serve

    d, q = _artifact_dir(jparams, tmp_path, rng)
    calls = []
    monkeypatch.setattr(quant, "quantize_linear_weights",
                        lambda *a, **k: calls.append(a))
    core, httpd = serve.build_server(["--model-dir", str(d), "--port", "0",
                                      "--device", "cpu", "--int8"])
    try:
        assert "serving it as-is" in capsys.readouterr().out
        assert calls == [] and is_quantized(core.model)
        assert all(torch.equal(core.model.state_dict()[k], v)
                   for k, v in q.state_dict().items())
        texts = ["an image", "a tumor"]
        got = core.encode_text(texts)
        enc = core.tokenizer(texts, max_length=core.max_length)
        with torch.no_grad():
            want = q.encode_text(torch.as_tensor(enc["input_ids"]),
                                 torch.as_tensor(enc["attention_mask"]))
        np.testing.assert_array_equal(got, want.numpy())
    finally:
        httpd.server_close()
        core.stop()
    (tmp_path / "run").mkdir()
    with pytest.raises(SystemExit, match="--lora cannot merge"):
        serve.build_server(["--model-dir", str(d), "--port", "0", "--device",
                            "cpu", "--int8", "--lora", str(tmp_path / "run"),
                            "--lora-scale", "2.0"])


def test_jax_quantized_dir_still_refused_alone(tmp_path, jparams):
    """A dir carrying only the JAX package's Orbax ``quantized/`` raises in
    the port, as before; beside the port's artifact, the port's loads."""
    d = tmp_path / "model"
    export.save_pretrained(str(d), _port(jparams))
    (d / "quantized").mkdir()
    with pytest.raises(NotImplementedError, match="quantized/"):
        KEEPModel.from_pretrained(str(d), device="cpu")
    export.save_quantized(str(d), _port(jparams).quantize())
    assert is_quantized(KEEPModel.from_pretrained(str(d), device="cpu"))


@pytest.mark.parametrize("w8a16", [False, True])
def test_int8_moe_artifact_roundtrip_bit_for_bit(tmp_path, rng, w8a16):
    """An MoE KEEP's int8 artifact (W8A8, and W8A16 experts under
    ``moe_w8a16``): save_quantized writes the experts (``weight_q`` [E, out,
    in], ``weight_scale``, ``bias``, their form), the fp32 router and the
    ``moe_*`` config fields; from_pretrained reads it back with every
    tensor, every expert's form and the features bit for bit, and
    ``serve --int8`` serves it as it is."""
    from keep_tpu_torch import quant, serve
    from keep_tpu_torch.models.moe import QExpertLinear
    from tests.test_torch_moe import _keep_cfgs

    jc, pc = _keep_cfgs()
    jp = jkeep.init(jax.random.PRNGKey(4), jc)
    src = KEEPModel(pc, device="cpu")
    src.load_state_dict(from_jax_params(_np_tree(jp), pc))
    q = src.eval().quantize(moe_w8a16=w8a16)
    d = tmp_path / "model"
    export.save_quantized(str(d), q)
    cfg = json.loads((d / "config.json").read_text())
    assert cfg["vision_config"]["moe_experts"] == 4
    back = KEEPModel.from_pretrained(str(d), device="cpu")
    assert back.cfg == q.cfg and back.moe
    experts = {n: m.w_only for n, m in back.named_modules()
               if isinstance(m, QExpertLinear)}
    assert len(experts) == 2 * pc.vision.depth
    assert set(experts.values()) == {w8a16}
    sd, want = back.state_dict(), q.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        if k.endswith("_extra_state"):
            assert sd[k] == v, k
        else:
            assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    assert back.visual.blocks[0].moe.router.weight.dtype == torch.float32
    px = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(1, pc.text.vocab_size, (2, 8))
    mask = np.ones_like(ids)
    for a, b in zip(_features(back, px, ids, mask),
                    _features(q, px, ids, mask)):
        assert torch.equal(a, b)
    from chip_smoke import VOCAB

    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    calls = []
    orig = quant.quantize_linear_weights
    try:
        quant.quantize_linear_weights = lambda *a, **k: calls.append(a)
        core, httpd = serve.build_server(["--model-dir", str(d), "--port",
                                          "0", "--device", "cpu", "--int8"])
    finally:
        quant.quantize_linear_weights = orig
    try:
        assert calls == [] and is_quantized(core.model)
        img = rng.integers(0, 255, (2, 16, 16, 3), dtype=np.uint8)
        got = core.encode_image(img)
        assert got.shape == (2, pc.projection_dim) and np.isfinite(got).all()
        assert {m.w_only for m in core.model.modules()
                if isinstance(m, QExpertLinear)} == {w8a16}
    finally:
        httpd.server_close()
        core.stop()
