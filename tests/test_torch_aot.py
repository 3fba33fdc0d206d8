"""``keep_tpu_torch.compat.aot`` (``torch.export`` bundles through the
``keep::`` operators) — twins of ``tests/test_aot.py``: one artifact with a
symbolic batch, ``use_flash`` requiring buckets, bucket pad-and-slice,
baked > lean, the manifest's contract and the int8 production config. On
the CPU the exported graph runs the operators' plain versions: within 1e-6
of the eager model, and within 2e-5 of the JAX package's ``load_aot`` at
fp32 on the same weights and inputs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.compat import aot as jaot
from keep_tpu.compat import export as jexport
from keep_tpu.models import keep as jkeep
from keep_tpu_torch.compat import aot
from keep_tpu_torch.compat.torch_loader import from_jax_params
from keep_tpu_torch.configs import KEEPConfig
from keep_tpu_torch.models.keep import KEEPModel
from tests.test_aot import TINY as JTINY
from tests.test_aot import _data

TINY = KEEPConfig.from_hf_dict(jexport._config_dict(JTINY))


@pytest.fixture(scope="module")
def jparams():
    return jkeep.init(jax.random.PRNGKey(0), JTINY)


def _model(jparams, **kw) -> KEEPModel:
    m = KEEPModel(TINY, device="cpu", **kw)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams),
                                      TINY))
    return m.eval()


def _eager(m, pixels, ids, mask):
    with torch.no_grad():
        return (m.encode_image(torch.from_numpy(pixels)).numpy(),
                m.encode_text(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask).long()).numpy())


def test_roundtrip_params_as_inputs(jparams, tmp_path):
    """One artifact with a symbolic batch; the loaded callable takes the
    state dict first; within 1e-6 of eager at every batch, 1 included, and
    within 2e-5 of the JAX package's bundle."""
    m = _model(jparams)
    aot.save_aot(str(tmp_path / "port"), m)
    jaot.save_aot(str(tmp_path / "jax"), jparams, JTINY, dtype=jnp.float32)
    b = aot.load_aot(str(tmp_path / "port"), device="cpu")
    jb = jaot.load_aot(str(tmp_path / "jax"))
    assert b.manifest["bake_params"] is False
    assert b.manifest["buckets"] == ["sym"]
    assert b.manifest["format"] == "torch.export"
    sd = m.state_dict()
    for batch in (1, 2, 5):
        pixels, ids, mask = _data(batch)
        img = b.encode_image(sd, pixels).numpy()
        txt = b.encode_text(sd, ids, mask).numpy()
        ref_i, ref_t = _eager(m, pixels, ids, mask)
        np.testing.assert_allclose(img, ref_i, atol=1e-6, rtol=0)
        np.testing.assert_allclose(txt, ref_t, atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            img, np.asarray(jb.encode_image(jparams, pixels)), atol=2e-5,
            rtol=2e-5)
        np.testing.assert_allclose(
            txt, np.asarray(jb.encode_text(jparams, ids, mask)), atol=2e-5,
            rtol=2e-5)


def test_flash_requires_buckets(jparams):
    with pytest.raises(ValueError, match="batch_sizes"):
        aot.export_encoders(_model(jparams), use_flash=True)


def test_bucketed_flash_export_pads_and_slices(jparams, tmp_path):
    """The kernels' path: fixed buckets, each call padded to the smallest
    covering bucket and sliced back; past the largest it raises. The graph
    records the ``keep::`` attention operator."""
    m = _model(jparams, use_flash=True)
    aot.save_aot(str(tmp_path), m, batch_sizes=(2, 4))
    b = aot.load_aot(str(tmp_path), device="cpu")
    assert b.manifest["buckets"] == ["2", "4"]
    sd = m.state_dict()
    for batch in (1, 2, 3, 4):
        pixels, ids, mask = _data(batch)
        img = b.encode_image(sd, pixels).numpy()
        txt = b.encode_text(sd, ids, mask).numpy()
        assert img.shape[0] == batch
        ref_i, ref_t = _eager(m, pixels, ids, mask)
        np.testing.assert_allclose(img, ref_i, atol=1e-6, rtol=0)
        np.testing.assert_allclose(txt, ref_t, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="exceeds"):
        b.encode_image(sd, _data(5)[0])
    ep = torch.export.load(str(tmp_path / "encode_image.2.pt2"))
    targets = {str(n.target) for n in ep.graph.nodes}
    assert "keep.attention_qkv_slab.default" in targets


def test_baked_params_is_self_contained(jparams, tmp_path):
    """Baked: no parameters argument, the weights in the files, which are
    larger than the lean export's."""
    m = _model(jparams)
    aot.save_aot(str(tmp_path / "baked"), m, bake_params=True)
    b = aot.load_aot(str(tmp_path / "baked"), device="cpu")
    assert b.manifest["bake_params"] is True
    pixels, ids, mask = _data(3)
    ref_i, ref_t = _eager(m, pixels, ids, mask)
    np.testing.assert_allclose(b.encode_image(pixels).numpy(), ref_i,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.encode_text(ids, mask).numpy(), ref_t,
                               atol=1e-6, rtol=0)
    lean = aot.export_encoders(m)
    baked = (tmp_path / "baked" / "encode_image.sym.pt2").stat().st_size
    assert baked > len(lean["encode_image"]["sym"])
    with pytest.raises(TypeError, match="data argument"):
        b.encode_image(m.state_dict(), pixels)


def test_manifest_records_contract(jparams, tmp_path):
    m = _model(jparams, dtype=torch.bfloat16)
    aot.save_aot(str(tmp_path), m)
    man = aot.load_aot(str(tmp_path), device="cpu").manifest
    assert man["img_size"] == TINY.vision.img_size
    assert man["max_text_length"] == TINY.max_text_length
    assert man["dtype"] == "bfloat16"
    assert man["platforms"] == ["cpu"]
    assert man["params"]["encode_image"][0].startswith("visual")
    assert all(k.startswith("text.") for k in man["params"]["encode_text"])


def test_int8_production_config_exports(jparams, tmp_path):
    """The shipped serving precision (the int8 model with its kernels)
    exports as bucketed, baked artifacts whose graph records the int8
    operators; at bf16, within 1e-6 of the eager int8 model (the same
    plain versions run), and near the JAX bundle of the same config."""
    m = _model(jparams, dtype=torch.bfloat16, use_flash=True,
               gelu_approx=True).quantize()
    aot.save_aot(str(tmp_path / "port"), m, batch_sizes=(2,),
                 bake_params=True)
    b = aot.load_aot(str(tmp_path / "port"), device="cpu")
    assert b.manifest["quantized"] is True
    pixels, ids, mask = _data(2)
    ref_i, ref_t = _eager(m, pixels, ids, mask)
    img = b.encode_image(pixels).numpy()
    np.testing.assert_allclose(img, ref_i, atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.encode_text(ids, mask).numpy(), ref_t,
                               atol=1e-6, rtol=0)
    ep = torch.export.load(str(tmp_path / "port" / "encode_image.2.pt2"))
    targets = {str(n.target) for n in ep.graph.nodes}
    assert {"keep.quant_rows.default", "keep.int8_gemm.default",
            "keep.attention_qkv_slab.default"} <= targets
    from keep_tpu.models.vit import fold_layerscale
    from keep_tpu.quant import quantize_linear_weights

    qp = dict(jparams)
    qp["visual"] = fold_layerscale(jparams["visual"])
    qp = quantize_linear_weights(qp)
    jaot.save_aot(str(tmp_path / "jax"), qp, JTINY, dtype=jnp.bfloat16,
                  use_flash=True, gelu_approx=True, batch_sizes=(2,))
    ref = np.asarray(jaot.load_aot(str(tmp_path / "jax")).encode_image(
        qp, pixels), np.float32)
    assert float(np.mean(np.sum(img * ref, 1))) > 0.999


def test_jax_bundle_refused_naming_its_format(tmp_path):
    (tmp_path / "aot_manifest.json").write_text(json.dumps(
        {"format": "jax.export/stablehlo", "buckets": ["sym"]}))
    with pytest.raises(ValueError, match="jax.export/stablehlo"):
        aot.load_aot(str(tmp_path), device="cpu")


def test_bundle_device(jparams, tmp_path, monkeypatch):
    """A bundle runs on the device type it was exported on; without
    ``device`` the loader asks for the card, which raises without one."""
    aot.save_aot(str(tmp_path), _model(jparams))
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        aot.load_aot(str(tmp_path), device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        aot.load_aot(str(tmp_path))
