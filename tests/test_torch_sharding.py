"""The 'dp' mesh in one process and the sharded WSI sweep of the port,
twins of ``tests/test_sharding.py``: the port's mesh is the CPU device
listed eight times (``make_mesh(8, devices=[cpu] * 8)``), the JAX
package's its 8-device CPU mesh; each result is held against the JAX
function on the same numpy inputs at the JAX test's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.parallel import batch_sharding as jbatch_sharding
from keep_tpu.parallel import make_mesh as jmake_mesh
from keep_tpu.wsi import extract as jextract
from keep_tpu.wsi import pipelines as jpipe
from keep_tpu.wsi import sharded as jsharded
from keep_tpu.wsi.grid import CoordGrid as JCoordGrid
from keep_tpu.zeroshot.classifier import prompt_select as jprompt_select
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import from_jax_params
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import (batch_sharding, make_mesh,
                                     pad_to_multiple, replicate, shard_batch)
from keep_tpu_torch.wsi import extract as textract
from keep_tpu_torch.wsi import pipelines as tpipe
from keep_tpu_torch.wsi.grid import CoordGrid
from keep_tpu_torch.wsi.sharded import (prompt_select_sharded,
                                        refined_probs_sharded)
from keep_tpu_torch.zeroshot.classifier import prompt_select

CPU8 = [torch.device("cpu")] * 8


def _mesh():
    return make_mesh(8, devices=CPU8)


def test_mesh_helpers():
    mesh = _mesh()
    assert len(mesh) == 8 and all(d == torch.device("cpu") for d in mesh)
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    parts = shard_batch(mesh, {"x": x})
    assert len(parts) == 8 and all(p["x"].shape == (2, 4) for p in parts)
    np.testing.assert_array_equal(torch.cat([p["x"] for p in parts]).numpy(),
                                  x)
    assert [s.start for s in batch_sharding(mesh, 16)] == list(range(0, 16, 2))
    with pytest.raises(ValueError, match="does not divide"):
        batch_sharding(mesh, 10)
    padded, n = pad_to_multiple(np.ones((10, 3)), 8)
    assert padded.shape == (16, 3) and n == 10
    assert make_mesh(3, devices=CPU8) == tuple(CPU8[:3])
    # the errors that stay: a mesh larger than the devices present; a
    # 'dp' × 'mp', 'dp' × 'pp' or 'dp' × 'ep' mesh lays out the ranks of a
    # process group, which needs one (the layouts build over gloo ranks in
    # tests/test_torch_pp.py and tests/test_torch_ep.py); an axis the
    # meshes do not have
    with pytest.raises(ValueError, match="needs 9 present, found 8"):
        make_mesh(9, devices=CPU8)
    for axes in (("dp", "pp"), ("dp", "ep")):
        with pytest.raises(ValueError, match="process group"):
            make_mesh(axes=axes, devices=CPU8)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(axes=("dp", "mp"), devices=CPU8)
    with pytest.raises(ValueError, match="each one of"):
        make_mesh(axes=("dp", "sp"), devices=CPU8)
    model = torch.nn.Linear(2, 2)
    assert all(m is model for m in replicate(mesh, model))


def test_sharded_wsi_scoring_matches_single(rng):
    """Per-tile softmax scores over the mesh equal the single-device port's
    (atol 1e-6, the JAX test's), and the JAX mesh run's at 2e-6: at this
    width (D = 64, classifier columns of norm ~8) the one-device port
    itself sits 1.4e-6 from the JAX ``score_tiles`` (fp32 sums in another
    order, times the scale of 10); the sharding adds nothing to that."""
    feats = rng.standard_normal((8 * 125, 64)).astype(np.float32)
    cls = rng.standard_normal((64, 3)).astype(np.float32)
    single = tpipe.score_tiles(cls, feats).numpy()
    got = tpipe.score_tiles_sharded(cls, feats, mesh=_mesh()).numpy()
    np.testing.assert_allclose(got, single, atol=1e-6)
    jmesh = jmake_mesh(8)
    want = jax.jit(jpipe.score_tiles,
                   in_shardings=(NamedSharding(jmesh, P()),
                                 jbatch_sharding(jmesh)),
                   out_shardings=jbatch_sharding(jmesh))(
        jax.device_put(jnp.asarray(cls), NamedSharding(jmesh, P())),
        jax.device_put(jnp.asarray(feats), jbatch_sharding(jmesh)))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(single, np.asarray(want), atol=2e-6)


def test_score_tiles_sharded_api(rng):
    feats = rng.standard_normal((1003, 32)).astype(np.float32)  # indivisible
    cls = rng.standard_normal((32, 2)).astype(np.float32)
    jmesh = jmake_mesh(8)
    for scale in (10.0, 1.0):  # the scale is forwarded
        got = tpipe.score_tiles_sharded(cls, feats, mesh=_mesh(),
                                        scale=scale).numpy()
        want = np.asarray(jpipe.score_tiles_sharded(
            jnp.asarray(cls), feats, mesh=jmesh, scale=scale))
        assert got.shape == (1003, 2)
        np.testing.assert_allclose(
            got, tpipe.score_tiles(cls, feats, scale=scale).numpy(),
            atol=1e-6)
        # the one-device port is 1.6e-6 from JAX here (see above)
        np.testing.assert_allclose(got, want, atol=2e-6)
    assert not np.allclose(got, tpipe.score_tiles(cls, feats).numpy())


JCFG = jcfgs.KEEPConfig(
    vision=jcfgs.ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                           num_heads=4),
    text=jcfgs.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=64,
                          max_position_embeddings=32),
    projection_dim=48)
CFG = configs.KEEPConfig(
    vision=configs.ViTConfig(img_size=32, patch_size=16, embed_dim=64,
                             depth=2, num_heads=4),
    text=configs.BertConfig(vocab_size=64, hidden_size=32,
                            num_hidden_layers=1, num_attention_heads=2,
                            intermediate_size=64, max_position_embeddings=32),
    projection_dim=48)


def test_extract_features_sharded_parity(rng):
    """The feature extraction over the mesh at an indivisible tile count:
    the batch rounds up to the mesh (6 → 8), features equal the
    one-device port's and the JAX mesh run's within 1e-5."""
    params = jkeep.init(jax.random.PRNGKey(0), JCFG)
    jmodel = jkeep.KEEPModel(params=params, cfg=JCFG, dtype=jnp.float32)
    port = KEEPModel(CFG)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                         CFG))
    port.eval()
    tiles = rng.integers(0, 255, (8 * 3 + 5, 32, 32, 3)).astype(np.uint8)
    single = textract.extract_features(port, tiles, batch_size=8)
    sharded = textract.extract_features(port, tiles, batch_size=6,
                                        mesh=_mesh())
    assert sharded.shape == (len(tiles), CFG.projection_dim)
    np.testing.assert_allclose(sharded, single, atol=1e-5)
    want = jextract.extract_features(jmodel, tiles, batch_size=6,
                                     mesh=jmake_mesh(8))
    np.testing.assert_allclose(sharded, want, atol=1e-5)
    # an iterable of chunks, and a two-device mesh, give the same rows
    two = textract.extract_features(port, iter([tiles[:11], tiles[11:]]),
                                    batch_size=5, mesh=make_mesh(
                                        2, devices=CPU8))
    np.testing.assert_allclose(two, single, atol=1e-5)


def test_accum_step_on_mesh(rng):
    """Twin of the JAX package's cached-negative accumulation step with the
    microbatch axis on its mesh: the port's accumulation step (its
    multi-process form runs in ``test_torch_multiprocess.py``) gives the
    same loss (rtol 1e-5), one optimizer step."""
    from keep_tpu.train import optim as joptim
    from keep_tpu.train.trainer import (LossConfig as JLossConfig,
                                        make_accum_train_step as jaccum,
                                        tree_state as jtree_state)
    from keep_tpu_torch.train import optim, trainer
    from tests.test_train import TINY, make_batch

    from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig

    jmesh = jmake_mesh(8)
    params = jkeep.init(jax.random.PRNGKey(0), TINY)
    host_params = jax.tree.map(np.asarray, params)  # the step donates
    tx = joptim.adamw(1e-3)
    batch = make_batch(np.random.default_rng(0), 16, n_id=4)
    micro = {k: (v.reshape((2, 8) + v.shape[1:]) if k != "node_connection"
                 else np.stack([v, v])) for k, v in batch.items()}
    with jax.set_mesh(jmesh):
        repl = NamedSharding(jmesh, P())
        data = NamedSharding(jmesh, P(None, "dp"))
        state = jax.device_put(jtree_state(params, tx), repl)
        placed = {k: jax.device_put(jnp.asarray(v), repl
                                    if k == "node_connection" else data)
                  for k, v in micro.items()}
        jstep = jaccum(TINY, JLossConfig(kind="clip"), tx, 2,
                       dtype=jnp.float32)
        state, jm = jstep(state, placed)

    cfg = KEEPConfig(vision=ViTConfig(**{
        k: getattr(TINY.vision, k) for k in ("img_size", "patch_size",
                                             "embed_dim", "depth",
                                             "num_heads")}),
        text=BertConfig(**{k: getattr(TINY.text, k) for k in (
            "vocab_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size",
            "max_position_embeddings")}),
        projection_dim=TINY.projection_dim,
        max_text_length=TINY.max_text_length)
    model = KEEPModel(cfg, dtype=torch.float32, weight_dtype=torch.float32,
                      use_flash=True, gelu_approx=False)
    model.load_state_dict(from_jax_params(host_params, cfg), strict=True)
    ttx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.wd_mask(model))
    tstate = trainer.tree_state(model, ttx)
    arrays = {k: v for k, v in micro.items() if k != "node_connection"}
    arrays["node_connection"] = batch["node_connection"]
    step = trainer.make_accum_train_step(model, trainer.LossConfig(
        kind="clip"), ttx, 2)
    tstate, m = step(tstate, trainer.to_device(arrays, "cpu"))
    assert tstate.step == int(state.step) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)


def test_prompt_select_sharded_parity(rng):
    """Screening over the mesh at an indivisible tile count equals the
    single-device screening (the padding masked out of the mean) and the
    JAX sharded one (atol 1e-5), the top-n clamp included."""
    p, d, c, n = 23, 32, 3, 1003
    cls = rng.standard_normal((p, d, c)).astype(np.float32)
    cls /= np.linalg.norm(cls, axis=1, keepdims=True)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    for topn in (5, 50):
        got = prompt_select_sharded(cls, feats, mesh=_mesh(),
                                    topn=topn).numpy()
        np.testing.assert_allclose(
            got, prompt_select(cls, feats, topn=topn).numpy(), atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(
            jprompt_select(jnp.asarray(cls), jnp.asarray(feats), topn=topn)),
            atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(
            jsharded.prompt_select_sharded(jnp.asarray(cls), feats,
                                           mesh=jmake_mesh(8), topn=topn)),
            atol=1e-5)


def test_refined_probs_sharded_parity(rng):
    """Score → scatter → refine → gather over the mesh equals the
    single-device sweep and the JAX sharded one at an indivisible patch
    count with duplicates and holes (atol 1e-6)."""
    d, n = 32, 531
    feats = rng.standard_normal((n, d)).astype(np.float32)
    cls = rng.standard_normal((d, 2)).astype(np.float32)
    side = 25
    cells = rng.choice(side * side, size=n, replace=True)
    coords = np.stack([(cells % side) * 224, (cells // side) * 224], 1)
    grid = CoordGrid.from_coords(coords, 224)
    for overlap in (True, False):
        got = refined_probs_sharded(cls, feats, coords, 224, mesh=_mesh(),
                                    overlap=overlap)
        assert got.shape == (grid.num_patches, 2)
        ref = tpipe.refined_tumor_probs(cls, feats, grid,
                                        overlap=overlap).numpy()
        np.testing.assert_allclose(got[:, 1], ref, atol=1e-6)
        want = jsharded.refined_probs_sharded(
            jnp.asarray(cls), feats, coords, 224, mesh=jmake_mesh(8),
            overlap=overlap)
        np.testing.assert_allclose(got, want, atol=1e-6)
    jref = np.asarray(jpipe.refined_tumor_probs(
        jnp.asarray(cls), jnp.asarray(feats), JCoordGrid.from_coords(
            coords, 224), overlap=True))
    got = refined_probs_sharded(cls, feats, coords, 224, mesh=_mesh())
    np.testing.assert_allclose(got[:, 1], jref, atol=1e-6)
