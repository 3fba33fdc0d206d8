"""The port's training path against the JAX package's, on the CPU at tiny
widths (2 layers, width 32), in fp32, on the same numpy inputs and the same
initial weights (``keep.init`` → ``from_jax_params``; results come back
through ``to_jax_params``): schedules, one AdamW step against the optax
chain, static and dynamic freezing, accumulation, a full train step with the
Pallas attention (interpret mode) under its custom VJP, the batches, and
``train()`` end to end with resume. Tolerances are stated per test."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.train import data as jdata
from keep_tpu.train import main as jmain
from keep_tpu.train import optim as joptim
from keep_tpu.train import schedules as jsched
from keep_tpu.train import trainer as jtrainer
from keep_tpu.train.config import TrainRunConfig as JRunConfig
from keep_tpu.train.loss import DOGraph as JDOGraph
from keep_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from keep_tpu_torch import configs
from keep_tpu_torch.compat import torch_loader
from keep_tpu_torch.compat.torch_loader import from_jax_params, to_jax_params
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer
from keep_tpu_torch.train import checkpoint as ckpt
from keep_tpu_torch.train import data, optim, schedules, trainer
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train.config import TrainRunConfig
from keep_tpu_torch.train.freeze import FreezeSchedule, diff_report, snapshot
from keep_tpu_torch.train.loss import DOGraph

VISION = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=2)
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] lung cancer adenocarcinoma melanoma "
         "skin tumor normal tissue a an image of photomicrograph showing is "
         "shown this there h&e stain stained histopathological photograph "
         "example presence present disease cellular proliferation .").split()
TEXT = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=32,
                        max_text_length=16)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=32,
                         max_text_length=16)
NODES = {
    "DOID:14566": {"name": "disease of cellular proliferation", "parent": []},
    "DOID:lung": {"name": "lung cancer", "parent": ["DOID:14566"]},
    "DOID:luad": {"name": "lung adenocarcinoma", "parent": ["DOID:lung"]},
    "DOID:mel": {"name": "melanoma", "parent": ["DOID:14566"]},
}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, atol, rtol=0.0):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jparams():
    p = jkeep.init(jax.random.PRNGKey(0), JCFG)
    p["logit_scale"] = jnp.asarray(np.log(1 / 0.07), jnp.float32)
    return jax.tree.map(np.asarray, p)


def _port_model(jparams, **kw) -> KEEPModel:
    kw = {"dtype": torch.float32, "weight_dtype": torch.float32,
          "use_flash": True, "gelu_approx": False, **kw}
    m = KEEPModel(CFG, **kw)
    m.load_state_dict(from_jax_params(jparams, CFG), strict=True)
    return m


def _batch(rng, n=8, n_id=4, padded=True):
    mask = np.ones((n, 16), np.int32)
    if padded:
        for i in range(n):
            mask[i, int(rng.integers(3, 17)):] = 0
    node = np.ones((n_id, n_id), np.float32)
    node[0, 1] = node[1, 0] = -1.0
    return {"pixels": rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            "input_ids": rng.integers(1, len(VOCAB), (n, 16)).astype(np.int32),
            "attention_mask": mask, "node_connection": node}


def _jax_state_params(state):
    return jax.tree.map(np.asarray, state.params)


# ---- schedules and the optimizer -------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("cosine_lr", (1e-3, 5, 100)),
    ("const_lr", (2e-4, 3)),
    ("const_lr_cooldown", (1e-3, 2, 20, 10, 2.0, 1e-5)),
])
def test_schedules_equal_jax(name, args):
    """Both run the same float32 arithmetic; numpy's and XLA's cosine may
    differ in the last bit (rtol 1e-6)."""
    port, ref = getattr(schedules, name)(*args), getattr(jsched, name)(*args)
    for step in range(0, 101):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6), step


def test_wd_mask_equals_jax(jparams):
    model = _port_model(jparams)
    mask = optim.wd_mask(model)
    as_tree = to_jax_params({n: torch.full(p.shape, float(mask[n]))
                             for n, p in model.named_parameters()}, CFG)
    want = _flat(joptim.wd_mask(jparams))
    got = _flat(as_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k] == float(want[k])).all(), k


def _grads_like(jparams, rng, scale):
    """Small integers times a power of two: every sum of squares is exact
    in fp32 whatever the order, so both sides clip by the same norm."""
    return jax.tree.map(
        lambda x: (rng.integers(-3, 4, x.shape) * scale).astype(np.float32),
        jparams)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_steps_match_optax(jparams, rng, mu_dtype):
    """Two optimizer steps (the second reads moments the first stored) of
    the port's AdamW and the optax chain on the same gradients, with global
    norm clipping (the first step clips, the second does not), weight decay
    under wd_mask and the visual tower frozen: parameters, moments and the
    metrics within atol 1e-7."""
    sched = jsched.cosine_lr(1e-2, 1, 10)
    jtx = joptim.adamw(sched, weight_decay=0.2, grad_clip_norm=1.0,
                       mu_dtype=mu_dtype)
    jstate = jtrainer.tree_state(jax.tree.map(jnp.asarray, jparams), jtx)
    fs = FreezeSchedule(freeze_visual_epochs=1)
    jfrozen = joptim.freeze_mask(jstate.params, fs.frozen_fn(0))

    model = _port_model(jparams)
    tx = optim.AdamW(schedules.cosine_lr(1e-2, 1, 10),
                     decay_mask=optim.wd_mask(model), weight_decay=0.2,
                     grad_clip_norm=1.0, mu_dtype=mu_dtype)
    state = trainer.tree_state(model, tx)
    frozen = optim.freeze_mask(state.params, fs.frozen_fn(0))
    loss = torch.tensor(1.0)
    for scale in (1.0, 2.0 ** -12):
        jg = _grads_like(jparams, rng, scale)
        jstate, jm = jtrainer._optimizer_apply(
            jstate, jax.tree.map(jnp.asarray, jg), jtx, jfrozen,
            jnp.asarray(1.0))
        grads = {n: t.clone() for n, t in from_jax_params(jg, CFG).items()}
        state, m = trainer._optimizer_apply(state, grads, tx, frozen, loss)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["logit_scale"]) == pytest.approx(
            float(jm["logit_scale"]), rel=1e-6)
    _assert_trees_close(to_jax_params(model.state_dict(), CFG),
                        _jax_state_params(jstate), atol=1e-7)
    adam = jstate.opt_state[2][0]  # chain: bn mask, clip, adamw(adam, ...)
    assert int(adam.count) == state.opt_state["count"] == 2
    for key in ("mu", "nu"):
        got = {n: t.float() for n, t in state.opt_state[key].items()}
        _assert_trees_close(to_jax_params(got, CFG),
                            jax.tree.map(lambda x: np.asarray(x, np.float32),
                                         getattr(adam, key)), atol=1e-7)
    if mu_dtype == "bfloat16":
        assert all(t.dtype == torch.bfloat16
                   for t in state.opt_state["mu"].values())
    # the frozen tower did not move
    for n, p in model.named_parameters():
        if n.startswith("visual."):
            want = from_jax_params(jparams, CFG)[n]
            assert torch.equal(p.detach(), want), n


@pytest.mark.parametrize("epochs,fields", [
    (4, dict(freeze_visual_epochs=2, freeze_text_epochs=1)),
    (5, dict(freeze_visual_epochs=1, freeze_text_epochs=3,
             freeze_knowledge_epochs=2)),
    (3, dict()),
])
def test_freeze_phases_equal_jax(epochs, fields):
    """``FreezeSchedule.phases``: the change points of the frozen towers
    over a run, as the JAX package's (tests/test_train.py:122's schedule
    first)."""
    from keep_tpu.train.freeze import FreezeSchedule as JFreezeSchedule

    got = FreezeSchedule(**fields).phases(epochs)
    assert got == JFreezeSchedule(**fields).phases(epochs)
    if fields == dict(freeze_visual_epochs=2, freeze_text_epochs=1):
        assert got == [(0, frozenset({"visual", "text"})),
                       (1, frozenset({"visual"})), (2, frozenset())]


def test_adamw_refuses_unknown_mu_dtype():
    with pytest.raises(ValueError, match="mu_dtype"):
        optim.AdamW(lambda s: 1e-3, decay_mask={}, mu_dtype="float16")


# ---- train steps ------------------------------------------------------------


def test_train_step_matches_jax(jparams, rng):
    """One full step (hierarchy loss, padded text, remat, the attention's
    custom VJP) in fp32: loss within rtol 1e-5, updated parameters within
    atol 1e-6 (the gradients' sums run in another order)."""
    batch = _batch(rng)
    loss_kw = dict(kind="hierarchy_metric", caption_num=4,
                   loss_subtype="lhp-hn")
    jtx = joptim.adamw(1e-3, weight_decay=0.2, grad_clip_norm=1.0)
    jstate = jtrainer.tree_state(jax.tree.map(jnp.asarray, jparams), jtx)
    jstep = jtrainer.make_train_step(JCFG, jtrainer.LossConfig(**loss_kw),
                                     jtx, dtype=jnp.float32, use_flash=True,
                                     donate=False)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    model = _port_model(jparams)
    tx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.wd_mask(model),
                     weight_decay=0.2, grad_clip_norm=1.0)
    state = trainer.tree_state(model, tx)
    step = trainer.make_train_step(model, trainer.LossConfig(**loss_kw), tx)
    state, m = step(state, trainer.to_device(batch, "cpu"))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    _assert_trees_close(to_jax_params(model.state_dict(), CFG),
                        _jax_state_params(jstate), atol=1e-6)
    assert state.step == 1


def test_clip_step_clamps_logit_scale(jparams, rng):
    """The CLIP loss path, and logit_scale clamped to [0, ln 100] after the
    update, as in the JAX step."""
    model = _port_model(jparams)
    with torch.no_grad():
        model.logit_scale.fill_(10.0)
    tx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.wd_mask(model))
    state = trainer.tree_state(model, tx)
    step = trainer.make_train_step(model, trainer.LossConfig(kind="clip"), tx)
    batch = trainer.to_device(_batch(rng), "cpu")
    losses = [float(step(state, batch)[1]["loss"])]
    assert float(model.logit_scale.detach()) == pytest.approx(np.log(100.0))
    losses += [float(step(state, batch)[1]["loss"]) for _ in range(3)]
    assert float(model.logit_scale.detach()) <= np.log(100.0) + 1e-6
    assert losses[-1] < losses[0]
    assert state.step == 4


def test_static_freeze_equals_dynamic_mask(jparams, rng, monkeypatch):
    """requires_grad_(False) on both frozen towers: the same parameters and
    moments bit for bit as the dynamic mask alone, and no backward runs
    through either tower (the attention backward is never called)."""
    from keep_tpu_torch.kernels import flash_attention as fa

    calls = []
    real = fa.attention_qkv_slab_bwd_reference
    monkeypatch.setattr(fa, "attention_qkv_slab_bwd_reference",
                        lambda *a: calls.append(1) or real(*a))
    batch = trainer.to_device(_batch(rng), "cpu")
    fs = FreezeSchedule(freeze_visual_epochs=1, freeze_text_epochs=1)
    out = []
    for static in (False, True):
        model = _port_model(jparams)
        tx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.wd_mask(model),
                         grad_clip_norm=1.0)
        state = trainer.tree_state(model, tx)
        frozen = optim.freeze_mask(state.params, fs.frozen_fn(0))
        sf = {n: f > 0.5 for n, f in frozen.items()} if static else None
        step = trainer.make_train_step(model, trainer.LossConfig(
            caption_num=4), tx, static_frozen=sf)
        before = snapshot(state.params)
        calls.clear()
        for _ in range(2):
            state, _ = step(state, batch, frozen)
        n_bwd = len(calls)
        report = diff_report(before, state.params)
        assert report["visual"] == report["text"] == "frozen"
        assert report["visual_head"] == report["logit_scale"] == "open"
        if static:
            assert n_bwd == 0
            assert all(p.grad is None for p in model.parameters())
            assert not model.visual.blocks[0].attn.qkv.weight.requires_grad
        else:
            assert n_bwd == 2 * (VISION["depth"] + TEXT["num_hidden_layers"])
        out.append((model.state_dict(), copy.deepcopy(state.opt_state)))
    (sd_a, opt_a), (sd_b, opt_b) = out
    for n in sd_a:
        assert torch.equal(sd_a[n], sd_b[n]), n
    for key in ("mu", "nu"):
        for n in opt_a[key]:
            assert torch.equal(opt_a[key][n], opt_b[key][n]), (key, n)


def test_accum_step_matches_jax(jparams, rng):
    """accum_freq=2 with cached negatives and the hierarchy loss over ONE
    reachability matrix of the super-batch's 8 groups, against the JAX
    step: loss rtol 1e-5, parameters atol 1e-6."""
    accum, micro = 2, 8
    full = _batch(rng, n=accum * micro, n_id=8)
    stacked = {k: v.reshape((accum, micro) + v.shape[1:])
               for k, v in full.items() if k != "node_connection"}
    stacked["node_connection"] = full["node_connection"]
    loss_kw = dict(kind="hierarchy_metric", caption_num=4)
    jtx = joptim.adamw(1e-3, grad_clip_norm=1.0)
    jstate = jtrainer.tree_state(jax.tree.map(jnp.asarray, jparams), jtx)
    jstep = jtrainer.make_accum_train_step(
        JCFG, jtrainer.LossConfig(**loss_kw), jtx, accum, dtype=jnp.float32)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in stacked.items()})

    model = _port_model(jparams)
    tx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.wd_mask(model),
                     grad_clip_norm=1.0)
    state = trainer.tree_state(model, tx)
    step = trainer.make_accum_train_step(
        model, trainer.LossConfig(**loss_kw), tx, accum)
    state, m = step(state, trainer.to_device(stacked, "cpu"))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _assert_trees_close(to_jax_params(model.state_dict(), CFG),
                        _jax_state_params(jstate), atol=1e-6)


def test_accum_step_matches_full_batch(jparams, rng):
    """With the CLIP loss, two cached-negative chunks give the full-batch
    step (the cached features equal the live ones at the same parameters),
    within 5e-5 as the JAX package's own test holds it."""
    batch = _batch(rng, n=8)
    micro = {k: v.reshape((2, 4) + v.shape[1:]) for k, v in batch.items()
             if k != "node_connection"}
    results = []
    for accum in (1, 2):
        model = _port_model(jparams)
        tx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.wd_mask(model))
        state = trainer.tree_state(model, tx)
        lc = trainer.LossConfig(kind="clip")
        if accum == 1:
            step = trainer.make_train_step(model, lc, tx)
            state, m = step(state, trainer.to_device(batch, "cpu"))
        else:
            step = trainer.make_accum_train_step(model, lc, tx, 2)
            state, m = step(state, trainer.to_device(micro, "cpu"))
        results.append((float(m["loss"]), model.state_dict()))
    (l1, sd1), (l2, sd2) = results
    assert l2 == pytest.approx(l1, rel=1e-4)
    for n in sd1:
        if n != "logit_scale":  # its chunk gradients sum (~accum×)
            assert (sd1[n] - sd2[n]).abs().max() < 5e-5, n


# ---- data ---------------------------------------------------------------------


def write_run_data(d):
    """The training runs' data under the directory ``d`` (a Path): 8
    images in 4 groups, the knowledge graph and the vocabulary."""
    from PIL import Image

    img_dir = d / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i in range(8):
        names.append(f"im{i}.png")
        Image.fromarray(rng.integers(0, 255, (20, 18, 3), dtype=np.uint8)
                        ).save(img_dir / names[-1])
    groups = {
        "g_luad": {"captions": ["an image of lung adenocarcinoma ."],
                   "images": names[:2], "labels": {"DOID:luad": 1}},
        "g_lung": {"captions": ["lung cancer tissue .", "lung tumor ."],
                   "images": names[2:4], "labels": {"DOID:lung": 1}},
        "g_mel": {"captions": ["melanoma of skin ."],
                  "images": names[4:6], "labels": {"DOID:mel": 1}},
        "g_norm": {"captions": ["normal tissue is shown ."],
                   "images": names[6:], "labels": {}},
    }
    (d / "groups.json").write_text(json.dumps(groups))
    (d / "kg.json").write_text(json.dumps(NODES))
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    return d


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    return write_run_data(tmp_path_factory.mktemp("torch_train"))


def test_batch_iterator_matches_jax(run_dirs):
    """Two epochs of batches from the same seed: every array bit-identical
    to the JAX package's, the texts and labels equal."""
    kw = dict(num_instance=2, knowledge_json=str(run_dirs / "kg.json"),
              seed=3)
    ds = data.GroupDataset(str(run_dirs / "groups.json"), **kw)
    jds = jdata.GroupDataset(str(run_dirs / "groups.json"), **kw)
    nodes = data.load_knowledge_json(str(run_dirs / "kg.json"))
    it_kw = dict(img_dir=str(run_dirs / "images"), batch_size=4,
                 caption_num=2, image_size=16, max_length=16, seed=3,
                 workers=1)
    for epoch in range(2):
        ds.resample_epoch(epoch)
        jds.resample_epoch(epoch)
        got = list(data.BatchIterator(
            dataset=ds, tokenizer=WordPieceTokenizer(str(run_dirs /
                                                         "vocab.txt")),
            do_graph=DOGraph({k: v["parent"] for k, v in nodes.items()}),
            **it_kw))
        want = list(jdata.BatchIterator(
            dataset=jds, tokenizer=JTokenizer(str(run_dirs / "vocab.txt")),
            do_graph=JDOGraph({k: v["parent"] for k, v in nodes.items()}),
            **it_kw))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if isinstance(w[k], list):
                    assert g[k] == w[k], k
                else:
                    np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                                  err_msg=k)


def test_data_helpers_match_jax():
    text = "a histopathological image of lung adenocarcinoma with necrosis"
    for seed in range(20):
        assert (data.word_dropout(text, np.random.default_rng(seed))
                == jdata.word_dropout(text, np.random.default_rng(seed)))
        for node in ("DOID:luad", "DOID:mel", "normal"):
            assert (data.hierarchy_caption(NODES, node,
                                           np.random.default_rng(seed),
                                           use_syn=True, mixed=True)
                    == jdata.hierarchy_caption(NODES, node,
                                               np.random.default_rng(seed),
                                               use_syn=True, mixed=True))
        img = np.random.default_rng(seed).integers(0, 255, (10, 30, 3),
                                                   dtype=np.uint8)
        np.testing.assert_array_equal(
            data.random_crop(img, 16, np.random.default_rng(seed)),
            jdata.random_crop(img, 16, np.random.default_rng(seed)))


# ---- train() end to end -------------------------------------------------------


def _run_config(run_dirs, out_dir, **solver) -> dict:
    solver = {"epochs": 3, "lr": 1e-3, "warmup": 5, "lr_scheduler": "const",
              "freeze_visual_epochs": 1, "freeze_text_epochs": 0,
              "zeroshot_frequency": 0, **solver}
    return copy.deepcopy({
        "seed": 0,
        "dataset": {"train_data": str(run_dirs / "groups.json"),
                    "img_dir": str(run_dirs / "images"),
                    "knowledge_file": str(run_dirs / "kg.json"),
                    "vocab_path": str(run_dirs / "vocab.txt")},
        "dataloader": {"batch_size": 8, "caption_num": 4, "workers": 1},
        "solver": solver,
        "model": {"precision": "fp32", "type": "hierarchy_metric",
                  "use_flash": True},
        "save": {"output_dir": str(out_dir), "experiment_name": "exp",
                 "save_frequency": 1},
        "keep": {"vision": VISION, "text": TEXT, "projection_dim": 32,
                 "max_text_length": 16},
    })


def _losses(out_dir) -> list:
    lines = (out_dir / "exp" / "checkpoints" / "results.jsonl").read_text()
    return [json.loads(ln)["train_loss"] for ln in lines.splitlines()]


def _jax_initial_state_dict(cfg: JRunConfig) -> dict:
    """The JAX trainer's initial parameters (``build_params``), as the
    port's state dict."""
    p = jmain.build_params(cfg, cfg.seed)
    return from_jax_params(jax.tree.map(np.asarray, p), CFG)


@pytest.fixture(scope="module")
def jax_run(run_dirs, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_run")
    cfg = JRunConfig.from_dict(_run_config(run_dirs, d))
    jmain.train(cfg)
    return _losses(d), _jax_initial_state_dict(cfg)


def test_train_matches_jax(run_dirs, tmp_path, jax_run):
    """Three epochs (visual tower frozen in the first) through
    ``keep_tpu.train.main.train`` and the port's ``train``, from the same
    initial weights: the same per-epoch losses within rtol 1e-5; the freeze
    check and the checkpoints as the JAX run writes them."""
    want, init = jax_run
    cfg = TrainRunConfig.from_dict(_run_config(run_dirs, tmp_path))
    result = tmain.train(cfg, params=init, device="cpu")
    got = _losses(tmp_path)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert result["epoch"] == 2
    ckpt_dir = str(tmp_path / "exp" / "checkpoints")
    assert ckpt.list_epochs(ckpt_dir) == [0, 1, 2]
    assert ckpt.restore(ckpt_dir)["step"] == 3
    log = (tmp_path / "exp" / "out.log").read_text()
    assert "epoch 0 freeze check: {'logit_scale': 'open', 'visual': 'frozen'" \
        in log


def test_train_resume_equivalence(run_dirs, tmp_path):
    """Three epochs uninterrupted against one epoch, then resume 'latest'
    for two more: identical final parameters (the optimizer moments, the
    step count and the epoch-keyed data are restored). Twin of the JAX
    package's test_train_resume_equivalence."""
    tmain.train(TrainRunConfig.from_dict(_run_config(run_dirs,
                                                     tmp_path / "a")),
                device="cpu")
    tmain.train(TrainRunConfig.from_dict(_run_config(run_dirs, tmp_path / "b",
                                                     epochs=1)),
                device="cpu")
    cfg = TrainRunConfig.from_dict(_run_config(run_dirs, tmp_path / "b"))
    cfg.save.resume = "latest"
    assert tmain.train(cfg, device="cpu")["epoch"] == 2
    pa = ckpt.restore(str(tmp_path / "a" / "exp" / "checkpoints"))
    pb = ckpt.restore(str(tmp_path / "b" / "exp" / "checkpoints"))
    assert pa["step"] == pb["step"] == 3
    for n in pa["params"]:
        torch.testing.assert_close(pa["params"][n], pb["params"][n],
                                   rtol=0, atol=1e-7)
    assert _losses(tmp_path / "a")[1:] == _losses(tmp_path / "b")[1:]


def test_main_cli_with_json_config(run_dirs, tmp_path):
    """``main --config <json> --experiment-name --resume``: a JSON file is
    read without PyYAML, and the JAX package's loader reads the same file."""
    raw = _run_config(run_dirs, tmp_path, epochs=1)
    path = tmp_path / "run.json"
    path.write_text(json.dumps(raw))
    assert JRunConfig.from_yaml(str(path)).solver.epochs == 1
    out = tmain.main(["--config", str(path), "--experiment-name", "cli",
                      "--resume", "latest", "--device", "cpu"])
    assert out["epoch"] == 0
    assert ckpt.latest_epoch(str(tmp_path / "cli" / "checkpoints")) == 0
    # resuming a finished run trains nothing
    again = tmain.main(["--config", str(path), "--experiment-name", "cli",
                        "--resume", "latest", "--device", "cpu"])
    assert again == {"epoch": 0, "resumed": True}


def test_main_without_a_card_raises_unless_cpu_is_asked(run_dirs, tmp_path,
                                                        monkeypatch):
    """With no CUDA device, ``main`` (default ``--device cuda``) and
    ``train()`` raise SystemExit naming ``--device cpu`` before any output:
    the run never moves to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "run.json"
    path.write_text(json.dumps(_run_config(run_dirs, tmp_path, epochs=1)))
    with pytest.raises(SystemExit, match="--device cpu"):
        tmain.main(["--config", str(path)])
    with pytest.raises(SystemExit, match="--device cpu"):
        tmain.main(["--config", str(path), "--device", "cuda"])
    with pytest.raises(SystemExit, match="--device cpu"):
        tmain.train(TrainRunConfig.from_dict(_run_config(run_dirs, tmp_path)))
    assert not (tmp_path / "exp").exists()


def test_config_matches_jax_loader(tmp_path):
    """The same YAML gives the same run config in both packages; unknown
    keys raise in both."""
    import dataclasses

    path = "configs/keep_train.yml"
    got = TrainRunConfig.from_yaml(path)
    want = JRunConfig.from_yaml(path)
    for section in ("dataset", "dataloader", "solver", "model", "save"):
        a, b = (dataclasses.asdict(getattr(x, section)) for x in (got, want))
        assert a == b, section
    assert got.keep.projection_dim == want.keep.projection_dim
    assert dataclasses.asdict(got.keep.vision) == {
        k: v for k, v in dataclasses.asdict(want.keep.vision).items()
        if k in dataclasses.asdict(got.keep.vision)}
    with pytest.raises(KeyError, match="unknown config key"):
        TrainRunConfig.from_dict({"solver": {"nope": 1}})


@pytest.mark.parametrize("section,key,value", [
    ("solver", "tp", 2), ("solver", "pp", 2), ("solver", "sp", True),
    ("solver", "ep", 2), ("solver", "fsdp", True),
    ("keep.vision", "moe_experts", 4),
    ("dataset", "tokenizer_type", "clip"),
])
def test_refused_options_raise(run_dirs, tmp_path, section, key, value):
    """The parallel layouts raise the JAX trainer's ValueErrors in one
    process, before any output (tp, pp or ep = 2 does not divide one
    device; sp requires tp), and fsdp in one process trains unsharded, as
    the JAX trainer does on one device. An MoE trunk trains (``test_moe_train_step_matches_
    jax``); what stays refused for it is a dense pretrained image tower,
    as in the JAX package (keep_tpu/train/main.py:150-154). The CLIP
    tokenizer, refused until the fast tokenizers were ported, is now taken
    as the JAX trainer takes it: ``factory.get_tokenizer('clip', ...)``
    gives the BPE tokenizer of the merges file at ``dataset.vocab_path``."""
    raw = _run_config(run_dirs, tmp_path)
    node = raw
    for part in section.split("."):
        node = node.setdefault(part, {})
    node[key] = value
    if key == "tokenizer_type":
        from keep_tpu.factory import get_tokenizer as jax_get_tokenizer

        merges = tmp_path / "merges.txt"
        merges.write_text("#version: 0.2\na n\nt h\n")
        raw["dataset"]["vocab_path"] = str(merges)
        tok = tmain._tokenizer(TrainRunConfig.from_dict(raw))
        ref = jax_get_tokenizer("clip", str(merges))
        texts = ["an h&e image", "the tumour"]
        assert np.array_equal(tok(texts), ref(texts))
        assert tok(texts).shape == (2, 77)
    elif key == "moe_experts":
        raw["model"]["pretrained_image"] = str(tmp_path / "vit.bin")
        with pytest.raises(ValueError, match="cannot initialize an MoE"):
            tmain.train(TrainRunConfig.from_dict(raw))
    elif key == "tp":
        with pytest.raises(ValueError, match="solver.tp=2 does not divide 1"):
            tmain.train(TrainRunConfig.from_dict(raw))
    elif key == "sp":
        with pytest.raises(ValueError, match="requires solver.tp"):
            tmain.train(TrainRunConfig.from_dict(raw))
    elif key == "fsdp":
        res = tmain.train(TrainRunConfig.from_dict(raw), device="cpu")
        assert np.isfinite(res["train_loss"])
        return
    else:  # pp, ep: in one process, the JAX trainer's config error
        if key == "ep":  # on a dense trunk ep is the JAX config error
            raw["keep"]["vision"] = dict(VISION, moe_experts=4)
        with pytest.raises(ValueError,
                           match=f"solver.{key}=2 does not divide 1 devices"):
            tmain.train(TrainRunConfig.from_dict(raw))
    assert not (tmp_path / "exp").exists()  # refused before any output


def test_more_than_one_process_raises(run_dirs, tmp_path, monkeypatch):
    """More than one process trains (it was refused until data parallelism
    was ported; the two-process runs are in
    ``tests/test_torch_multiprocess.py``). What still raises, before any
    output and before joining a process group: a global batch that does
    not divide over the ranks (8 over 3). ``main`` with several visible
    cards and no launcher starts one worker per card; one process runs,
    with the eval sets handed in through ``eval_data``."""
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="dataloader.batch_size 8"):
        tmain.train(TrainRunConfig.from_dict(_run_config(run_dirs, tmp_path)),
                    device="cpu")
    assert not (tmp_path / "exp").exists()
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var)
    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(tmain, "spawn_local_workers",
                        lambda argv, n: launched.append((argv, n)))
    path = tmp_path / "run.json"
    path.write_text(json.dumps(_run_config(run_dirs, tmp_path)))
    assert tmain.main(["--config", str(path)]) is None
    assert launched == [(["--config", str(path)], 2)]
    monkeypatch.undo()
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    texts = ["lung cancer tissue .", "melanoma of skin .",
             "normal tissue is shown .", "an image of lung adenocarcinoma ."]
    raw = _run_config(run_dirs, tmp_path, epochs=1, zeroshot_frequency=1)
    res = tmain.train(TrainRunConfig.from_dict(raw), device="cpu",
                      eval_data={"val": (pixels, texts)})
    assert res["epoch"] == 0 and np.isfinite(res["val_contrastive_loss"])
    assert 1 <= res["image_to_text_mean_rank"] <= 4


# ---- checkpoints, loaders, init --------------------------------------------


def test_checkpoint_roundtrip_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.list_epochs(d) == [] and ckpt.latest_epoch(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d)
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    opt = {"count": 4, "mu": {"w": torch.ones(2, 3, dtype=torch.bfloat16)},
           "nu": {"w": torch.zeros(2, 3)}}
    for epoch in (0, 1, 10):
        ckpt.save(d, epoch, params, opt, step=epoch * 2)
    assert ckpt.list_epochs(d) == [0, 1, 10] and ckpt.latest_epoch(d) == 10
    out = ckpt.restore(d)
    assert out["epoch"] == 10 and out["step"] == 20
    assert torch.equal(out["params"]["w"], params["w"])
    assert out["opt_state"]["mu"]["w"].dtype == torch.bfloat16
    assert ckpt.restore(d, epoch=1)["step"] == 2
    ckpt.save(d, 11, params, opt, step=22, keep_previous=False)
    assert ckpt.list_epochs(d) == [11]
    assert not [f for f in (tmp_path / "ck").iterdir()
                if f.suffix == ".tmp"]


def test_to_jax_params_inverts_from_jax_params(jparams):
    back = to_jax_params(from_jax_params(jparams, CFG), CFG)
    _assert_trees_close(back, jparams, atol=0)
    with pytest.raises(ValueError, match="layers"):
        sd = from_jax_params(jparams, CFG)
        del sd["visual.blocks.1.norm1.weight"]
        to_jax_params(sd, CFG)


def test_pretrained_tower_loaders(tmp_path):
    """A timm ViT checkpoint and an HF BERT checkpoint (bare, or with the
    knowledge-BERT ``bert_model.`` prefix) load as the towers of the
    released layout do; build_model puts them over the random init."""
    gen = torch.Generator().manual_seed(0)
    released = torch_loader.random_keep_state_dict(CFG, gen)
    full = torch_loader.load_keep_state_dict(released, CFG)
    timm = {k[len("visual."):]: v for k, v in released.items()
            if k.startswith("visual.")}
    timm["head.weight"] = torch.zeros(3, VISION["embed_dim"])  # ignored
    bert = {k[len("text."):]: v for k, v in released.items()
            if k.startswith("text.")}
    vis = torch_loader.load_timm_vit_state_dict(timm, CFG)
    assert vis.keys() == {k for k in full if k.startswith("visual.")}
    for prefix in ("", "bert_model."):
        txt = torch_loader.load_hf_bert_state_dict(
            {prefix + k: v for k, v in bert.items()}, CFG)
        assert txt.keys() == {k for k in full if k.startswith("text.")}
        for k in txt:
            assert torch.equal(txt[k], full[k]), k
    torch.save(timm, tmp_path / "vit.pt")
    torch.save({"bert_model." + k: v for k, v in bert.items()},
               tmp_path / "bert.pt")
    raw = {"model": {"precision": "fp32",
                     "pretrained_image": str(tmp_path / "vit.pt"),
                     "pretrained_text": str(tmp_path / "bert.pt")},
           "keep": {"vision": VISION, "text": TEXT, "projection_dim": 32}}
    model = tmain.build_model(TrainRunConfig.from_dict(raw), "cpu")
    sd = model.state_dict()
    for k, v in {**vis, **txt}.items():
        assert torch.equal(sd[k], v.float()), k


def test_keep_init_statistics():
    """KEEPModel.init: the JAX package's keep.init statistics, fp32 master
    weights under bf16 compute, logit_scale = log(1 / logit_scale)."""
    model = KEEPModel.init(CFG, torch.Generator().manual_seed(0),
                           logit_scale=0.04, dtype=torch.bfloat16,
                           weight_dtype=torch.float32)
    assert float(model.logit_scale.detach()) == pytest.approx(np.log(25.0))
    blk = model.visual.blocks[0]
    assert blk.attn.qkv.weight.dtype == torch.float32
    assert torch.equal(blk.norm1.weight, torch.ones(VISION["embed_dim"]))
    assert not blk.attn.qkv.bias.any()
    assert torch.equal(blk.ls1, torch.full((32,), 1e-5))
    assert float(model.text.blocks[0].mlp.fc1.weight.detach().std()) == \
        pytest.approx(0.02, rel=0.1)
    assert float(blk.mlp.fc1.weight.detach().std()) == pytest.approx(
        32 ** -0.5, rel=0.1)


# ---- the Switch-MoE trunk ----------------------------------------------------

MOE_VISION = dict(VISION, moe_experts=2, moe_capacity_factor=1.25)
JCFG_MOE = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**MOE_VISION),
                            text=jcfgs.BertConfig(**TEXT), projection_dim=32,
                            max_text_length=16)
CFG_MOE = configs.KEEPConfig(vision=configs.ViTConfig(**MOE_VISION),
                             text=configs.BertConfig(**TEXT),
                             projection_dim=32, max_text_length=16)


def test_moe_train_step_matches_jax(rng):
    """One step of the MoE KEEP (2 experts, top-1, capacity factor 1.25)
    in fp32: the aux loss of the forward, the loss with
    ``moe_aux_weight · aux`` added, the gradient norm and every updated
    parameter (router and experts included) against the JAX trainer's."""
    jp = jkeep.init(jax.random.PRNGKey(1), JCFG_MOE)
    jp = jax.tree.map(np.asarray, jp)
    batch = _batch(rng)
    loss_kw = dict(kind="hierarchy_metric", caption_num=4,
                   loss_subtype="lhp-hn")
    _, jaux = jkeep.encode_image(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(batch["pixels"]), JCFG_MOE,
                                 return_aux=True)
    jtx = joptim.adamw(1e-3, weight_decay=0.2, grad_clip_norm=1.0)
    jstate = jtrainer.tree_state(jax.tree.map(jnp.asarray, jp), jtx)
    jstep = jtrainer.make_train_step(JCFG_MOE, jtrainer.LossConfig(**loss_kw),
                                     jtx, dtype=jnp.float32, use_flash=True,
                                     donate=False)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    model = KEEPModel(CFG_MOE, dtype=torch.float32,
                      weight_dtype=torch.float32, use_flash=True,
                      gelu_approx=False)
    model.load_state_dict(from_jax_params(jp, CFG_MOE), strict=True)
    with torch.no_grad():
        _, aux = model.encode_image(torch.from_numpy(batch["pixels"]),
                                    return_aux=True)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-6)
    tx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.wd_mask(model),
                     weight_decay=0.2, grad_clip_norm=1.0)
    assert optim.wd_mask(model)["visual.blocks.0.moe.router.weight"]
    state = trainer.tree_state(model, tx)
    step = trainer.make_train_step(model, trainer.LossConfig(**loss_kw), tx)
    state, m = step(state, trainer.to_device(batch, "cpu"))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    want = from_jax_params(_jax_state_params(jstate), CFG_MOE)
    # 5e-6 (0.5% of the learning rate) where the dense step holds 1e-6:
    # the one-hot dispatch einsums sum the gradients in another order, and
    # Adam's first step, lr·g / (|g| + ε), carries a tiny gradient's
    # relative difference into the update whole
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), atol=5e-6,
                                   err_msg=n)


def test_moe_train_matches_jax(run_dirs, tmp_path, tmp_path_factory):
    """``train.main.train`` with ``keep.vision.moe_experts = 2`` against
    ``keep_tpu.train.main.train`` from the same initial weights: one epoch,
    both towers unfrozen, the same loss within rtol 1e-5."""
    d = tmp_path_factory.mktemp("jax_moe_run")
    raw = _run_config(run_dirs, d, epochs=1, freeze_visual_epochs=0)
    raw["keep"]["vision"] = MOE_VISION
    jcfg = JRunConfig.from_dict(raw)
    jmain.train(jcfg)
    init = from_jax_params(jax.tree.map(
        np.asarray, jmain.build_params(jcfg, jcfg.seed)), CFG_MOE)
    raw = _run_config(run_dirs, tmp_path, epochs=1, freeze_visual_epochs=0)
    raw["keep"]["vision"] = MOE_VISION
    tmain.train(TrainRunConfig.from_dict(raw), params=init, device="cpu")
    got, want = _losses(tmp_path), _losses(d)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-5)
