"""The port's LoRA fine-tuning (``keep_tpu_torch.train.lora``) against the
JAX package's (``keep_tpu.train.lora``) on the CPU at tiny widths (2 layers
a tower, width 32), fp32, on the same numpy inputs: the base weights go
through ``from_jax_params`` and the adapters through ``from_jax_lora``. The
merged encoders, one train step, the weight-decay mask and the counts
against the JAX package; twins of ``tests/test_lora.py``; the training CLI
with LoRA; and ``serve --lora`` (bf16 and ``--int8``). Tolerances are
stated per test."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.train import lora as jlora
from keep_tpu.train import optim as joptim
from keep_tpu.train import trainer as jtrainer
from keep_tpu_torch import configs, serve
from keep_tpu_torch.compat.torch_loader import from_jax_lora, from_jax_params
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.ops.nn import Linear, QLinear
from keep_tpu_torch.train import checkpoint as ckpt
from keep_tpu_torch.train import lora, optim, schedules, trainer
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train.config import TrainRunConfig
from keep_tpu_torch.train.freeze import FreezeSchedule
from tests.test_torch_train import (CFG, JCFG, VOCAB, _batch,  # noqa: F401
                                    _port_model, _run_config, jparams,
                                    run_dirs)

SCALE = 2.0


def _jadapters(jparams, rank=4, seed=1, spread=0.05):
    """JAX adapters with nonzero ``b`` (a trained state), as numpy."""
    ad = jlora.init_lora(jax.random.PRNGKey(seed), jparams, rank=rank)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + spread * rng.standard_normal(
            np.shape(x))).astype(np.float32), ad)


def _base(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def _jax_mask_as_port(mask_tree, like) -> dict:
    """A JAX tree of Python bools (one per leaf of ``like``) → the port's
    adapter names."""
    full = jax.tree.map(lambda m, x: np.full(np.shape(x), float(m)),
                        mask_tree, like)
    return {k: bool(v.reshape(-1)[0])
            for k, v in from_jax_lora(full, CFG).items()}


# ---- against the JAX package -------------------------------------------------


def test_from_jax_lora_names_and_shapes(jparams):
    ad = _jadapters(jparams)
    got = from_jax_lora(ad, CFG)
    qkv = ad["visual"]["blocks"]["attn"]["qkv"]
    for i in range(2):
        np.testing.assert_array_equal(
            got[f"visual.blocks.{i}.attn.qkv.lora_a"].numpy(), qkv["a"][i])
        np.testing.assert_array_equal(
            got[f"visual.blocks.{i}.attn.qkv.lora_b"].numpy(), qkv["b"][i])
    assert got["visual_head.fc1.lora_a"].shape == (32, 4)
    assert got["text.blocks.1.attn.out.lora_b"].shape == (4, 32)
    # the same modules as the port's own init on the same weights
    port = lora.init_lora(from_jax_params(jparams, CFG), rank=4)
    assert got.keys() == port.keys()
    assert all(got[k].shape == port[k].shape for k in got)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_merged_encoders_match_jax(jparams, tower):
    """The port's encoders on ``apply_lora``'s merged tensors (swapped into
    the model) against the JAX encoders on its ``apply_lora``: features
    within 2e-5 (fp32, the Pallas attention in interpret mode); the
    model's own parameters untouched afterwards."""
    ad = _jadapters(jparams)
    merged = jlora.apply_lora(jax.tree.map(jnp.asarray, jparams),
                              jax.tree.map(jnp.asarray, ad), SCALE)
    model = _port_model(jparams)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    weights = lora.apply_lora(_base(model), from_jax_lora(ad, CFG), SCALE)
    b = _batch(np.random.default_rng(2))
    with torch.no_grad(), lora.swapped(model, weights):
        if tower == "image":
            got = model.encode_image(torch.from_numpy(b["pixels"]))
            want = jkeep.encode_image(merged, jnp.asarray(b["pixels"]), JCFG,
                                      use_flash=True)
        else:
            got = model.encode_text(torch.from_numpy(b["input_ids"]).long(),
                                    torch.from_numpy(b["attention_mask"]))
            want = jkeep.encode_text(merged, jnp.asarray(b["input_ids"]),
                                     jnp.asarray(b["attention_mask"]),
                                     cfg=JCFG, use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    for n, p in model.named_parameters():
        assert p is dict(model.named_parameters())[n]
        assert torch.equal(p.detach(), before[n]), n


@pytest.mark.parametrize("frozen_towers", [False, True])
def test_lora_train_step_matches_jax(jparams, frozen_towers):
    """One LoRA step (hierarchy loss, padded text, remat, the attention's
    custom VJP) against ``make_train_step(lora_scale=)`` of the JAX package
    from the same base and adapters, with both towers frozen (their
    adapters out of autograd, ``visual_head``'s training) or none: loss
    within rtol 1e-5 and the adapters within atol 1e-6, as
    ``test_train_step_matches_jax`` holds the full step; the base bit for
    bit as it was."""
    batch = _batch(np.random.default_rng(3))
    ad = _jadapters(jparams)
    loss_kw = dict(kind="hierarchy_metric", caption_num=4,
                   loss_subtype="lhp-hn")
    fs = FreezeSchedule(freeze_visual_epochs=int(frozen_towers),
                        freeze_text_epochs=int(frozen_towers))
    jtx = joptim.adamw(1e-3, weight_decay=0.2, grad_clip_norm=1.0)
    jstate = jtrainer.tree_state(jax.tree.map(jnp.asarray, ad), jtx)
    jfrozen = joptim.freeze_mask(jstate.params, fs.frozen_fn(0))
    jstatic = (jax.tree.map(lambda x: bool(np.asarray(x) > 0.5), jfrozen)
               if frozen_towers else None)
    jstep = jtrainer.make_train_step(
        JCFG, jtrainer.LossConfig(**loss_kw), jtx, dtype=jnp.float32,
        use_flash=True, donate=False, static_frozen=jstatic,
        lora_scale=SCALE)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jfrozen, jax.tree.map(jnp.asarray, jparams))

    model = _port_model(jparams)
    adapters = from_jax_lora(ad, CFG)
    tx = optim.AdamW(lambda s: 1e-3, decay_mask=optim.lora_wd_mask(adapters),
                     weight_decay=0.2, grad_clip_norm=1.0)
    state = trainer.tree_state(adapters, tx)
    frozen = optim.freeze_mask(state.params, fs.frozen_fn(0))
    static = ({n: f > 0.5 for n, f in frozen.items()} if frozen_towers
              else None)
    step = trainer.make_train_step(model, trainer.LossConfig(**loss_kw), tx,
                                   static_frozen=static, lora_scale=SCALE,
                                   base=_base(model))
    state, m = step(state, trainer.to_device(batch, "cpu"), frozen)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = from_jax_lora(jax.tree.map(np.asarray, jstate.params), CFG)
    assert state.params.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   want[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
    start = from_jax_lora(ad, CFG)
    moved = {k for k in want if not torch.equal(state.params[k].detach(),
                                                start[k])}
    if frozen_towers:
        assert moved and all(k.startswith(("visual_head.", "logit_scale"))
                             for k in moved), sorted(moved)
    else:
        assert any(k.startswith("visual.") for k in moved)
        assert any(k.startswith("text.") for k in moved)
    base = from_jax_params(jparams, CFG)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), base[n]), n
    # the optimizer's moments cover the adapters only
    assert state.opt_state["mu"].keys() == adapters.keys()


def test_lora_wd_mask_matches_jax(jparams):
    ad = _jadapters(jparams)
    want = _jax_mask_as_port(joptim.wd_mask(ad), ad)
    got = optim.lora_wd_mask(from_jax_lora(ad, CFG))
    assert got == want
    assert not got["logit_scale"] and got["visual_head.fc2.lora_b"]


def test_lora_param_count_matches_jax(jparams):
    """At the tiny width, and at ViT-L/16 + BERT-base (shapes only: the JAX
    tree through ``jax.eval_shape``, the port's model on the meta device):
    4,352,000 a / b values plus ``logit_scale``."""
    ad = _jadapters(jparams, rank=8)
    assert (lora.lora_param_count(from_jax_lora(ad, CFG))
            == jlora.lora_param_count(ad))
    full = jax.eval_shape(lambda: jlora.init_lora(
        jax.random.PRNGKey(1), jkeep.init(jax.random.PRNGKey(0),
                                          jcfgs.KEEPConfig()), rank=8))
    model = KEEPModel(configs.KEEPConfig(), device="meta")
    port = lora.init_lora(dict(model.named_parameters()), rank=8)
    assert lora.lora_param_count(port) == jlora.lora_param_count(full) == (
        4_352_001, 4_352_000)
    assert sum(math.prod(t.shape) for k, t in port.items()
               if k.startswith("visual_head.")) == 26_624


# ---- twins of tests/test_lora.py ---------------------------------------------


def test_init_apply_identity_and_targets(jparams):
    """b = 0 at init → merged == base exactly; only targeted modules carry
    adapters; unknown targets and rank 0 raise."""
    params = from_jax_params(jparams, CFG)
    gen = torch.Generator().manual_seed(1)
    ad = lora.init_lora(params, rank=3, targets=("qkv", "proj"),
                        generator=gen)
    merged = lora.apply_lora(params, ad, scale=2.0)
    assert merged.keys() == params.keys()
    for n in params:
        assert torch.equal(merged[n], params[n]), n
    # qkv in both towers, proj in the ViT only (BERT's is named 'out')
    assert {k.split(".")[0] for k in ad} == {"visual", "text", "logit_scale"}
    assert ad["visual.blocks.0.attn.qkv.lora_a"].shape == (32, 3)
    assert ad["visual.blocks.0.attn.qkv.lora_b"].shape == (3, 96)
    assert not ad["visual.blocks.1.attn.qkv.lora_b"].any()
    assert "text.blocks.0.attn.out.lora_a" not in ad
    assert not any(".mlp." in k for k in ad)
    # a ~ N(0, D^-1/2), drawn from the generator
    a = torch.cat([t.reshape(-1) for k, t in ad.items()
                   if k.endswith("lora_a")])
    assert float(a.std()) == pytest.approx(32 ** -0.5, rel=0.15)
    again = lora.init_lora(params, rank=3, targets=("qkv", "proj"),
                           generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(again[k], ad[k]) for k in ad)
    with pytest.raises(ValueError, match="no module"):
        lora.init_lora(params, rank=3, targets=("nonexistent",))
    with pytest.raises(ValueError, match="rank"):
        lora.init_lora(params, rank=0)
    total, ab = lora.lora_param_count(ad)
    n_base = sum(t.numel() for t in params.values())
    assert 0 < ab < 0.1 * n_base and total == ab + 1  # + logit_scale


def test_apply_changes_only_targeted_kernels(jparams):
    params = from_jax_params(jparams, CFG)
    ad = lora.init_lora(params, rank=2, targets=("fc1",))
    ad = {k: torch.full_like(v, 0.1) for k, v in ad.items()}
    merged = lora.merge_lora(params, ad, scale=0.5)
    for n in params:
        changed = not torch.allclose(merged[n], params[n])
        if n == "logit_scale":
            assert changed  # the all-0.1 adapters replace it
        else:
            assert changed == n.endswith("fc1.weight"), n
    # delta: 0.5 · (0.1 a) @ (0.1 b), inner dim r = 2
    w = "visual.blocks.0.mlp.fc1.weight"
    torch.testing.assert_close(merged[w] - params[w],
                               torch.full_like(params[w], 0.5 * 0.01 * 2),
                               atol=1e-6, rtol=0)


def test_train_step_updates_adapters_only(jparams):
    """make_train_step(lora_scale=): gradients reach a / b and
    logit_scale, the base is untouched, the loss falls over a few steps on
    a fixed batch."""
    model = _port_model(jparams, use_flash=False)
    base = _base(model)
    ad = lora.init_lora(base, rank=2, generator=torch.Generator()
                        .manual_seed(1))
    tx = optim.AdamW(schedules.cosine_lr(5e-3, 2, 20),
                     decay_mask=optim.lora_wd_mask(ad), weight_decay=0.0)
    state = trainer.tree_state(ad, tx)
    step = trainer.make_train_step(model, trainer.LossConfig(kind="clip"),
                                   tx, lora_scale=8.0, base=base)
    rng = np.random.default_rng(0)
    batch = trainer.to_device({
        "pixels": rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
        "input_ids": rng.integers(1, len(VOCAB), (8, 16)),
        "attention_mask": np.ones((8, 16), np.int32)}, "cpu")
    snap = {n: t.clone() for n, t in base.items()}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), snap[n]), n
    assert state.params["visual.blocks.0.attn.qkv.lora_b"].abs().max() > 0
    merged = lora.merge_lora(base, state.params, 8.0)
    w = "visual.blocks.0.attn.qkv.weight"
    assert not torch.allclose(merged[w], base[w])
    with pytest.raises(ValueError, match="base"):
        trainer.make_train_step(model, trainer.LossConfig(), tx,
                                lora_scale=1.0)


def _lora_config(run_dirs, out_dir, **solver) -> TrainRunConfig:
    solver = {"epochs": 2, "lora_rank": 2, "lora_alpha": 4.0,
              "freeze_visual_epochs": 0, "freeze_text_epochs": 0,
              "zeroshot_frequency": 1, **solver}
    return TrainRunConfig.from_dict(_run_config(run_dirs, out_dir, **solver))


def test_train_cli_lora(run_dirs, tmp_path):
    """solver.lora_rank through train(): finite losses, the eval on the
    merged model, checkpoints holding the adapter dict, resume from it, the
    merged model encoding; accum_freq > 1 refused."""
    cfg = _lora_config(run_dirs, tmp_path / "out")
    rng = np.random.default_rng(1)
    pixels = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    texts = (["an image of lung adenocarcinoma ."] * 4
             + ["melanoma of skin ."] * 4)
    res = tmain.train(cfg, eval_data={"zeroshot_ret": (pixels, texts)},
                      device="cpu")
    assert np.isfinite(res["train_loss"])
    assert "zeroshot-ret-p@10" in res
    ckpt_dir = str(tmp_path / "out" / "exp" / "checkpoints")
    restored = ckpt.restore(ckpt_dir)
    assert "visual.blocks.0.attn.qkv.lora_a" in restored["params"]
    assert "visual.blocks.0.attn.qkv.weight" not in restored["params"]
    assert restored["params"]["visual.blocks.0.attn.qkv.lora_b"].abs().max() > 0
    assert restored["opt_state"]["mu"].keys() == restored["params"].keys()
    log = (tmp_path / "out" / "exp" / "out.log").read_text()
    assert ("LoRA r=2 α=4 on ('qkv', 'proj', 'out', 'fc1', 'fc2'): 3,841 "
            "adapter params") in log

    cfg2 = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, epochs=3),
        save=dataclasses.replace(cfg.save, resume="latest"))
    res2 = tmain.train(cfg2, device="cpu")
    assert res2["epoch"] == 2 and np.isfinite(res2["train_loss"])

    # the merged export: base rebuilt from the seed + restored adapters
    model = tmain.build_model(cfg, "cpu")
    merged = lora.merge_lora(_base(model), restored["params"],
                             cfg.solver.lora_alpha / cfg.solver.lora_rank)
    with torch.no_grad(), lora.swapped(model, merged):
        feats = model.encode_image(torch.from_numpy(pixels[:2]))
    assert feats.shape == (2, 32) and torch.isfinite(feats).all()

    bad = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, accum_freq=2))
    with pytest.raises(ValueError, match="lora"):
        tmain.train(bad, device="cpu")


def test_lora_resume_equals_uninterrupted(run_dirs, tmp_path):
    """Two LoRA epochs straight against one, then resume 'latest' for the
    second: the same adapters and moments (atol 1e-7) over the same base."""
    tmain.train(_lora_config(run_dirs, tmp_path / "a"), device="cpu")
    tmain.train(_lora_config(run_dirs, tmp_path / "b", epochs=1),
                device="cpu")
    cfg = _lora_config(run_dirs, tmp_path / "b")
    cfg.save.resume = "latest"
    assert tmain.train(cfg, device="cpu")["epoch"] == 1
    pa = ckpt.restore(str(tmp_path / "a" / "exp" / "checkpoints"))
    pb = ckpt.restore(str(tmp_path / "b" / "exp" / "checkpoints"))
    assert pa["step"] == pb["step"] == 2
    for k in pa["params"]:
        torch.testing.assert_close(pa["params"][k], pb["params"][k],
                                   atol=1e-7, rtol=0)
        torch.testing.assert_close(pa["opt_state"]["nu"][k],
                                   pb["opt_state"]["nu"][k], atol=1e-7,
                                   rtol=0)


def test_swapped_restores_on_error(jparams):
    model = _port_model(jparams)
    p = model.visual.blocks[0].attn.qkv.weight
    with pytest.raises(RuntimeError, match="boom"):
        with lora.swapped(model, {"visual.blocks.0.attn.qkv.weight":
                                  torch.zeros_like(p)}):
            assert not model.visual.blocks[0].attn.qkv.weight.any()
            raise RuntimeError("boom")
    assert model.visual.blocks[0].attn.qkv.weight is p
    with pytest.raises(KeyError, match="not a parameter"):
        with lora.swapped(model, {"visual.blocks.0.attn.nope": p}):
            pass
    assert model.visual.blocks[0].attn.qkv.weight is p


# ---- serve --lora --------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_model_dir(tmp_path_factory, jparams):
    """The tiny base in the released layout (the JAX package's
    ``save_pretrained``), its vocab, and a LoRA checkpoint of trained-like
    adapters with the run's params.txt beside it."""
    from keep_tpu.compat.export import save_pretrained

    d = tmp_path_factory.mktemp("lora_serve")
    save_pretrained(str(d / "model"), jparams, JCFG)
    (d / "model" / "vocab.txt").write_text("\n".join(VOCAB))
    ad = _jadapters(jparams, rank=2, seed=3)
    ckpt.save(str(d / "run" / "checkpoints"), 0, from_jax_lora(ad, CFG),
              step=1)
    (d / "run" / "params.txt").write_text(
        json.dumps({"solver": {"lora_rank": 2, "lora_alpha": 4.0}}))
    return d, ad


def _served_model(monkeypatch, argv):
    captured = {}

    class StubServer:
        def __init__(self, model, tokenizer, **kw):
            captured["model"] = model

        def warmup(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(serve, "InferenceServer", StubServer)
    monkeypatch.setattr(serve, "make_http_server", lambda *a, **k: None)
    serve.build_server(argv)
    return captured["model"]


def test_serve_main_lora_merge(lora_model_dir, jparams, monkeypatch, capsys):
    """``serve --lora <checkpoints>`` with the scale from params.txt (4 / 2):
    every targeted weight's fp32 values are ``merge_lora`` of the restored
    adapters bit for bit, the stored bf16 weight is their one rounding,
    and they agree with the JAX package's ``merge_lora`` (atol 1e-6); the
    base differs. Without params.txt or --lora-scale the server exits
    naming the flag."""
    d, ad = lora_model_dir
    model = _served_model(monkeypatch, [
        "--model-dir", str(d / "model"), "--lora",
        str(d / "run" / "checkpoints"), "--device", "cpu"])
    assert "LoRA scale 2.0 from" in capsys.readouterr().out
    restored = ckpt.restore(str(d / "run" / "checkpoints"))["params"]
    base = from_jax_params(jparams, CFG)
    want = lora.merge_lora(base, restored, 2.0)
    jwant = from_jax_params(jax.tree.map(np.asarray, jlora.merge_lora(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, ad),
        2.0)), CFG)
    for m in lora.adapted_modules(restored):
        lin = model.get_submodule(m)
        w32 = lin.fp32_weight
        assert torch.equal(w32, want[f"{m}.weight"]), m
        assert torch.equal(lin.weight, w32.to(torch.bfloat16)), m
        torch.testing.assert_close(w32, jwant[f"{m}.weight"], atol=1e-6,
                                   rtol=0)
        assert not torch.equal(w32, base[f"{m}.weight"]), m
    assert torch.equal(model.logit_scale, restored["logit_scale"])

    (d / "run" / "params.txt").rename(d / "params.bak")
    try:
        with pytest.raises(SystemExit, match="--lora-scale"):
            _served_model(monkeypatch, [
                "--model-dir", str(d / "model"), "--lora",
                str(d / "run" / "checkpoints"), "--device", "cpu"])
        model = _served_model(monkeypatch, [
            "--model-dir", str(d / "model"), "--lora",
            str(d / "run" / "checkpoints"), "--lora-scale", "2.0",
            "--device", "cpu"])
        lin = model.visual.blocks[1].mlp.fc2
        assert torch.equal(lin.fp32_weight,
                           want["visual.blocks.1.mlp.fc2.weight"])
    finally:
        (d / "params.bak").rename(d / "run" / "params.txt")


def test_serve_lora_int8_quantizes_merged_fp32(lora_model_dir, jparams,
                                               monkeypatch):
    """``serve --lora --int8`` on the CPU quantizes the merged fp32 values:
    every QLinear's int8 codes and scales equal the JAX package's
    ``merge_lora`` then ``quantize()``. The JAX merge's fp32 sums come
    through ``from_jax_params`` into the same fp32 base the server loads,
    and where the two packages' merges round apart in the last bit the
    codes could move, so the adapters are drawn on a grid of 2^-8 with
    rank 2: every product and sum of the merge is exact in fp32."""
    d, _ = lora_model_dir
    rng = np.random.default_rng(5)
    ad = jax.tree.map(lambda x: (rng.integers(-16, 17, np.shape(x))
                                 / 256.0).astype(np.float32),
                      _jadapters(jparams, rank=2, seed=3))
    ck = d / "grid" / "checkpoints"
    ckpt.save(str(ck), 0, from_jax_lora(ad, CFG), step=1)
    model = _served_model(monkeypatch, [
        "--model-dir", str(d / "model"), "--lora", str(ck), "--lora-scale",
        "2.0", "--int8", "--device", "cpu"])
    jmodel = jkeep.KEEPModel(params=jlora.merge_lora(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, ad),
        2.0), cfg=JCFG).quantize()
    want = from_jax_params(jax.tree.map(np.asarray, jmodel.params), CFG)
    got = model.state_dict()
    q = [n for n, m in model.named_modules() if isinstance(m, QLinear)]
    assert len(q) == 2 * 4 * 2 + 2 + 1  # blocks, head, patch embed
    for n in q:
        assert torch.equal(got[f"{n}.weight_q"], want[f"{n}.weight_q"]), n
        assert torch.equal(got[f"{n}.weight_scale"],
                           want[f"{n}.weight_scale"]), n
    assert not any(isinstance(m, Linear) and m.fp32_weight is not None
                   for m in model.modules())
