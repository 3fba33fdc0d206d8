"""Remote sync (``keep_tpu_torch.train.sync``) and asynchronous checkpoints
(``train.checkpoint.CheckpointWriter``) on the CPU: twins of the JAX
package's sync tests (``tests/test_aux.py``, ``tests/test_coverage_gaps.py``)
and of ``tests/test_train_main.py::test_train_async_checkpointing``; an
async save that the next in-place step must not reach; and the training
CLI end to end with LoRA, the three eval sets, async checkpoints and a
local remote sync, whose adapters ``serve --lora`` then loads."""

import filecmp
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from keep_tpu_torch import serve
from keep_tpu_torch.train import checkpoint as ckpt
from keep_tpu_torch.train import lora, sync
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train.config import TrainRunConfig
from tests.test_torch_eval import _with_eval_sets, eval_dirs  # noqa: F401
from tests.test_torch_train import (VOCAB, _run_config,  # noqa: F401
                                    run_dirs)


# ---- sync: twins of the JAX package's ------------------------------------------


def test_remote_sync_local(tmp_path):
    src, dst = tmp_path / "ckpts", tmp_path / "remote"
    (src / "0").mkdir(parents=True)
    (src / "0" / "data.bin").write_bytes(b"abc")
    (src / "epoch_latest.bin").write_bytes(b"mutating")  # left out
    (src / "1.orbax-checkpoint-tmp").mkdir()
    (src / "1.orbax-checkpoint-tmp" / "shard").write_bytes(b"half")
    (src / "tmpab12.tmp").write_bytes(b"being written")  # a checkpoint's
    assert sync.remote_sync(str(src), str(dst))
    assert (dst / "0" / "data.bin").read_bytes() == b"abc"
    assert not (dst / "epoch_latest.bin").exists()
    assert not (dst / "1.orbax-checkpoint-tmp").exists()
    assert not (dst / "tmpab12.tmp").exists()


def test_remote_sync_incremental(tmp_path):
    src, dst = tmp_path / "a", tmp_path / "b"
    src.mkdir()
    f = src / "x.bin"
    f.write_bytes(b"v1")
    sync.remote_sync(str(src), str(dst))
    t1 = os.path.getmtime(dst / "x.bin")
    sync.remote_sync(str(src), str(dst))  # unchanged: not copied again
    assert os.path.getmtime(dst / "x.bin") == t1
    time.sleep(0.01)
    f.write_bytes(b"v2")
    os.utime(f)
    sync.remote_sync(str(src), str(dst))
    assert (dst / "x.bin").read_bytes() == b"v2"


def test_sync_process_lifecycle(tmp_path):
    """The child starts with the spawn method, syncs on its interval and
    stops on terminate()."""
    src = tmp_path / "s"
    src.mkdir()
    (src / "f.bin").write_bytes(b"z")
    p = sync.start_sync_process(1, str(src), str(tmp_path / "d"))
    try:
        assert p.is_alive() and type(p).__name__ == "SpawnProcess"
        deadline = time.time() + 60
        while not (tmp_path / "d" / "f.bin").exists():
            assert time.time() < deadline, "the child never synced"
            time.sleep(0.2)
    finally:
        p.terminate()
        p.join(timeout=10)
    assert not p.is_alive()


def test_remote_sync_error_and_loop_legs(tmp_path, caplog, monkeypatch):
    """remote_sync returns False, logged, when the backend raises; the
    loop's body logs each pass (it runs in the child, so covered inline)."""
    src = tmp_path / "ckpt"
    src.mkdir()
    (src / "a.txt").write_text("x")

    def boom(*a, **k):
        raise OSError("backend down")

    monkeypatch.setattr(sync, "sync_local", boom)
    with caplog.at_level(logging.ERROR):
        assert sync.remote_sync(str(src), str(tmp_path / "dst"),
                                "local") is False
    assert any("remote sync failed" in r.message for r in caplog.records)
    calls = []

    def fake_sleep(_):
        if calls:
            raise KeyboardInterrupt
        calls.append(1)

    monkeypatch.setattr(sync.time, "sleep", fake_sleep)
    monkeypatch.setattr(sync, "remote_sync", lambda *a: True)
    with caplog.at_level(logging.INFO), pytest.raises(KeyboardInterrupt):
        sync._loop(1, str(src), str(tmp_path / "dst2"), "local")
    assert any("remote sync ok" in r.message for r in caplog.records)


def test_sync_fsspec_roundtrip_and_size_skip(tmp_path):
    pytest.importorskip("fsspec")
    src = tmp_path / "ckpts"
    (src / "sub").mkdir(parents=True)
    (src / "epoch_1.pt").write_bytes(b"x" * 64)
    (src / "sub" / "results.jsonl").write_text("{}\n")
    (src / "epoch_latest.pt").write_bytes(b"y")  # left out
    dst = tmp_path / "remote"
    assert sync.sync_fsspec(str(src), f"file://{dst}") is True
    assert (dst / "epoch_1.pt").read_bytes() == b"x" * 64
    assert (dst / "sub" / "results.jsonl").exists()
    assert not (dst / "epoch_latest.pt").exists()
    # second pass: the same size is not uploaded again
    before = (dst / "epoch_1.pt").stat().st_mtime_ns
    assert sync.sync_fsspec(str(src), f"file://{dst}") is True
    assert (dst / "epoch_1.pt").stat().st_mtime_ns == before


def test_sync_fsspec_without_fsspec_returns_false(tmp_path, monkeypatch,
                                                  caplog):
    import builtins

    real = builtins.__import__

    def no_fsspec(name, *a, **k):
        if name == "fsspec":
            raise ImportError("no fsspec")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_fsspec)
    with caplog.at_level(logging.ERROR):
        assert sync.remote_sync(str(tmp_path), "s3://bucket/x") is False
    assert any("fsspec unavailable" in r.message for r in caplog.records)


def test_remote_sync_never_raises(monkeypatch, tmp_path):
    def boom(*a):
        raise OSError("disk on fire")

    monkeypatch.setattr(sync, "sync_local", boom)
    assert sync.remote_sync(str(tmp_path), str(tmp_path / "out")) is False


def test_remote_sync_protocol_routing(monkeypatch):
    routed = []
    monkeypatch.setattr(sync, "sync_local",
                        lambda *a: routed.append("local") or True)
    monkeypatch.setattr(sync, "sync_fsspec",
                        lambda *a: routed.append("fsspec") or True)
    sync.remote_sync("/a", "/b")                      # auto, no scheme
    sync.remote_sync("/a", "s3://bucket/x")           # auto, scheme
    sync.remote_sync("/a", "s3://bucket/x", "local")  # forced
    assert routed == ["local", "fsspec", "local"]


# ---- asynchronous checkpoints ---------------------------------------------------


@pytest.mark.parametrize("async_save", [False, True])
def test_save_is_not_changed_by_the_next_in_place_step(tmp_path, monkeypatch,
                                                       async_save):
    """``save`` returns holding its own host copy: a write held back until
    after the parameters and moments were updated in place (as
    ``_optimizer_apply`` does) still stores the values at ``save``."""
    release = threading.Event()
    real_save = torch.save

    def held_save(obj, f):
        release.wait(timeout=30)
        real_save(obj, f)

    monkeypatch.setattr(ckpt.torch, "save", held_save)
    params = {"w": torch.arange(6.0).reshape(2, 3),
              "logit_scale": torch.tensor(2.5)}
    opt = {"count": 1, "mu": {"w": torch.ones(2, 3)},
           "nu": {"w": torch.full((2, 3), 3.0)}}
    want = {k: v.clone() for k, v in params.items()}
    w = ckpt.CheckpointWriter(str(tmp_path), async_save=async_save)
    if not async_save:
        release.set()
    w.save(0, params, opt, step=7)
    with torch.no_grad():  # the next step
        params["w"].add_(100.0)
        params["logit_scale"].clamp_(0.0, 1.0)
        opt["mu"]["w"].mul_(0.0)
    release.set()
    w.close()
    out = ckpt.restore(str(tmp_path))
    for k in want:
        assert torch.equal(out["params"][k], want[k]), k
    assert torch.equal(out["opt_state"]["mu"]["w"], torch.ones(2, 3))
    assert out["step"] == 7 and out["epoch"] == 0


def test_async_writer_order_keep_previous_and_errors(tmp_path, monkeypatch):
    """Async saves land in order, ``keep_previous=False`` leaves the newest
    only, no ``.tmp`` is left behind, and a failed write re-raises at
    ``wait``."""
    w = ckpt.CheckpointWriter(str(tmp_path / "ck"), async_save=True,
                              keep_previous=False)
    for epoch in range(4):
        w.save(epoch, {"w": torch.full((3,), float(epoch))}, step=epoch)
    w.wait()
    assert ckpt.list_epochs(str(tmp_path / "ck")) == [3]
    assert ckpt.restore(str(tmp_path / "ck"))["params"]["w"][0] == 3.0

    def fail(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", fail)
    w.save(4, {"w": torch.zeros(3)})
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    w.close()
    assert not [p for p in (tmp_path / "ck").iterdir() if p.suffix == ".tmp"]
    assert ckpt.list_epochs(str(tmp_path / "ck")) == [3]


def test_train_async_checkpointing(run_dirs, tmp_path):
    """save.async_checkpointing: resume-latest finds the last epoch and the
    payload is whole, equal to a synchronous run's."""
    results = []
    for tag, flag in (("sync", False), ("async", True)):
        raw = _run_config(run_dirs, tmp_path / tag, epochs=2)
        raw["save"]["async_checkpointing"] = flag
        res = tmain.train(TrainRunConfig.from_dict(raw), device="cpu")
        assert np.isfinite(res["train_loss"])
        d = str(tmp_path / tag / "exp" / "checkpoints")
        assert ckpt.latest_epoch(d) == 1
        results.append(ckpt.restore(d))
    a, b = results
    assert a["step"] == b["step"] == 2
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for n in a["opt_state"]["nu"]:
        assert torch.equal(a["opt_state"]["nu"][n], b["opt_state"]["nu"][n])


def test_failed_initial_sync_stops_the_run(run_dirs, tmp_path):
    (tmp_path / "file").write_text("not a directory")
    raw = _run_config(run_dirs, tmp_path)
    raw["save"]["remote_sync"] = str(tmp_path / "file" / "remote")
    with pytest.raises(RuntimeError, match="initial remote sync"):
        tmain.train(TrainRunConfig.from_dict(raw), device="cpu")
    assert not (tmp_path / "exp" / "checkpoints" / "results.jsonl").exists()


# ---- the training CLI end to end, then serve --lora --------------------------------


def test_lora_eval_async_sync_cli_then_serve(run_dirs, eval_dirs, tmp_path,
                                             monkeypatch):
    """``python -m keep_tpu_torch.train.main --config <json> --device cpu``
    with LoRA (r 2, α 4), the three eval sets, async checkpoints and a local
    remote sync: the eval metrics in results.jsonl each epoch, the remote
    copy byte for byte without a ``.tmp``, and ``serve --lora`` of the
    written adapters over the same base in the released layout (the seed's
    draw) serving what the trained model's own merged encode gives (cosine
    ≥ 0.999 per row: the server runs bf16)."""
    raw = _with_eval_sets(_run_config(
        run_dirs, tmp_path / "runs", epochs=2, lora_rank=2, lora_alpha=4.0,
        freeze_visual_epochs=1, freeze_text_epochs=1, zeroshot_frequency=1),
        eval_dirs)
    raw["save"].update(async_checkpointing=True,
                       remote_sync=str(tmp_path / "remote"),
                       remote_sync_frequency=1)
    path = tmp_path / "run.json"
    path.write_text(json.dumps(raw))
    tmain.main(["--config", str(path), "--device", "cpu"])
    ckpt_dir = tmp_path / "runs" / "exp" / "checkpoints"
    lines = [json.loads(ln) for ln in
             (ckpt_dir / "results.jsonl").read_text().splitlines()]
    assert [ln["epoch"] for ln in lines] == [0, 1]
    for ln in lines:
        for key in ("zeroshot-cls-WF1-median", "zeroshot-ret-p@50",
                    "val_contrastive_loss", "text_to_image_mean_rank"):
            assert np.isfinite(ln[key]), key
    local = sorted(os.listdir(ckpt_dir))
    assert local == ["epoch_0.pt", "epoch_1.pt", "results.jsonl"]
    assert sorted(os.listdir(tmp_path / "remote")) == local
    _, mismatch, errors = filecmp.cmpfiles(ckpt_dir, tmp_path / "remote",
                                           local, shallow=False)
    assert not mismatch and not errors
    # epoch 0 froze both towers: their adapters still stand at init
    e0 = ckpt.restore(str(ckpt_dir), epoch=0)["params"]
    assert not e0["visual.blocks.0.attn.qkv.lora_b"].any()
    assert e0["visual_head.fc1.lora_b"].abs().max() > 0

    # the base the run trained over, in the released layout
    cfg = TrainRunConfig.from_dict(raw)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    chip_smoke.write_model(str(model_dir), torch, cfg.keep, device="cpu",
                           keep_init=True)
    (model_dir / "vocab.txt").write_text("\n".join(VOCAB))
    core, httpd = serve.build_server([
        "--model-dir", str(model_dir), "--lora", str(ckpt_dir), "--port",
        "0", "--device", "cpu"])
    try:
        texts = ["an image of lung adenocarcinoma .", "melanoma of skin ."]
        tiles = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3),
                                                  dtype=np.uint8)
        got_txt = core.encode_text(texts)
        got_img = core.encode_image(tiles)
    finally:
        httpd.server_close()
        core.stop()
    model = tmain.build_model(cfg, "cpu")
    restored = ckpt.restore(str(ckpt_dir))["params"]
    weights = lora.merge_lora({n: p.detach() for n, p in
                               model.named_parameters()}, restored, 2.0)
    from keep_tpu_torch.ops.preprocess import normalize_only

    enc = core.tokenizer(texts, max_length=core.max_length)
    with torch.no_grad(), lora.swapped(model, weights):
        want_txt = model.encode_text(torch.as_tensor(enc["input_ids"]).long(),
                                     torch.as_tensor(enc["attention_mask"]))
        want_img = model.encode_image(normalize_only(torch.from_numpy(tiles)))
    for got, want in ((got_txt, want_txt.numpy()), (got_img,
                                                     want_img.numpy())):
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999, cos
