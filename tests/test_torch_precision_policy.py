"""The server's per-bucket precision policy in the port against the JAX
package: ``utils.rtt.pick_from_medians`` / ``pick_by_probe``,
``InferenceServer(alt_model=, alt_buckets=)`` (routing, warmup, its three
refusals, the mesh rounding), and ``build_server``'s ``--int8
--precision-policy auto`` with the link's round trip and the probe faked as
the JAX server's tests fake them (tests/test_serve.py:318-475), then one
relay build's bucket-1 and bucket-8 features against the JAX server's."""

import gc
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from keep_tpu import serve as jserve
from keep_tpu.models import keep as jkeep
from keep_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from keep_tpu.utils import rtt as jrtt
from keep_tpu_torch import serve
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import make_mesh
from keep_tpu_torch.quant import is_quantized
from keep_tpu_torch.utils import rtt
from test_torch_serve import (JCFG, _vocab, core,  # noqa: F401
                              int8_model_dir, jparams, model_dir)

# the medians of tests/test_aux.py:161-172 and the JAX rule's choice
MEDIANS = [({"int8": 69.0, "bf16": 48.0}, "bf16"),
           ({"int8": 49.1, "bf16": 53.7}, "int8"),
           ({"int8": 50.0, "bf16": 47.0}, "int8"),
           ({"int8": 40.0, "bf16": 80.0}, "int8")]


@pytest.mark.parametrize("medians,choice", MEDIANS)
def test_pick_from_medians_matches_jax(medians, choice):
    assert rtt.PROBE_MARGIN == jrtt.PROBE_MARGIN == 1.10
    got = rtt.pick_from_medians(medians, "int8")
    assert got == jrtt.pick_from_medians(medians, "int8") == choice
    # a margin of one: the plain minimum, as JAX's
    assert rtt.pick_from_medians(medians, "int8", margin=1.0) == \
        jrtt.pick_from_medians(medians, "int8", margin=1.0)


def test_pick_by_probe_times_and_warms():
    """One warm call and ``n`` timed calls per candidate; the medians decide
    (the challenger clears the margin); without a default the minimum."""
    for mod in (rtt, jrtt):
        calls = {"fast": 0, "slow": 0}

        def mk(name, s):
            def f():
                calls[name] += 1
                time.sleep(s)
            return f

        choice, meds = mod.pick_by_probe(
            {"slow": mk("slow", 0.02), "fast": mk("fast", 0.002)}, n=3,
            default="slow")
        assert choice == "fast" and calls == {"fast": 4, "slow": 4}
        assert meds["fast"] < meds["slow"]
        assert meds["slow"] >= 20.0  # milliseconds
        choice, _ = mod.pick_by_probe(
            {"a": mk("fast", 0.002), "b": mk("slow", 0.02)}, n=1)
        assert choice == "a"


class _Tagged(torch.nn.Module):
    """``inner`` whose encodes count under ``tag``."""

    def __init__(self, inner, tag, calls):
        super().__init__()
        self.inner, self.tag, self.calls = inner, tag, calls

    def encode_text(self, ids, mask):
        self.calls[self.tag] += 1
        return self.inner.encode_text(ids, mask)

    def encode_image(self, px):
        self.calls[self.tag] += 1
        return self.inner.encode_image(px)


@pytest.mark.parametrize("alt", [{"text": (2,)}, {"image": (2,)}])
def test_alt_buckets_route_and_warm_up(core, alt):  # noqa: F811
    """Twin of the JAX ``test_per_bucket_precision_policy``: the listed
    (tower, bucket) dispatches go to ``alt_model``, the rest to the
    primary; warmup runs each (tower, bucket) once on the model that serves
    it; the results agree either way (the same weights here)."""
    calls = {"primary": 0, "alt": 0}
    srv = serve.InferenceServer(
        _Tagged(core.model, "primary", calls), core.tokenizer, max_length=16,
        image_size=16, buckets=(2, 4), max_delay_ms=1.0,
        alt_model=_Tagged(core.model, "alt", calls), alt_buckets=alt)
    tower = next(iter(alt))
    try:
        srv.warmup()
        assert calls == {"primary": 3, "alt": 1}
        calls.update(primary=0, alt=0)
        imgs = np.random.default_rng(1).integers(0, 255, (3, 16, 16, 3),
                                                 dtype=np.uint8)
        texts = ["tumor .", "normal tissue .", "a ."]
        enc = srv.encode_text if tower == "text" else srv.encode_image
        other = srv.encode_image if tower == "text" else srv.encode_text
        items = texts if tower == "text" else imgs
        one = enc(items[:1])                      # bucket 2 -> alt
        assert calls == {"primary": 0, "alt": 1}
        three = enc(items)                        # bucket 4 -> primary
        assert calls == {"primary": 1, "alt": 1}
        other(imgs[:1] if tower == "text" else texts[:1])  # no alt buckets
        assert calls == {"primary": 2, "alt": 1}
        np.testing.assert_allclose(one, three[:1], atol=1e-5)
    finally:
        srv.stop()


def test_alt_buckets_without_alt_model_rejected():
    for mod in (serve, jserve):
        with pytest.raises(ValueError, match="alt_model"):
            mod.InferenceServer(object(), object(),
                                alt_buckets={"text": (1,)})


def test_alt_buckets_must_exist_in_compiled_buckets():
    for mod in (serve, jserve):
        with pytest.raises(ValueError, match="not in"):
            mod.InferenceServer(object(), object(), buckets=(2, 4),
                                alt_model=object(),
                                alt_buckets={"text": (3,)})


def test_alt_buckets_unknown_tower_rejected():
    for mod in (serve, jserve):
        with pytest.raises(ValueError, match="tower 'txt' unknown"):
            mod.InferenceServer(object(), object(), buckets=(2, 4),
                                alt_model=object(),
                                alt_buckets={"txt": (2,)})


def test_mesh_rounds_bucket_1_away(core, jparams):  # noqa: F811
    """On a two-device mesh bucket 1 rounds to 2, so a policy for image
    bucket 1 is refused, in the JAX server's words; a policy for a bucket
    that survives the rounding replicates ``alt_model`` on each device."""
    from keep_tpu.parallel import make_mesh as jmake_mesh

    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    kw = dict(max_length=16, image_size=16, buckets=(1, 8),
              max_delay_ms=1.0)
    with pytest.raises(ValueError, match="not in") as got:
        serve.InferenceServer(core.model, core.tokenizer, mesh=mesh,
                              alt_model=core.model,
                              alt_buckets={"image": (1,)}, **kw)
    jm = jkeep.KEEPModel(params=jparams, cfg=JCFG)
    with pytest.raises(ValueError, match="not in") as want:
        jserve.InferenceServer(jm, JTokenizer(vocab=_vocab()),
                               mesh=jmake_mesh(2), alt_model=jm,
                               alt_buckets={"image": (1,)}, **kw)
    assert str(got.value) == str(want.value)
    srv = serve.InferenceServer(core.model, core.tokenizer, mesh=mesh,
                                alt_model=core.model,
                                alt_buckets={"image": (2,)}, **kw)
    try:
        assert srv.buckets == (2, 8) and len(srv._alt_replicas) == 2
        imgs = np.zeros((1, 16, 16, 3), np.uint8)
        np.testing.assert_allclose(srv.encode_image(imgs),
                                   core.encode_image(imgs), atol=1e-5)
    finally:
        srv.stop()


def _relay(monkeypatch, ms: float) -> None:
    """``rtt``'s memo at a link median of ``ms`` for the CPU device, as
    tests/test_serve.py:424 sets the JAX package's."""
    monkeypatch.setattr(rtt, "_memo", {"cpu": {
        "median_ms": ms, "p95_ms": ms, "min_ms": ms, "n": 1}})


@pytest.mark.parametrize("rtt_ms,probe_meds,expect_alt", [
    # relay link, bf16 > 10% faster at B=1: bf16 serves image bucket 1
    (28.0, {"int8": 69.0, "bf16": 48.0}, True),
    # relay link, int8 keeps its seat within the margin
    (28.0, {"int8": 49.1, "bf16": 53.7}, False),
    # co-located: int8 everywhere, the probe never runs
    (0.4, None, False),
])
def test_build_server_precision_policy_auto(model_dir, monkeypatch,  # noqa: F811
                                            capsys, rtt_ms, probe_meds,
                                            expect_alt):
    """Twin of the JAX ``test_serve_main_precision_policy_auto`` through the
    port's ``build_server``: the probe's candidates, the alt model and
    buckets handed to the server; after an int8 choice the bf16 model is
    gone (no reference keeps it); ``all-int8`` never probes."""
    _relay(monkeypatch, rtt_ms)
    probe_calls = []

    def fake_probe(candidates, *, n=5, default=None, margin=rtt.PROBE_MARGIN):
        probe_calls.append(sorted(candidates))
        assert sorted(candidates) == ["bf16", "int8"] and default == "int8"
        return rtt.pick_from_medians(probe_meds, default, margin), probe_meds

    monkeypatch.setattr(rtt, "pick_by_probe", fake_probe)
    quantized_from = []
    quantize = KEEPModel.quantize

    def recording(self, *a, **kw):
        quantized_from.append(weakref.ref(self))
        return quantize(self, *a, **kw)

    monkeypatch.setattr(KEEPModel, "quantize", recording)
    captured = {}

    class StubServer:
        def __init__(self, model, tokenizer, **kw):
            captured.update(model=model, alt_model=kw.get("alt_model"),
                            alt_buckets=kw.get("alt_buckets"))

        def warmup(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(serve, "InferenceServer", StubServer)
    monkeypatch.setattr(serve, "make_http_server", lambda *a, **k: None)
    argv = ["--model-dir", str(model_dir), "--device", "cpu", "--int8"]
    serve.build_server(argv)
    out = capsys.readouterr().out
    assert is_quantized(captured["model"])
    assert len(probe_calls) == (1 if probe_meds else 0)
    if expect_alt:
        assert captured["alt_buckets"] == {"image": (1,)}
        assert not is_quantized(captured["alt_model"])
        assert captured["alt_model"].dtype == torch.bfloat16
        assert quantized_from[0]() is captured["alt_model"]
        assert "image bucket 1 served bf16" in out
    else:
        assert captured["alt_model"] is None
        assert captured["alt_buckets"] is None
        gc.collect()
        assert all(r() is None for r in quantized_from)
        if probe_meds:
            assert "image bucket 1 served int8" in out
            assert "relay RTT median 28.0 ms" in out
        else:
            assert "co-located — int8 at every bucket (RTT median 0.400 ms)" \
                in out
            assert not quantized_from  # quantized at load, in place

    # all-int8 never probes, whatever the link
    serve.build_server(argv + ["--precision-policy", "all-int8"])
    assert captured["alt_model"] is None
    assert len(probe_calls) == (1 if probe_meds else 0)


def test_relay_policy_features_match_jax_server(int8_model_dir,  # noqa: F811
                                                monkeypatch):
    """A relay build whose probe picked bf16 serves image bucket 1 from the
    bf16 model (bit for bit its own ``encode_image``) and bucket 8 from the
    int8 model, each at test_torch_serve.py's gate (cosine ≥ 0.999 per row)
    against the JAX server built as its relay branch builds it on the same
    weights (``alt_model`` bf16, ``alt_buckets={"image": (1,)}``)."""
    from keep_tpu_torch.ops.preprocess import normalize_only

    _relay(monkeypatch, 28.0)
    monkeypatch.setattr(rtt, "pick_by_probe", lambda c, **kw: (
        "bf16", {"int8": 69.0, "bf16": 48.0}))
    d = str(int8_model_dir)
    core8, httpd = serve.build_server(["--model-dir", d, "--port", "0",
                                       "--device", "cpu", "--int8"])
    httpd.server_close()
    bf16 = jkeep.KEEPModel.from_pretrained(d, dtype=jax.numpy.bfloat16)
    jcore = jserve.InferenceServer(
        bf16.quantize(), JTokenizer(vocab=_vocab()), max_length=16,
        image_size=32, buckets=(1, 8), alt_model=bf16,
        alt_buckets={"image": (1,)})
    imgs = np.random.default_rng(11).integers(0, 255, (5, 32, 32, 3),
                                              dtype=np.uint8)
    try:
        assert core8.alt_buckets == {"image": frozenset({1})}
        one, five = core8.encode_image(imgs[:1]), core8.encode_image(imgs)
        with torch.inference_mode():
            own = core8.alt_model.encode_image(normalize_only(
                torch.from_numpy(imgs[:1]))).float().numpy()
            own8 = core8.model.encode_image(normalize_only(
                torch.from_numpy(imgs))).float().numpy()
        np.testing.assert_array_equal(one, own)
        np.testing.assert_array_equal(five, own8)
        for got, ref in ((one, jcore.encode_image(imgs[:1])),
                         (five, jcore.encode_image(imgs))):
            ref = np.asarray(ref, np.float32)
            cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                         * np.linalg.norm(ref, axis=-1))
            assert got.shape == ref.shape and cos.min() >= 0.999, cos
    finally:
        core8.stop()
        jcore.stop()
