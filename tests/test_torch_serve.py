"""The port's batching server (keep_tpu_torch.serve) against the JAX server
on the same tiny weights, over HTTP, plus the twins of the JAX server's
batching tests and the CLI construction path (on the CPU)."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu import serve as jserve
from keep_tpu.models import keep as jkeep
from keep_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from keep_tpu_torch import configs, serve
from keep_tpu_torch.compat.torch_loader import (from_jax_params,
                                                random_keep_state_dict)
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK] lung tumor normal tissue image of a .".split()
VISION = dict(img_size=16, patch_size=8, embed_dim=32, depth=1, num_heads=2)
TEXT = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=32,
                        max_text_length=16)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=32,
                         max_text_length=16)


def _vocab():
    return {w: i for i, w in enumerate(VOCAB)}


@pytest.fixture(scope="module")
def jparams():
    return jkeep.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def core(jparams):
    model = KEEPModel(CFG)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams),
                                          CFG))
    c = serve.InferenceServer(model.eval(), WordPieceTokenizer(vocab=_vocab()),
                              max_length=16, image_size=16, buckets=(2, 4),
                              max_delay_ms=20.0)
    yield c
    c.stop()


@pytest.fixture(scope="module")
def jcore(jparams):
    c = jserve.InferenceServer(jkeep.KEEPModel(params=jparams, cfg=JCFG),
                               JTokenizer(vocab=_vocab()), max_length=16,
                               image_size=16, buckets=(2, 4),
                               max_delay_ms=20.0)
    yield c
    c.stop()


class _Http:
    def __init__(self, httpd):
        self.httpd = httpd
        self.port = httpd.server_address[1]
        self.thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, path, body, binary=False):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=body if binary else json.dumps(body).encode(),
            headers={"Content-Type": "application/octet-stream" if binary
                     else "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read()
        return np.load(io.BytesIO(raw)) if binary else json.loads(raw)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def test_endpoints_match_jax_server(core, jcore):
    ours = _Http(serve.make_http_server(core, port=0))
    theirs = _Http(jserve.make_http_server(jcore, port=0))
    try:
        texts = {"texts": ["an image of lung tumor .", "normal tissue ."]}
        a = ours.post("/encode_text", texts)["embeddings"]
        b = theirs.post("/encode_text", texts)["embeddings"]
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)

        imgs = np.random.default_rng(5).integers(0, 255, (3, 16, 16, 3),
                                                 dtype=np.uint8)
        buf = io.BytesIO()
        np.save(buf, imgs)
        a = ours.post("/encode_image_npy", buf.getvalue(), binary=True)
        b = theirs.post("/encode_image_npy", buf.getvalue(), binary=True)
        assert a.shape == (3, 32) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)

        # non-model-size images take the host-side PIL resize in both
        odd = np.random.default_rng(6).integers(0, 255, (2, 20, 24, 3),
                                                dtype=np.uint8)
        sim = {"texts": ["a image of ."], "images": odd.tolist()}
        a = ours.post("/similarity", sim)["logits"]
        b = theirs.post("/similarity", sim)["logits"]
        assert np.asarray(a).shape == (2, 1)
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)
    finally:
        ours.close()
        theirs.close()


def test_http_routes_and_errors(core):
    h = _Http(serve.make_http_server(core, port=0))
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{h.port}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        out = h.post("/encode_image", {"images": np.zeros(
            (1, 16, 16, 3), np.uint8).tolist()})
        assert np.asarray(out["embeddings"]).shape == (1, 32)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{h.port}/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["buckets"] == [2, 4] and stats["image"]["served"] >= 1
        with pytest.raises(urllib.error.HTTPError) as e:
            h.post("/nope", {})
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            h.post("/encode_text", {"bad": 1})
        assert e.value.code == 500
        assert len(h.post("/encode_text", {"texts": ["tumor ."]})
                   ["embeddings"]) == 1
    finally:
        h.close()


def test_bucket_selection():
    assert serve._bucket(1, (2, 4)) == 2
    assert serve._bucket(3, (2, 4)) == 4
    assert serve._bucket(9, (2, 4)) == 4  # clamped to the largest


def test_concurrent_requests_microbatch(core):
    """Concurrent callers coalesce into fewer device dispatches."""
    d0 = core.text_q.dispatches
    results = {}

    def call(i):
        results[i] = core.encode_text(["image of tumor ."])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 4
    for i in range(1, 4):
        np.testing.assert_allclose(results[0], results[i], atol=1e-6)
    assert core.text_q.dispatches - d0 < 4


def test_pipelined_results_route_to_right_callers(core):
    """Distinct concurrent requests get their own results back under the
    double-buffered launch/fetch split."""
    texts = [f"lung tumor {'.' * (i % 3 + 1)}" for i in range(6)]
    direct = {t: core.encode_text([t])[0] for t in set(texts)}
    results = {}

    def call(i):
        results[i] = core.encode_text([texts[i]])[0]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(6):
        np.testing.assert_allclose(results[i], direct[texts[i]], atol=1e-5,
                                   err_msg=f"request {i} got wrong result")


def test_oversize_requests_chunk_not_crash(core):
    """Requests larger than the biggest bucket are chunked, never padded
    negatively."""
    big = np.random.default_rng(5).integers(0, 255, (11, 16, 16, 3),
                                            dtype=np.uint8)
    out = core.encode_image(big)
    assert out.shape == (11, 32)
    one = np.concatenate([core.encode_image(big[i:i + 1]) for i in range(11)])
    np.testing.assert_allclose(out, one, atol=1e-5)


def test_warmup_runs_every_bucket(core):
    d0 = core.image_q.dispatches
    core.warmup()
    assert core.image_q.dispatches - d0 == len(core.buckets)


def test_queue_error_propagates_and_recovers(core):
    with pytest.raises(Exception):
        core.image_q.submit(np.zeros((1, 7, 7, 7, 7), np.uint8))  # bad rank
    assert core.encode_text(["still serving ."]).shape == (1, 32)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("keep_model")
    torch.save(random_keep_state_dict(CFG, torch.Generator().manual_seed(0)),
               d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps({
        "vision_config": VISION,
        "text_config": TEXT, "projection_dim": 32, "max_text_length": 16}))
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    return d


def test_build_server_loads_bf16_flash_model(model_dir):
    """The CLI's construction path: bf16, fused attention, warm buckets,
    a bound HTTP server (here on the CPU, where attention takes the
    kernel's plain version)."""
    core, httpd = serve.build_server(["--model-dir", str(model_dir),
                                      "--port", "0", "--device", "cpu"])
    try:
        assert core.model.dtype == torch.bfloat16 and core.model.use_flash
        assert core.max_length == 16 and core.image_size == 16
        assert core.image_q.dispatches == len(core.buckets)  # warmed up
        h = _Http(httpd)
        try:
            out = np.asarray(h.post("/encode_text", {"texts": [
                "lung tumor ."]})["embeddings"])
        finally:
            h.close()
        assert out.shape == (1, 32)
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0,
                                   atol=1e-3)
    finally:
        core.stop()


@pytest.fixture(scope="module")
def int8_model_dir(tmp_path_factory):
    """The tiny model with 32² images (16 patches): with 4 patches a token's
    int8 rounding noise averages over too few positions for the 0.999 gate,
    in the JAX package as in the port."""
    d = tmp_path_factory.mktemp("keep_int8_model")
    vision = dict(VISION, img_size=32)
    cfg = configs.KEEPConfig(vision=configs.ViTConfig(**vision),
                             text=configs.BertConfig(**TEXT),
                             projection_dim=32, max_text_length=16)
    torch.save(random_keep_state_dict(cfg, torch.Generator().manual_seed(0)),
               d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps({
        "vision_config": vision,
        "text_config": TEXT, "projection_dim": 32, "max_text_length": 16}))
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    return d


@pytest.mark.parametrize("policy", [[], ["--precision-policy", "all-int8"]])
def test_build_server_int8(int8_model_dir, policy, capsys):
    """--int8 serves the quantized model (both towers, on the int8 path) and
    its features agree with the bf16 server's (cosine ≥ 0.999, the repo's
    int8 gate); the co-located policy line is printed for 'auto'."""
    from keep_tpu_torch.quant import is_quantized

    d = str(int8_model_dir)
    core, httpd = serve.build_server(["--model-dir", d, "--port", "0",
                                      "--device", "cpu", "--int8", *policy])
    ref_core, ref_httpd = serve.build_server(
        ["--model-dir", d, "--port", "0", "--device", "cpu"])
    ref_httpd.server_close()
    try:
        assert is_quantized(core.model) and not is_quantized(ref_core.model)
        assert core.model.use_flash and core.model.gelu_approx
        assert core.model.dtype == torch.bfloat16
        assert all(b.int8_megakernel() for b in core.model.visual.blocks)
        assert all(b.int8_megakernel() for b in core.model.text.blocks)
        line = "precision policy: co-located — int8 at every bucket"
        assert (line in capsys.readouterr().out) == (not policy)
        h = _Http(httpd)
        try:
            texts = ["lung tumor .", "normal tissue image ."]
            txt = np.asarray(h.post("/encode_text", {"texts": texts})
                             ["embeddings"])
            imgs = np.random.default_rng(7).integers(0, 255, (3, 32, 32, 3),
                                                     dtype=np.uint8)
            img = np.asarray(h.post("/encode_image", {"images": imgs.tolist()})
                             ["embeddings"])
        finally:
            h.close()
        ref_txt = ref_core.encode_text(texts)
        ref_img = ref_core.encode_image(imgs)
        for got, ref in ((txt, ref_txt), (img, ref_img)):
            assert got.shape == ref.shape and np.isfinite(got).all()
            np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                       atol=1e-3)
            cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                         * np.linalg.norm(ref, axis=-1))
            assert cos.min() >= 0.999, cos
    finally:
        core.stop()
        ref_core.stop()


@pytest.mark.parametrize("flag", [["--mesh-dp", "2"]])
def test_build_server_refuses_unported_options(model_dir, flag, capsys):
    """``--mesh-dp`` is served (it was refused until data parallelism was
    ported): ``--mesh-dp 1`` serves the plain server's features bit for
    bit, with and without ``--int8`` (whose co-located policy line the
    mesh skips, as the JAX server does); a mesh larger than the devices
    present (two on the one CPU) raises."""
    with pytest.raises(ValueError, match="needs 2 present, found 1"):
        serve.build_server(["--model-dir", str(model_dir), "--device", "cpu",
                            *flag])
    imgs = np.random.default_rng(9).integers(0, 255, (3, 32, 32, 3),
                                             dtype=np.uint8)
    texts = ["lung tumor .", "normal tissue image ."]
    for extra in ([], ["--int8"]):
        argv = ["--model-dir", str(model_dir), "--port", "0", "--device",
                "cpu", *extra]
        ref, ref_httpd = serve.build_server(argv)
        capsys.readouterr()
        core, httpd = serve.build_server(argv + ["--mesh-dp", "1"])
        assert "precision policy" not in capsys.readouterr().out
        ref_httpd.server_close()
        httpd.server_close()
        try:
            assert core.mesh == (torch.device("cpu"),)
            assert core.stats()["mesh"] == 1
            np.testing.assert_array_equal(core.encode_image(imgs),
                                          ref.encode_image(imgs))
            np.testing.assert_array_equal(core.encode_text(texts),
                                          ref.encode_text(texts))
        finally:
            core.stop()
            ref.stop()


def test_mesh_sharded_server(core, jparams):
    """Twin of the JAX server's ``test_mesh_sharded_server``: ``mesh=``
    over 8 devices (the CPU eight times) splits each dispatch into 8
    chunks with the model replicated; buckets round up to multiples of 8;
    features equal the one-device server's within 1e-5, and the JAX mesh
    server's within 2e-5."""
    from keep_tpu.parallel import make_mesh as jmake_mesh

    from keep_tpu_torch.parallel import make_mesh

    mesh = make_mesh(8, devices=[torch.device("cpu")] * 8)
    sharded = serve.InferenceServer(core.model, core.tokenizer, max_length=16,
                                    image_size=16, buckets=(2, 4),
                                    max_delay_ms=5.0, mesh=mesh)
    jsharded = jserve.InferenceServer(
        jkeep.KEEPModel(params=jparams, cfg=JCFG), JTokenizer(vocab=_vocab()),
        max_length=16, image_size=16, buckets=(2, 4), max_delay_ms=5.0,
        mesh=jmake_mesh(8))
    try:
        assert sharded.buckets == jsharded.buckets == (8,)
        texts = ["an image of lung tumor .", "normal tissue ."]
        a = core.encode_text(texts)
        b = sharded.encode_text(texts)
        np.testing.assert_allclose(a, b, atol=1e-5)
        np.testing.assert_allclose(b, jsharded.encode_text(texts), atol=2e-5)
        imgs = np.random.default_rng(3).integers(
            0, 255, (3, 16, 16, 3)).astype(np.uint8)
        got = sharded.encode_image(imgs)
        np.testing.assert_allclose(core.encode_image(imgs), got, atol=1e-5)
        np.testing.assert_allclose(got, jsharded.encode_image(imgs),
                                   atol=2e-5)
        # the dispatch really split: one chunk per device, in order
        chunks = sharded._launch_image(np.zeros((8, 16, 16, 3), np.uint8))
        assert len(chunks) == 8 and all(c.shape == (1, 32) for c in chunks)
    finally:
        sharded.stop()
        jsharded.stop()
