"""The serving cell at a small size on the CPU: its traffic, its tokenizer
beside the program's, and its check."""

import numpy as np
import pytest

import smallcell
from benchmark.drivers import serve
from benchmark.reference.wordpiece import WordPiece


def small_serve(seed=7, seconds=1.0):
    _, cell = smallcell.small_cell("keep-int8.serve", seed=seed,
                                   seconds=seconds)
    cell.traffic.update(rate_per_s=20.0, tile_pool=16, image_tiles=[1, 8],
                        checked_requests=8, drain_seconds=30)
    cell.config["model"]["vision"]["img_size"] = 64
    return cell


def test_every_seed_gets_the_same_work_in_its_own_order():
    t = smallcell.small_cell("keep-int8.serve")[1].traffic
    a, b = (serve.make_schedule(t, 30.0, s) for s in (2**31 + 1, 5))
    again = serve.make_schedule(t, 30.0, 5)
    assert b == again
    assert a != b
    key = lambda s: sorted((r["kind"], r["size"]) for r in s)  # noqa: E731
    assert key(a) == key(b)
    assert a[-1]["due"] == pytest.approx(30.0, rel=0.1)
    assert b[-1]["due"] == pytest.approx(30.0, rel=0.1)
    sizes = [r["size"] for r in a if r["kind"] == "image"]
    assert min(sizes) >= 1 and max(sizes) <= 64


def test_reference_tokenizer_matches_the_program(tmp_path):
    from keep_tpu_torch.factory import get_tokenizer

    vocab = str(tmp_path / "vocab.txt")
    words = serve.write_vocab(vocab, 30522)
    t = smallcell.small_cell("keep-int8.serve")[1].traffic
    sched = serve.make_schedule(dict(t, image_share=0.0), 2.0, 3)
    serve.make_payloads(sched, t, words, 3, np.zeros((1, 1, 1, 3), np.uint8))
    prompts = [p for r in sched for p in r["prompts"]] + [
        "Tumour, nuclei. " + words[7] + words[9]]
    prog = get_tokenizer("bert", vocab)(prompts, max_length=256)
    ref = WordPiece(vocab)
    for i, p in enumerate(prompts):
        ids, mask = ref.encode(p, 256)
        assert list(prog["input_ids"][i]) == ids
        assert list(prog["attention_mask"][i]) == mask


def test_sound_serving_is_correct():
    assert smallcell.run(small_serve()).correct


def test_altered_answer_is_not_correct(monkeypatch):
    from keep_tpu_torch.serve import InferenceServer

    real = InferenceServer.encode_text

    def altered(self, texts):
        out = real(self, texts)
        return out[::-1].copy() if len(out) > 1 else -out

    monkeypatch.setattr(InferenceServer, "encode_text", altered)
    out = smallcell.run(small_serve(seed=9))
    assert not out.correct, out.checks
