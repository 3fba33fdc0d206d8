"""The seeded inputs: the same seed gives the same tiles and weights, and
another seed other ones."""

import numpy as np
import torch

import smallcell
from benchmark import weights
from benchmark.drivers import extract


def test_pool_is_a_function_of_the_seed():
    _, cell = smallcell.small_cell("keep-bf16.extract")
    a = extract.make_pool(cell.traffic, 2**31 + 5, "cpu")
    b = extract.make_pool(cell.traffic, 2**31 + 5, "cpu")
    c = extract.make_pool(cell.traffic, 6, "cpu")
    assert a.shape == (8, 256, 256, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_weights_are_a_function_of_the_seed():
    _, cell = smallcell.small_cell("keep-int8.extract")
    m = cell.config["model"]
    a, b = (weights.make_state_dict(m, 9, "cpu") for _ in range(2))
    c = weights.make_state_dict(m, 10, "cpu")
    assert a.keys() == b.keys() == weights.released_shapes(m).keys() | {
        "logit_scale"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.blocks.0.attn.qkv.weight"],
                           c["visual.blocks.0.attn.qkv.weight"])
    g = a["visual.blocks.1.ls2.gamma"]
    assert 0.1 <= float(g.min()) and float(g.max()) <= 0.5
