"""The plain reference against the program at a small size, on the CPU: the
same seeded weights and tiles through both. Only this test imports the two
side by side; the reference itself imports nothing of the program."""

import numpy as np
import torch

import smallcell
from benchmark import program, weights
from benchmark.drivers import extract
from benchmark.reference import keep_ref


def test_preprocess_matches_the_program():
    from keep_tpu_torch.configs import PreprocessConfig
    from keep_tpu_torch.ops.preprocess import preprocess

    tiles = torch.randint(0, 256, (3, 256, 256, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    cfg = PreprocessConfig()
    got = preprocess(tiles, cfg)
    want = keep_ref.preprocess(tiles, 224, cfg.mean, cfg.std)
    # PIL's passes round: a value at a half may round the other way
    assert (got - want).abs().max() <= 1.0 / 255 / 0.224 + 1e-6
    assert (got - want).abs().mean() < 1e-4


def test_fp32_tower_matches_the_program():
    from keep_tpu_torch.compat.torch_loader import load_keep_state_dict
    from keep_tpu_torch.models.keep import KEEPModel

    _, cell = smallcell.small_cell("keep-bf16.extract")
    sd = weights.make_state_dict(cell.config["model"], 3, "cpu")
    cfg = program.keep_config(cell.config)
    model = KEEPModel(cfg, dtype=torch.float32, gelu_approx=True)
    model.load_state_dict(load_keep_state_dict(sd, cfg))
    px = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    tower = keep_ref.ImageTower(sd, cell.config["model"], block_gelu="tanh",
                                head_gelu="erf")
    with torch.no_grad():
        got = model.encode_image(px)
    torch.testing.assert_close(got, tower(px), atol=2e-5, rtol=1e-4)


def test_w8a8_codes_and_features_follow_the_program():
    _, cell = smallcell.small_cell("keep-int8.extract", seed=5)
    sd = weights.make_state_dict(cell.config["model"], cell.seed, "cpu")
    model = program.build_keep(cell.config, sd, "cpu")
    tower = keep_ref.ImageTower(sd, cell.config["model"], block_gelu="tanh",
                                head_gelu="erf", quant_bits=8)
    # the codes worked out again from the fp32 weights, LayerScale folded
    assert torch.equal(model.visual.blocks[0].attn.qkv.weight_q.double(),
                       tower.blocks[0]["qkv"].w)
    assert torch.equal(model.visual.blocks[1].mlp.fc2.weight_q.double(),
                       tower.blocks[1]["fc2"].w)
    pool = extract.make_pool(cell.traffic, cell.seed, "cpu")
    ref = extract.reference_features(cell, pool, 8)
    from keep_tpu_torch.wsi.extract import extract_features

    feats = extract_features(model, pool, batch_size=4, resize=True)
    assert extract.widest_gap(feats, ref) < 1e-2
    assert np.isfinite(feats).all()
