"""ROADMAP queue 3's EVA02-E-14-plus check on the CPU: how far bf16 sits
from fp32 at the preset's full depth, in the JAX package and in the port.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_eva_depth_check.py \
        [--width 224] [--heads 2] [--mlp 1920] [--batch 4] [--depth 64]

Builds ``EVA02-E-14-plus`` (64 post-norm blocks, fused qkv, GELU, no rope,
224² at patch 14: S = 257) at a narrow width that keeps its head dim (112)
and its MLP ratio (15360 / 1792), draws the JAX ``init``'s weights from
seed 0, carries them into the port (``compat.torch_loader.from_jax_tree``)
and runs the same seeded images through both packages in turns: JAX fp32,
JAX bf16, port fp32, port bf16. Prints one JSON object with the least
per-row cosine of each package's bf16 against its own fp32, of the two
fp32 outputs and of the two bf16 outputs, and each forward's seconds.
Imports both packages: it runs on the CPU only, never on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def cos_min(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                           * np.linalg.norm(b, axis=-1))
    return float(c.min())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=224)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--mlp", type=int, default=1920)
    ap.add_argument("--out-dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--depth", type=int, default=64)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from keep_tpu.models import eva as jeva
    from keep_tpu_torch.compat import torch_loader as loader
    from keep_tpu_torch.models import eva

    shape = dataclasses.asdict(jeva.EVA02_CONFIGS["EVA02-E-14-plus"])
    shape.update(embed_dim=args.width, num_heads=args.heads,
                 mlp_hidden=args.mlp, out_dim=args.out_dim, depth=args.depth)
    jcfg, cfg = jeva.EvaConfig(**shape), eva.EvaConfig(**shape)
    params = jax.tree.map(np.asarray, jeva.init(jax.random.PRNGKey(0), jcfg))
    model = eva.Eva(cfg)
    model.load_state_dict(loader.from_jax_tree(params, lambda p: cfg.depth),
                          strict=True)
    model.eval()
    x = np.random.default_rng(0).standard_normal(
        (args.batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)

    out, seconds = {}, {}
    for tag, dt in (("jax_fp32", jnp.float32), ("jax_bf16", jnp.bfloat16)):
        fwd = jax.jit(lambda p, v, dt=dt: jeva.forward(p, v, jcfg, dtype=dt))
        t0 = time.perf_counter()
        out[tag] = np.asarray(fwd(params, jnp.asarray(x)).astype(jnp.float32))
        seconds[tag] = time.perf_counter() - t0
    for tag, dt in (("port_fp32", torch.float32), ("port_bf16",
                                                   torch.bfloat16)):
        t0 = time.perf_counter()
        with torch.no_grad():
            out[tag] = model(torch.from_numpy(x), dtype=dt).float().numpy()
        seconds[tag] = time.perf_counter() - t0
    for tag, v in out.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{tag}: non-finite output")
    print(json.dumps({
        "config": shape, "batch": args.batch,
        "jax_bf16_vs_jax_fp32": cos_min(out["jax_bf16"], out["jax_fp32"]),
        "port_bf16_vs_port_fp32": cos_min(out["port_bf16"],
                                          out["port_fp32"]),
        "port_fp32_vs_jax_fp32": cos_min(out["port_fp32"], out["jax_fp32"]),
        "port_bf16_vs_jax_bf16": cos_min(out["port_bf16"], out["jax_bf16"]),
        "seconds": seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
