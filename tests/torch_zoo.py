"""Helpers of the zoo towers' CPU parity tests (``tests/test_torch_*.py``):
JAX parameter trees with their unit norms and zero biases moved, so that
every leaf shows in the features, and the least cosine between rows."""

import jax
import numpy as np
import torch


def moved(params, seed: int = 3):
    """``params`` as numpy, every LayerNorm / RMSNorm / BatchNorm leaf and
    bias moved by 0.1·N(0, 1) (a BatchNorm's variance by |·| of that, so it
    stays positive), the zero-initialised LayerScale ``gamma`` too."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, params)

    def walk(node):
        items = (enumerate(node) if isinstance(node, list)
                 else list(node.items()))
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v)
            elif k in ("scale", "bias", "b", "fc1_b", "mean", "gamma"):
                node[k] = v + 0.1 * rng.standard_normal(v.shape).astype(
                    v.dtype)
            elif k == "var":
                node[k] = v + np.abs(0.1 * rng.standard_normal(v.shape)
                                     ).astype(v.dtype)

    walk(params)
    return params


def cos_min(a, b) -> float:
    """The least cosine between matching rows of a and b (numpy or torch)."""
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float64).reshape(len(a), -1)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b,
                   np.float64).reshape(len(b), -1)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def as_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))
