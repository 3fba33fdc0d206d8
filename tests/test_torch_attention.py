"""The port's attention_qkv_slab (plain path on CPU tensors) against the JAX
package's Pallas kernel (interpret mode on the CPU), plus the wrapper's
checks and the build helper's behaviour that needs no GPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.kernels.flash_attention import attention_qkv_slab as jax_slab
from keep_tpu_torch.kernels import _build
from keep_tpu_torch.kernels import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(rng, b, s, h, dh, with_bias):
    qkv = rng.standard_normal((b, s, 3 * h * dh)).astype(np.float32)
    valid = np.ones((b, s), bool)
    kb = None
    if with_bias:
        for i in range(b):
            valid[i, int(rng.integers(1, s + 1)):] = False
        valid[0] = True
        kb = ((1.0 - valid) * -1e9).astype(np.float32)
    return qkv, kb, valid


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("s", [50, 197])
def test_slab_matches_jax_fp32(rng, s, with_bias):
    b, h, dh = 2, 2, 64
    qkv, kb, valid = _inputs(rng, b, s, h, dh, with_bias)
    ref = np.asarray(jax_slab(jnp.asarray(qkv),
                              None if kb is None else jnp.asarray(kb),
                              num_heads=h))
    got = fa.attention_qkv_slab(
        torch.from_numpy(qkv), None if kb is None else torch.from_numpy(kb),
        num_heads=h).numpy()
    assert got.shape == (b, s, h * dh)
    # padded query rows never reach a feature; compare the valid ones
    np.testing.assert_allclose(got[valid], ref[valid], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("s", [50, 197])
def test_slab_matches_jax_bf16(rng, s, with_bias):
    b, h, dh = 2, 2, 64
    qkv, kb, valid = _inputs(rng, b, s, h, dh, with_bias)
    ref = np.asarray(jax_slab(jnp.asarray(qkv).astype(jnp.bfloat16),
                              None if kb is None else jnp.asarray(kb),
                              num_heads=h)).astype(np.float32)
    got = fa.attention_qkv_slab(
        torch.from_numpy(qkv).bfloat16(),
        None if kb is None else torch.from_numpy(kb), num_heads=h)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.max(np.abs(got[valid] - ref[valid])) < 0.05


def test_bad_head_count_raises(rng):
    """Non-divisible lane dims raise in both packages (the TPU kernel's
    check) instead of silently truncating heads."""
    x = rng.standard_normal((2, 8, 96)).astype(np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        jax_slab(jnp.asarray(x), num_heads=5)
    with pytest.raises(ValueError, match="not divisible"):
        fa.attention_qkv_slab(torch.from_numpy(x), num_heads=5)


def test_wrapper_checks_before_dispatch():
    x = torch.zeros(2, 8, 3 * 64)
    with pytest.raises(ValueError, match="key_bias"):
        fa.attention_qkv_slab(x, torch.zeros(2, 7), num_heads=1)
    # the fp32-output form (the int8 blocks' attention) stays inference-only
    with pytest.raises(NotImplementedError, match="inference-only"):
        fa.attention_qkv_slab(x.bfloat16().requires_grad_(), num_heads=1,
                              out_dtype=torch.float32)
    # a device with no kernel raises: there is no fallback to the CPU path
    with pytest.raises(ValueError, match="no kernel"):
        fa.attention_qkv_slab(x.to("meta"), num_heads=1)
    # under no_grad a leaf that requires grad is fine (inference)
    with torch.no_grad():
        out = fa.attention_qkv_slab(x.clone().requires_grad_(), num_heads=1)
    assert out.shape == (2, 8, 64)


def test_cpu_path_counts_no_launch():
    before = fa.LAUNCHES
    fa.attention_qkv_slab(torch.zeros(1, 4, 3 * 64), num_heads=1)
    assert fa.LAUNCHES == before


def test_import_builds_nothing():
    """Importing the package (and running the CPU path) needs neither triton
    nor nvcc and compiles nothing."""
    code = (
        "import sys, torch\n"
        "import keep_tpu_torch, keep_tpu_torch.kernels\n"
        "from keep_tpu_torch.kernels import _build, flash_attention as fa\n"
        "fa.attention_qkv_slab(torch.zeros(1, 4, 192), num_heads=1)\n"
        "assert _build._lib is None and _build.BUILD_SECONDS is None\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_HOME="/nonexistent",
               PATH=os.path.dirname(sys.executable))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_library_path_tracks_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()  # deterministic
    src.write_text("// v2\n")
    assert _build.library_path() != first  # an edit forces a rebuild
    assert first.parent == _build.BUILD_DIR


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._compile(_build.library_path())
    # no half-written library is left behind
    assert list((tmp_path / "build").iterdir()) == []
