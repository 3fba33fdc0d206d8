"""``run.py`` without a CUDA device fails at once and prints no result."""

import subprocess
import sys

import pytest

import smallcell


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "keep-bf16.extract", "--seed", "1", "--seconds", "1"],
        cwd=smallcell.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "no CUDA device" in p.stderr
