"""The divide form of #1's bf16 softmax on the card (ROADMAP queue 3's
fault): p = exp(s − m) / l, the JAX body's form, in place of the kernel's
exp(s − m)·(1 / l), against the kernel as it is, in one call.

    PYTHONPATH=. python scripts/torch_attention_divide.py [out.json]

It builds the kernel library from ``keep_tpu_torch/kernels/csrc`` as it
is, and a second one from a copy of those sources in which both bf16
bodies of ``attention_qkv_slab.cu`` divide, then for each:

- ``bert_flash_bf16``: ``chip_smoke.check_bert_flash_bf16`` (BERT-base
  width, 2 layers, bf16, #1 against the plain route on the card: 1 − the
  least cosine of the pooler rows and of the unpadded hidden rows);
- the kernel against ``tests/card_attention_model.py`` (the body's order of
  sums, in the matching form, computed on the card with TF32 off) and
  against the plain version on one BERT-base slab (B 8, S 128, H 12,
  ragged key bias): max |Δ| over the unpadded rows and the share of
  output values that differ;
- forward ms at ViT-L (S 197, H 16, bf16) B = 32 and 128, CUDA events,
  in turns (kernel, divide, divide, kernel).

Prints one JSON object (also written to ``out.json`` when given), with the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# the multiply, as both bf16 bodies take it, and its divide form
MULTIPLY = ("inv[i] = 1.f / quad_sum(l[i]);",
            "__fmul_rn(expf(__fsub_rn(s[n][e], m[e >> 1])), inv[e >> 1])")
DIVIDE = ("inv[i] = quad_sum(l[i]);",
          "__fdiv_rn(expf(__fsub_rn(s[n][e], m[e >> 1])), inv[e >> 1])")


def divide_sources(dst: Path) -> None:
    """A copy of csrc in ``dst`` whose bf16 bodies divide."""
    from keep_tpu_torch.kernels import _build

    shutil.copytree(_build.CSRC, dst)
    cu = dst / "attention_qkv_slab.cu"
    text = cu.read_text()
    for a, b in zip(MULTIPLY, DIVIDE):
        if text.count(a) != 2:
            raise RuntimeError(f"expected {a!r} in both bf16 bodies")
        text = text.replace(a, b)
    cu.write_text(text)


def load(csrc: Path, build: Path):
    """The kernel library built from ``csrc`` into ``build``."""
    from keep_tpu_torch.kernels import _build

    _build._lib = None
    _build.CSRC, _build.BUILD_DIR = csrc, build
    return _build.library()


def slab_check(torch, fa, divide: bool) -> dict:
    from card_attention_model import card_body_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h = 8, 128, 12
    qkv = torch.randn(b, s, 3 * h * 64, generator=g, device="cuda").bfloat16()
    lens = torch.randint(s // 4, s + 1, (b,), generator=g, device="cuda")
    valid = torch.arange(s, device="cuda")[None] < lens[:, None]
    kb = (~valid).float() * -1e9
    got = fa.attention_qkv_slab(qkv, kb, num_heads=h).float()
    model = card_body_attention(qkv, kb, num_heads=h, divide=divide).float()
    plain = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h).float()
    out = {}
    for name, ref in (("model", model), ("plain", plain)):
        d = (got - ref)[valid]
        out[f"vs_{name}_max_abs"] = d.abs().max().item()
        out[f"vs_{name}_differ_share"] = (d != 0).float().mean().item()
    return out


def main(argv: list[str]) -> int:
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import torch

    import chip_smoke as cs
    from keep_tpu_torch.kernels import _build
    from keep_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    csrc, build = _build.CSRC, _build.BUILD_DIR
    result = {"card": cs.card(), "forms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        divide_sources(Path(tmp, "csrc"))
        libs = {"multiply": load(csrc, build),
                "divide": load(Path(tmp, "csrc"), Path(tmp, "build"))}
        for form, lib in libs.items():
            _build._lib = lib
            result["forms"][form] = {
                "bert_flash_bf16": cs.check_bert_flash_bf16(torch),
                "slab": slab_check(torch, fa, form == "divide")}
        g = torch.Generator(device="cuda").manual_seed(1)
        for b in (32, 128):
            qkv = torch.randn(b, 197, 3 * 1024, generator=g,
                              device="cuda").bfloat16()
            times = {"multiply": [], "divide": []}
            for form in ("multiply", "divide", "divide", "multiply"):
                _build._lib = libs[form]
                times[form].append(cs.cuda_ms(
                    lambda: fa.attention_qkv_slab(qkv, num_heads=16)))
            for form, t in times.items():
                result["forms"][form][f"vit_l16_B{b}_ms"] = t
    _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, build, None
    line = json.dumps(result)
    print(line)
    if len(argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(argv[1])), exist_ok=True)
        Path(argv[1]).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
