"""chip_smoke.py's int8_calibrated phase at several BERT outlier gains.

The phase injects ``chip_smoke.OUTLIERS`` outlier channels per LayerNorm
into the seeded random draw at full width: in the ViT an identity at
``OUTLIER_GAIN``, in the post-LN BERT another model at the gain given here.
For each gain this prints the phase's line (the calibrated and the plain
W8A8 features' cosine against bf16, the kernels against their plain
versions) or the gate it failed, so the gain the smoke run uses can be
read off the others. At the smoke run's own gain the line also holds a
control for the route gate: ``CONTROL_TILES`` tiles through the calibrated
model's plain blocks on the card and on the host, whose distance is what
rounding alone makes of the same int8 route. Needs one card:

    python scripts/torch_calibration_sweep.py [GAIN,GAIN,...]   # default 4,6,8,16
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

CONTROL_TILES = 8


def main() -> int:
    import torch

    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.kernels import _build
    from keep_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("torch_calibration_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gains = [float(g) for g in (sys.argv[1] if len(sys.argv) > 1
                                else "4,6,8,16").split(",")]
    print(chip_smoke.card(), flush=True)
    _build.library()
    failed = 0
    with tempfile.TemporaryDirectory() as d:
        chip_smoke.write_model(d, torch, KEEPConfig())
        for gain in gains:
            t0 = time.perf_counter()
            try:
                chip_smoke.drive_int8_calibrated(
                    torch, fa, d, text_gain=gain, route_control=(
                        CONTROL_TILES
                        if gain == chip_smoke.TEXT_OUTLIER_GAIN else 0))
            except AssertionError as e:
                failed += 1
                print(f"text_gain {gain}: gate failed: {e}", flush=True)
            print(f"text_gain {gain}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
    print(f"{len(gains) - failed} of {len(gains)} gains passed the gates")
    return 0


if __name__ == "__main__":
    sys.exit(main())
