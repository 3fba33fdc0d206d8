"""How often the JAX package's fsdp run on its 8-device CPU mesh (the
reference of ``tests/test_torch_fsdp.py::test_fsdp_follows_one_process``)
leaves an XLA:CPU collective waiting for a device, by the size of
XLA:CPU's thread pool, with K runs at a time loading the host:

    python tests/jax_pool_probe.py OUT_DIR POOL K N [WAIT_S]

POOL: the pool's threads (``PJRT_NPROC``; ``-``: XLA:CPU's default, one a
core); each run's collectives abort after WAIT_S seconds (default 60).
Prints, for each of the N runs: its index, exit code (None: killed at
twice WAIT_S), seconds, and whether a collective timed out.
"""

import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tests.test_torch_multiprocess import jax_child  # noqa: E402
from tests.test_torch_train import (_run_config,  # noqa: E402
                                    write_run_data)


def main() -> None:
    out, pool, k, n = (pathlib.Path(sys.argv[1]), sys.argv[2],
                       int(sys.argv[3]), int(sys.argv[4]))
    wait_s = int(sys.argv[5]) if len(sys.argv) > 5 else 60
    data = out / "data"
    data.mkdir(parents=True)
    write_run_data(data)

    def one(i):
        raw = _run_config(data, out / f"run{i}", epochs=2,
                          freeze_visual_epochs=0, fsdp=True,
                          fsdp_min_size=256)
        t0 = time.time()
        try:
            p = jax_child(raw, None if pool == "-" else int(pool), wait_s)
        except subprocess.TimeoutExpired:  # killed before XLA aborted
            return i, None, round(time.time() - t0, 1), True
        return (i, p.returncode, round(time.time() - t0, 1),
                "Termination timeout" in p.stdout)

    with ThreadPoolExecutor(k) as ex:
        for r in ex.map(one, range(n)):
            print(r, flush=True)


if __name__ == "__main__":
    main()
