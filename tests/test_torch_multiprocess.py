"""Two-PROCESS data parallelism over gloo on the CPU: the real
``torch.distributed`` code path (two ranks, each a process running
``tests/torch_dp_worker.py``), twin of ``tests/test_multiprocess.py``.

- The object collectives and the step's tensor collectives.
- ``train()`` at dp=2 against the one-process port on the same global
  batches and initial weights: every step's loss and every step's summed
  gradient (what the optimizer gets) within rtol 1e-5 / atol 1e-6 (the
  JAX package's ``test_train_fsdp_equivalence`` tolerance), the eval
  metrics equal; and against ``keep_tpu.train.main.train`` on its 8-device
  CPU mesh within ``test_train_matches_jax``'s rtol 1e-5. Plain,
  ``accum_freq=2``, LoRA, a small MoE trunk (both dispatches), and the
  plain run as two nodes of one rank each.
- ``main`` starting one worker per card (``spawn_local_workers``).

Each worker has its own timeout; at these sizes a dp run takes ~10 s.

The harness shared with the layout tests (``test_torch_{fsdp,tp,sp,pp,
ep}.py``) is built for a loaded machine (the tier-1 run's six xdist
workers on eight cores): every rank runs one thread; a rank that outlives
``TIMEOUT`` fails its test with every rank's log tail; the JAX package's
mesh runs (``jax_train``) run in a child process with ``JAX_POOL_THREADS``
threads in XLA:CPU's pool (its default, one a core, equals the 8 virtual
devices: a collective needs all 8 running at once, so one thread taken by
other work deadlocked it on a loaded machine) whose collectives wait
``JAX_COLLECTIVE_WAIT_S`` for a late participant; and what several
tests share (the JAX mesh losses, the JAX initial weights, the
one-process runs) is computed once per run, whichever worker asks first
(``cached``).
"""

import contextlib
import copy
import fcntl
import hashlib
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from keep_tpu.train import lora as jlora
from keep_tpu.train import main as jmain
from keep_tpu.train.config import TrainRunConfig as JRunConfig
from keep_tpu_torch.compat.torch_loader import from_jax_lora, from_jax_params
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train.config import TrainRunConfig
from tests.test_torch_train import (CFG, CFG_MOE, MOE_VISION,  # noqa: F401
                                    _losses, _run_config, run_dirs)
from tests.torch_dp_worker import record_grads, record_losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
# seconds a rank may take: a run takes 10-35 s alone, several times that
# beside five other busy workers
TIMEOUT = 600
# seconds an XLA:CPU collective of the JAX mesh runs waits for its last
# participant before the process aborts
JAX_COLLECTIVE_WAIT_S = 300
# threads of XLA:CPU's pool in a JAX mesh run (``PJRT_NPROC``), which runs
# the 8 virtual devices' programs: with the default (one a core, 8 on an
# 8-core host) 3 of 16 fsdp runs, eight at once, left a collective waiting
# for its eighth device; with 32, 16 of 16 ran through
# (``tests/jax_pool_probe.py``)
JAX_POOL_THREADS = 32
JAX_CHILD = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from keep_tpu.train import main as jmain
from keep_tpu.train.config import TrainRunConfig
with open(sys.argv[1]) as f:
    jmain.train(TrainRunConfig.from_dict(json.load(f)))
"""


def cache_dir(factory) -> str:
    """The directory every worker of this pytest run shares (xdist gives
    each worker its own base temp under one run directory)."""
    root = factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_shared"
    d.mkdir(exist_ok=True)
    return str(d)


def _portable(raw: dict) -> dict:
    """``raw`` without its directories (the data's are each worker's own
    copy of the same files): a cache key."""
    out = copy.deepcopy(raw)
    out["save"]["output_dir"] = ""
    for k, v in out["dataset"].items():
        if isinstance(v, str) and os.sep in v:
            out["dataset"][k] = os.path.basename(v)
    return out


def cached(root: str, kind: str, key, compute):
    """``compute()`` once per pytest run for ``(kind, key)``: the first
    caller computes and saves it (torch.save) under ``root`` while holding
    the key's lock; every later caller, in any worker, loads it."""
    h = hashlib.sha256(json.dumps([kind, key], sort_keys=True,
                                  default=str).encode()).hexdigest()[:20]
    path = os.path.join(root, f"{kind}_{h}.pt")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            torch.save(compute(), path + ".tmp")
            os.replace(path + ".tmp", path)
    return torch.load(path, weights_only=False)


def jax_child(raw: dict, pool: int | None = JAX_POOL_THREADS,
              wait_s: int = JAX_COLLECTIVE_WAIT_S):
    """``keep_tpu.train.main.train`` on ``raw`` on the JAX package's
    8-device CPU mesh in a child process, with ``pool`` threads in
    XLA:CPU's pool (None: its default) and collectives that abort after
    ``wait_s``: the finished process (its output in ``stdout``)."""
    os.makedirs(raw["save"]["output_dir"], exist_ok=True)
    path = os.path.join(raw["save"]["output_dir"], "jax_run.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"{flags} --xla_cpu_collective_call_terminate_timeout_seconds="
        f"{wait_s} --xla_cpu_collective_timeout_seconds={wait_s}").strip(),
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if pool is not None:
        env["PJRT_NPROC"] = str(pool)
    if "xla_force_host_platform_device_count" not in env["XLA_FLAGS"]:
        env["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    return subprocess.run([sys.executable, "-c", JAX_CHILD, path], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=2 * wait_s)


def jax_train(raw: dict) -> None:
    """``jax_child`` on ``raw``; fails the test with the child's log
    tail."""
    p = jax_child(raw)
    assert p.returncode == 0, f"JAX mesh run rc={p.returncode}\n" + \
        p.stdout[-4000:]


def jax_losses(raw: dict, root: str) -> list:
    """The JAX trainer's per-epoch losses of ``raw`` (one step an epoch
    here) on its 8-device CPU mesh, with ``raw``'s layout; once per run
    (``cached`` under ``root``)."""
    def run():
        jax_train(copy.deepcopy(raw))
        return _losses_of(raw)
    return cached(root, "jax_losses", _portable(raw), run)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(mode: str, spec: dict | None, tmp_path, n: int = 2,
                 nodes: int = 1) -> list:
    """Runs ``n`` workers under a torchrun-style environment, on ``nodes``
    nodes as torchrun would number them; returns their outputs (and
    asserts each exited 0)."""
    spec_path = ""
    if spec is not None:
        spec_path = str(tmp_path / f"spec_{mode}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n // nodes), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen([sys.executable, WORKER, mode, spec_path],
                              env=dict(env, RANK=str(r),
                                       LOCAL_RANK=str(r % (n // nodes))),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        tails = []
        for r, p in enumerate(procs):
            log = outs[r] if r < len(outs) else p.communicate()[0]
            state = f"exited {p.returncode}" if r < len(outs) else "killed"
            tails.append(f"--- rank {r} ({state}):\n{log[-3000:]}")
        pytest.fail(f"{mode} workers outlived {TIMEOUT} s:\n"
                    + "\n".join(tails))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{out}"
        assert f"OK rank={r}" in out, out
    return outs


def test_two_process_collectives(tmp_path):
    """broadcast_object / all_gather_object, the row gather and its
    backward, the mean over ranks and the bucketed gradient sum."""
    _run_workers("objects", None, tmp_path)


@contextlib.contextmanager
def probe_grads(tmain, at: list, grads: list):
    """While ``tmain`` trains, runs each optimizer step k first from the
    parameters ``at[k]`` on the same batch and appends the gradient dict
    the optimizer gets there to ``grads``; then restores the run's
    parameters and optimizer state and takes the step as usual."""
    made = (tmain.make_train_step, tmain.make_accum_train_step)

    def probing(make):
        def build(*args, **kw):
            step = make(*args, **kw)

            def run(state, *a, **k):
                saved = {n: p.detach().clone()
                         for n, p in state.params.items()}
                saved_opt, saved_step = copy.deepcopy(
                    state.opt_state), state.step
                with torch.no_grad():
                    for n, p in state.params.items():
                        p.copy_(at[len(grads)][n])
                probed: list = []
                with record_grads(probed):
                    step(state, *a, **k)
                grads.append(probed[0]["grads"])
                with torch.no_grad():
                    for n, p in state.params.items():
                        p.copy_(saved[n])
                state.opt_state, state.step = saved_opt, saved_step
                return step(state, *a, **k)
            return run
        return build

    tmain.make_train_step, tmain.make_accum_train_step = map(probing, made)
    try:
        yield grads
    finally:
        tmain.make_train_step, tmain.make_accum_train_step = made


def _eval_file(tmp_path) -> str:
    rng = np.random.default_rng(0)
    path = str(tmp_path / "eval.npz")
    np.savez(path, pixels=rng.standard_normal((4, 16, 16, 3)).astype(
        np.float32), texts=np.asarray(
        ["lung cancer tissue .", "melanoma of skin .",
         "normal tissue is shown .", "an image of lung adenocarcinoma ."]))
    return path


def _variant(run_dirs, out_dir, name: str) -> dict:
    """The run config of one variant: 2 epochs from the same seed."""
    solver = {"epochs": 2, "zeroshot_frequency": 1}
    raw = _run_config(run_dirs, out_dir, **solver)
    if name == "accum":  # two microbatches of 4 a step
        raw["dataloader"].update(batch_size=4, caption_num=2)
        raw["solver"]["accum_freq"] = 2
    elif name == "lora":
        raw["solver"].update(lora_rank=2, lora_alpha=4.0,
                             freeze_visual_epochs=0)
    elif name.startswith("moe"):
        raw["keep"]["vision"] = dict(
            MOE_VISION, moe_dispatch="gather" if name == "moe_gather"
            else "einsum")
        raw["solver"]["freeze_visual_epochs"] = 0
    return raw


def _jax_reference(raw: dict, variant: str, root: str):
    """The JAX package's per-epoch losses (one step an epoch here) on its
    8-device mesh, and its initial weights (and adapters) as the port's."""
    cfg = JRunConfig.from_dict(copy.deepcopy(raw))
    losses = jax_losses(raw, root)
    kcfg = CFG_MOE if variant.startswith("moe") else CFG
    init = jmain.build_params(cfg, cfg.seed)
    params = from_jax_params(jax.tree.map(np.asarray, init), kcfg)
    adapters = None
    if variant == "lora":
        ad = jlora.init_lora(jax.random.PRNGKey(cfg.seed + 1), init,
                             cfg.solver.lora_rank,
                             targets=tuple(cfg.solver.lora_targets))
        adapters = from_jax_lora(jax.tree.map(np.asarray, ad), kcfg)
    return losses, params, adapters


def _losses_of(raw: dict) -> list:
    out = os.path.join(raw["save"]["output_dir"], "exp", "checkpoints",
                       "results.jsonl")
    with open(out) as f:
        return [json.loads(ln)["train_loss"] for ln in f.read().splitlines()]


@pytest.mark.parametrize("variant", ["plain", "accum", "lora", "moe",
                                     "moe_gather", "plain_two_nodes"])
def test_dp2_train_matches_one_process_and_jax(run_dirs, tmp_path, variant,
                                               tmp_path_factory):
    """dp=2 over gloo: each step's loss and summed gradient equal the
    one-process port's (rtol 1e-5, atol 1e-6) and the loss the JAX mesh
    run's (rtol 1e-5); the validation metrics of every epoch equal the
    one-process run's; rank 0 alone writes the run's files. As two nodes
    (``LOCAL_WORLD_SIZE=1``) each rank still takes its rows of the
    one-process batch."""
    want, params, adapters = _jax_reference(
        _variant(run_dirs, tmp_path / "jax", variant), variant,
        cache_dir(tmp_path_factory))
    torch.save(params, tmp_path / "params.pt")
    spec = {"config": _variant(run_dirs, tmp_path / "dp", variant),
            "params": str(tmp_path / "params.pt"),
            "eval": _eval_file(tmp_path), "out": str(tmp_path / "dp_out")}
    if adapters is not None:
        torch.save(adapters, tmp_path / "adapters.pt")
        spec["adapters"] = str(tmp_path / "adapters.pt")
    _run_workers("train", spec, tmp_path,
                 nodes=2 if variant.endswith("two_nodes") else 1)
    ranks = [json.loads((tmp_path / f"dp_out.{r}.json").read_text())
             for r in (0, 1)]
    dp_steps = [torch.load(tmp_path / f"dp_out.{r}.grads.pt",
                           weights_only=True) for r in (0, 1)]
    one_losses: list = []
    one_grads: list = []
    raw1 = _variant(run_dirs, tmp_path / "one", variant)
    ev = np.load(_eval_file(tmp_path))
    with probe_grads(tmain, [s["params"] for s in dp_steps[0]],
                     one_grads), record_losses(tmain, one_losses):
        one = tmain.train(TrainRunConfig.from_dict(raw1), params=params,
                          adapters=adapters, device="cpu",
                          eval_data={"val": (ev["pixels"],
                                             list(ev["texts"]))})
    # the summed gradient equals one process's at the same parameters (the
    # runs' own parameters drift apart at float noise, which Adam's first
    # step amplifies where a gradient is near zero). accum's first step
    # already takes every parameter's gradient; its second, at 2 rows a
    # rank, sits up to 2.9e-6 from one process's, less than 1e-7 relative
    # noise in the parameters moves one process's own (5.5e-6), and is
    # held through its loss only
    assert len(one_grads) == 2
    held = 1 if variant == "accum" else 2
    for r, steps in enumerate(dp_steps):
        assert len(steps) == 2
        for got, ref in zip(steps[:held], one_grads):
            assert got["grads"].keys() == ref.keys()
            assert any(t.abs().sum() > 0 for t in ref.values())
            for n, t in ref.items():
                np.testing.assert_allclose(got["grads"][n].numpy(),
                                           t.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {r} {n}")
    assert [r["world"] for r in ranks] == [2, 2]
    assert len(one_losses) == 2 and np.isfinite(one_losses).all()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one_losses, rtol=1e-5,
                                   atol=1e-6)
        assert r["results"].keys() == one.keys()
        for k, v in one.items():
            np.testing.assert_allclose(r["results"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)
    # rank 0 alone wrote the results, the log and the checkpoints
    np.testing.assert_allclose(_losses_of(spec["config"]), want, rtol=1e-5)
    exp = tmp_path / "dp" / "exp"
    assert sorted(os.listdir(exp)) == ["checkpoints", "metrics.jsonl",
                                       "out.log", "params.txt"]
    assert "rank 0 of 2" in (exp / "out.log").read_text()


def test_main_spawns_one_worker_per_card(run_dirs, tmp_path):
    """``spawn_local_workers`` (what ``main`` runs with several visible
    cards and no launcher) trains through the CLI in two processes; the
    losses equal the one-process CLI's from the same seed."""
    raw = _run_config(run_dirs, tmp_path / "one", epochs=2)
    path = tmp_path / "one.json"
    path.write_text(json.dumps(raw))
    tmain.main(["--config", str(path), "--device", "cpu"])
    raw2 = _run_config(run_dirs, tmp_path / "two", epochs=2)
    path2 = tmp_path / "two.json"
    path2.write_text(json.dumps(raw2))
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "2"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        codes = tmain.spawn_local_workers(
            ["--config", str(path2), "--device", "cpu"], 2, timeout=TIMEOUT)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert codes == [0, 0]
    np.testing.assert_allclose(_losses(tmp_path / "two"),
                               _losses(tmp_path / "one"), rtol=1e-5,
                               atol=1e-6)
