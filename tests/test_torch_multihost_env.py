"""Env discovery and the object collectives of
``keep_tpu_torch.parallel.multihost``: twins of ``tests/test_multihost_env.py``
with ``torch.distributed.init_process_group`` faked (no rendezvous), every
branch of the reference's discovery order (distributed.py:24-60). The real
two-process collectives run in ``tests/test_torch_multiprocess.py``."""

import pytest
import torch
import torch.distributed as dist

from keep_tpu_torch.parallel import multihost

LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS",
                 "SLURM_LOCALID", "SLURM_LAUNCH_NODE_IPADDR",
                 "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
                 "OMPI_COMM_WORLD_LOCAL_RANK", "TPU_WORKER_HOSTNAMES",
                 "MEGASCALE_COORDINATOR_ADDRESS")


@pytest.fixture(autouse=True)
def _scrub(monkeypatch):
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)


class FakeInit:
    def __init__(self):
        self.calls = []

    def __call__(self, backend, **kw):
        self.calls.append((backend, kw))


@pytest.fixture
def fake(monkeypatch):
    f = FakeInit()
    monkeypatch.setattr(dist, "init_process_group", f)
    return f


def test_no_env_is_single_process(fake):
    assert multihost.discover() is None
    assert multihost.init_from_env("cpu") is False
    assert fake.calls == []


def test_torchrun_env(monkeypatch, fake):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert multihost.init_from_env("cpu") is True
    assert fake.calls == [("gloo", {"init_method": "tcp://10.0.0.1:1234",
                                    "world_size": 4, "rank": 3})]
    # an existing group: a second call joins nothing new
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert multihost.init_from_env("cpu") is True
    assert len(fake.calls) == 1


def test_torchrun_default_port_and_slurm_rank(monkeypatch, fake):
    monkeypatch.setenv("MASTER_ADDR", "h0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("SLURM_PROCID", "1")  # RANK absent: SLURM's stands in
    assert multihost.init_from_env("cpu") is True
    assert fake.calls == [("gloo", {"init_method": "tcp://h0:7709",
                                    "world_size": 2, "rank": 1})]


def test_master_addr_without_rank_fails_fast(monkeypatch, fake):
    monkeypatch.setenv("MASTER_ADDR", "h0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no RANK"):
        multihost.init_from_env("cpu")
    assert fake.calls == []


def test_torchrun_world_one_runs_a_group(monkeypatch, fake):
    """torchrun --nproc-per-node 1 hands a rendezvous too: a world-1 group
    (the JAX package returns False there), rank 0 without RANK."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.init_from_env("cpu") is True
    assert fake.calls[0][1]["world_size"] == 1
    assert fake.calls[0][1]["rank"] == 0


@pytest.mark.parametrize("env,want", [
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2",
      "SLURM_LAUNCH_NODE_IPADDR": "10.1.1.1"}, ("tcp://10.1.1.1:7709", 4, 2)),
    ({"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
      "MASTER_ADDR": "m", "MASTER_PORT": "99"}, ("tcp://m:99", 8, 5)),
])
def test_cluster_env(monkeypatch, fake, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.init_from_env("cpu") is True
    backend, kw = fake.calls[0]
    assert backend == "gloo"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == want


@pytest.mark.parametrize("var,val", [
    ("SLURM_NTASKS", "1"), ("OMPI_COMM_WORLD_SIZE", "1"),
    ("TPU_WORKER_HOSTNAMES", "w0,w1"),
    ("MEGASCALE_COORDINATOR_ADDRESS", "c:1"),
])
def test_single_task_and_tpu_markers_are_single_process(monkeypatch, fake,
                                                        var, val):
    """One SLURM / MPI task is a single process; the TPU pod markers name
    TPU hosts and are not read."""
    monkeypatch.setenv(var, val)
    assert multihost.init_from_env("cpu") is False
    assert fake.calls == []


def test_backend_follows_the_device(monkeypatch, fake):
    monkeypatch.setenv("MASTER_ADDR", "h0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    assert multihost.init_from_env("cuda") is True
    assert fake.calls[0][0] == "nccl" and picked == [1]
    # an explicit card and backend (two ranks on one card over gloo)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert multihost.init_from_env("cuda:0", backend="gloo") is True
    assert fake.calls[1][0] == "gloo" and picked == [1]


def test_helpers_single_process():
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    assert multihost.is_master() is True
    assert multihost.broadcast_object({"a": 1}) == {"a": 1}
    assert multihost.all_gather_object(5) == [5]
    assert multihost.local_device("cpu") == torch.device("cpu")


def test_broadcast_object_multiprocess_framing(monkeypatch):
    """The >1-process leg in one process: the object list broadcast faked
    to put process 0's value in the box."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    seen = []

    def fake_broadcast(box, src):
        seen.append(src)
        box[0] = {"path": "/ckpt/epoch_3.pt", "epoch": 3}

    monkeypatch.setattr(dist, "broadcast_object_list", fake_broadcast)
    assert multihost.broadcast_object(None) == {"path": "/ckpt/epoch_3.pt",
                                                "epoch": 3}
    assert seen == [0]


def test_all_gather_object_multiprocess_framing(monkeypatch):
    """The gathered list has one slot per process, in rank order, objects
    of different pickled lengths included."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)

    def fake_gather(out, obj):
        out[0] = obj
        out[1] = {"rank": 1, "extra": "x" * 50}

    monkeypatch.setattr(dist, "all_gather_object", fake_gather)
    assert multihost.all_gather_object({"rank": 0}) == [
        {"rank": 0}, {"rank": 1, "extra": "x" * 50}]
