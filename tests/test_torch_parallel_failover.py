"""The port's ``parallel/`` on Gloo CPU ranks: the peer-death drill and a
world of 1.

`test_multihost.test_worker_death_is_detected_not_hung` for the port: of two
ranks (kf 2 x pt 1) evaluating the sharded NID, rank 1 ``os._exit(42)``s
between two evaluations, and rank 0's next collective must raise (Gloo sees
the peer's connection close) well inside the group's 60 s timeout, not
hang. The world of 1: a process without torchrun's environment gets one
rank from ``init_distributed``, and every sharded path equals the serial one
bit for bit (the card's NCCL form is `chip_smoke.py`'s distributed phase)."""

import time

import numpy as np
import pytest

import torch_parallel_worker as worker
from synthetic import simple_camera
from test_parallel import batched_keyframes
from test_torch_parallel import XI_A, _camera_arrays, _kf_arrays


def _inputs(work):
    c = simple_camera()
    np.savez(work / "inputs.npz", **_camera_arrays("a_", c),
             **_kf_arrays("a_", batched_keyframes(c, k=2)), a_xi=np.asarray(XI_A))


def test_peer_death_is_detected_not_hung(tmp_path):
    _inputs(tmp_path)
    t0 = time.perf_counter()
    (survivor, dead), _ = worker.spawn("failover", 2, tmp_path, timeout=240)
    assert dead[0] == 42, f"rank 1 should die with 42:\n{dead[1]}"
    assert survivor[0] == 0, f"the survivor crashed uncleanly:\n{survivor[1]}"
    assert "FAILURE_DETECTED at iteration 2" in survivor[1], survivor[1]
    assert "NO_FAILURE_DETECTED" not in survivor[1]
    assert time.perf_counter() - t0 < 120


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_parallel_world1")
    _inputs(work)
    ((rc, out),), _ = worker.spawn("world1", 1, work, timeout=240)
    assert rc == 0 and "RANK_OK" in out, out
    return worker.load_ranks(work, 1)[0]


def test_init_distributed_without_environment_is_a_world_of_one(world1):
    assert list(world1["world1"]) == [1, 0, 0, 1, 1]
    assert world1["backend"]


@pytest.mark.parametrize("key", ("loss", "plain", "c2f", "wide", "pk"))
def test_world_of_one_bit_equal_serial(world1, key):
    assert world1[f"{key}_equal"], key
