"""The port's process groups (gpu/dist.py): the counterpart of
tests/test_dist.py, and a spawned 2-rank gloo group on the CPU whose
sharded launch and sharded SCC solve equal the in-process 2-shard mesh.

Where the JAX package logs a failed initialization and goes on
single-host, the port raises: the tests pin the difference."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import dist, ensemble, scc, spmd, synth, wgl
from jepsen_tpu_torch.gpu.encode import encode

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
        "JEPSEN_TPU_MULTIHOST", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
        "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for v in VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(dist, "_initialized", False)
    return monkeypatch


def test_no_env_is_single_host_noop(clean_env):
    assert dist.multihost_requested() is False
    assert dist.ensure_initialized() is False
    assert dist.world_size() == 1 and dist.rank() == 0


@pytest.mark.parametrize("env,missing", [
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1"}, "JAX_NUM_PROCESSES"),
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2"},
     "JAX_PROCESS_ID"),
    ({"JEPSEN_TPU_MULTIHOST": "1"}, "MASTER_ADDR"),
    ({"JEPSEN_TPU_MULTIHOST": "1", "MASTER_ADDR": "127.0.0.1"},
     "MASTER_PORT"),
    ({"JEPSEN_TPU_MULTIHOST": "1", "MASTER_ADDR": "127.0.0.1",
      "MASTER_PORT": "1"}, "WORLD_SIZE"),
    ({"JEPSEN_TPU_MULTIHOST": "1", "MASTER_ADDR": "127.0.0.1",
      "MASTER_PORT": "1", "WORLD_SIZE": "2"}, "RANK"),
])
def test_each_missing_variable_raises_naming_it(clean_env, env, missing):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError, match=missing):
        dist.ensure_initialized()
    assert not torch.distributed.is_initialized()


def test_bad_values_raise(clean_env):
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    clean_env.setenv("JAX_NUM_PROCESSES", "two")
    with pytest.raises(ValueError, match="not an integer"):
        dist.ensure_initialized()
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="outside a world of 2"):
        dist.ensure_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_unreachable_coordinator_raises_where_jax_degrades(clean_env):
    """Rank 1 of 2 with nobody listening at the coordinator: the port
    raises within its timeout. The JAX package, handed the same failure
    by jax.distributed.initialize, logs it and goes on single-host."""
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("JAX_PROCESS_ID", "1")
    clean_env.setattr(dist, "DEFAULT_TIMEOUT_S", 2.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        dist.ensure_initialized()
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()
    assert dist.process_info()["process_count"] == 1

    import jax

    from jepsen_tpu.tpu import dist as jdist

    def unreachable(**_kw):
        raise RuntimeError("coordinator unreachable")

    clean_env.setattr(jax.distributed, "initialize", unreachable)
    clean_env.setattr(jdist, "_initialized", False)
    assert jdist.ensure_initialized() is False  # degrades, never raises


def test_process_info_shape(clean_env):
    info = dist.process_info()
    assert set(info) == {"process_index", "process_count", "local_devices",
                         "global_devices", "backend"}
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["global_devices"] >= info["local_devices"] >= 0
    assert info["backend"] is None


def test_ranks_sharing_a_card_list_it_once():
    """Two ranks on one card under gloo give the group one card, so the
    automatic route keeps the one-device launch; cards of two hosts stay
    apart."""
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert dist.distinct_cards([(0, 7, 0), (1, 7, 0)]) == [(0, cuda[0])]
    assert dist.distinct_cards([(0, 7, 0), (1, 7, 1), (2, 7, 0),
                                (3, 7, 1)]) == [(0, cuda[0]), (1, cuda[1])]
    assert dist.distinct_cards([(0, 7, 0), (1, 9, 0)]) == \
        [(0, cuda[0]), (1, cuda[0])]
    assert dist.distinct_cards([]) == []


@pytest.mark.parametrize("cards,world,rank,env,want", [
    (0, 2, 1, {}, ("gloo", None)),
    (4, 4, 2, {}, ("nccl", "cuda:2")),
    (1, 2, 1, {}, ("gloo", "cuda:0")),               # ranks share a card
    (2, 8, 5, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"},
     ("nccl", "cuda:1")),                            # 4 hosts of 2 cards
    (2, 4, 3, {"LOCAL_WORLD_SIZE": "4"}, ("gloo", "cuda:1")),
])
def test_backend_follows_the_layout(clean_env, cards, world, rank, env,
                                    want):
    clean_env.setattr(torch.cuda, "is_available", lambda: cards > 0)
    clean_env.setattr(torch.cuda, "device_count", lambda: cards)
    for k, v in env.items():
        clean_env.setenv(k, v)
    backend, card = dist.layout(world, rank)
    assert (backend, None if card is None else str(card)) == want


# ---------------------------------------------------------------------------
# a spawned 2-rank gloo group on the CPU
# ---------------------------------------------------------------------------

def _inputs():
    m = pmodels.cas_register()
    encs = [encode(m, synth.register_history(24 + 4 * i, n_procs=3,
                                             seed=500 + i))
            for i in range(9)]
    bad = synth.corrupt_register_history(
        synth.register_history(30, n_procs=3, seed=600), at_frac=0.5)[0]
    encs.append(encode(m, bad))
    rows = [(i, s) for i, e in enumerate(encs)
            for s in range(min(e.n_states, 2))]
    rng = np.random.default_rng(5)
    n, e = 2500, 30_000
    src = np.concatenate([rng.integers(0, n, e), np.arange(40)])
    dst = np.concatenate([rng.integers(0, n, e), np.roll(np.arange(40), -1)])
    emask = np.random.default_rng(2).random(len(src)) < 0.7
    return encs, rows, (n, src, dst, emask)


def _solve(mesh) -> dict:
    """Everything the group and the in-process mesh must agree on."""
    encs, rows, (n, src, dst, emask) = _inputs()
    out = wgl._drain(ensemble.sharded_launch(
        wgl.PackedBatch(encs), rows, 16, 16, reach=True, mesh=mesh),
        reach=True)
    res = ensemble.check_batch_sharded(encs, mesh=mesh, W=16, F=16)
    graph = scc.Edges(n, src, dst, mesh=mesh)
    return {"mask": out[0].tolist(), "unknown": out[1].tolist(),
            "result": res.tolist(),
            "scc": graph.solve_sharded().tolist(),
            "scc_masked": graph.solve_sharded(emask).tolist()}


WORKER = r"""
import json, sys, datetime
import torch, torch.distributed as tdist
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
rank = int(sys.argv[1])
tdist.init_process_group("gloo", init_method="file://" + {rdv!r},
                         world_size=2, rank=rank,
                         timeout=datetime.timedelta(seconds=60))
from jepsen_tpu_torch.gpu import dist, spmd
import test_torch_dist as t
assert dist.ensure_initialized()
mesh = spmd.mesh_of(["cpu", "cpu"])
assert mesh.ranks == (0, 1) and mesh.local() == [rank]
got = t._solve(mesh)
got["info"] = dist.process_info()
got["info"]["spmd_devices"] = spmd.spmd_devices()
with open({out!r} + str(rank), "w") as f:
    json.dump(got, f)
tdist.destroy_process_group()
"""


def test_two_rank_gloo_group_equals_in_process_mesh(tmp_path):
    script = WORKER.format(root=str(ROOT), tests=str(ROOT / "tests"),
                           rdv=str(tmp_path / "rdv"),
                           out=str(tmp_path / "out"))
    env = {k: v for k, v in os.environ.items() if k not in VARS}
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    want = _solve(spmd.mesh_of(["cpu", "cpu"]))
    assert want["result"][-1] == wgl.INVALID
    for r in range(2):
        got = json.loads((tmp_path / f"out{r}").read_text())
        info = got.pop("info")
        assert info["process_index"] == r and info["process_count"] == 2
        assert info["backend"] == "gloo" and info["global_devices"] == 0
        assert info["spmd_devices"] == 0
        assert got == want


# ---------------------------------------------------------------------------
# NCCL across cards: only where there are two
# ---------------------------------------------------------------------------

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL across cards)")


def test_nccl_group_equals_in_process_mesh(tmp_path, two_cards):
    script = WORKER.replace('"gloo"', '"nccl"').replace(
        'spmd.mesh_of(["cpu", "cpu"])', 'spmd.mesh_of(["cuda:0", "cuda:1"])'
    ).replace("import test_torch_dist as t",
              "import test_torch_dist as t\n"
              "torch.cuda.set_device(rank)").format(
        root=str(ROOT), tests=str(ROOT / "tests"), rdv=str(tmp_path / "rdv"),
        out=str(tmp_path / "out"))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)])
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0]
    want = _solve(spmd.mesh_of(["cuda:0", "cuda:1"]))
    for r in range(2):
        got = json.loads((tmp_path / f"out{r}").read_text())
        assert got.pop("info")["backend"] == "nccl"
        assert got == want


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 30, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_mesh_phase_on_the_cpu():
    """The phase's every check on the plain versions: the mesh ensemble,
    check_segmented over 4 shards with certificates, the Elle check over
    the shards, every sharded solve against the one-device one, every
    recorded scc_shard call against its plain version, and the 2-rank
    group."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    hists = [chip_smoke.ensemble_hist(i) for i in range(4)]
    la = synth.list_append_history(6_000, seed=11)
    twin = synth.corrupt_list_append_history(la, at_frac=0.85)[0]
    got = chip_smoke.mesh_path(torch.device("cpu"), False, hists, 1_000,
                               {"list-append": la,
                                "list-append-corrupted": twin},
                               group_histories=4)
    names = [k["name"] for k in got["kernels"]]
    assert names == ["wgl_search (ensemble, mesh form)", "scc_sweep",
                     "scc_apply", "scc_retire"]
    for k in got["kernels"]:
        assert k["max_abs_err"] == 0 and k["ms"] is None
        assert {"route", "source", "replaces", "launches", "plain_ms",
                "bound_ms", "bound_by", "library_ms"} <= set(k)
    assert all(k["replayed"] > 0 for k in got["kernels"][1:])
