"""Parity of the port's SCC (gpu/scc.py and the plain version of the
kernel in gpu/kernels/scc.py) with the JAX package's
`jepsen_tpu.tpu.scc`.

The same seeded numpy graphs go through the JAX program (`scc_device`,
jitted on the CPU) and the port's `scc_device(device="cpu")`, which runs
the kernel's plain PyTorch version. Labels are integers and max is
independent of order, so labels must be equal, and `None` (a cap hit)
must come back on the same inputs. The CUDA kernel itself runs only on a
card: its comparison with the plain version is the last test here,
skipped without CUDA, and chip_smoke.py makes it at full size.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu.tpu import scc as jscc
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.gpu import scc as pscc
from jepsen_tpu_torch.gpu.kernels import scc as kscc

torch.set_num_threads(1)


def _random_graph(seed, n, e):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e)


def _clustered_graph(seed, n, cluster, inner, cross):
    """Many large SCCs: random edges inside clusters of `cluster` nodes
    plus forward edges between clusters (and a few backward ones that
    merge neighbouring clusters)."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, n // cluster, inner)
    src = blk * cluster + rng.integers(0, cluster, inner)
    dst = blk * cluster + rng.integers(0, cluster, inner)
    cs = rng.integers(0, n - 2 * cluster, cross)
    cd = cs + rng.integers(1, 2 * cluster, cross)
    back = rng.integers(cluster, n, cross // 50)
    return (np.concatenate([src, cs, back]),
            np.concatenate([dst, cd, back - rng.integers(1, cluster,
                                                         back.size)]))


def _port_out(n, src, dst, emask=None):
    on = (np.ones(len(src), dtype=bool) if emask is None
          else np.asarray(emask, dtype=bool))
    return kscc.scc_labels(torch.from_numpy(np.asarray(src, np.int32)),
                           torch.from_numpy(np.asarray(dst, np.int32)),
                           torch.from_numpy(on), n).numpy()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_scc_device_matches_jax_random(seed, masked):
    n = 60 + 70 * seed
    src, dst, r = _random_graph(seed, n, 2 * n)
    emask = r < 0.6 if masked else None
    want = jscc.scc_device(n, src, dst, emask)
    got = pscc.scc_device(n, src, dst, emask, device="cpu")
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)
    sub = emask if masked else np.ones(len(src), dtype=bool)
    np.testing.assert_array_equal(
        got, jscc._scc_host(n, src[sub], dst[sub]))


@pytest.mark.parametrize("subset", [(0,), (0, 1), (0, 1, 2), (0, 1, 2, 3)])
def test_scc_edge_mask_subsets_match_jax(subset):
    """cycle_anomalies_arrays' shape: cumulative edge classes as masks
    over one shared edge array."""
    src, dst = _clustered_graph(3, 3000, 60, 6000, 1500)
    ty = np.random.default_rng(4).integers(0, 5, len(src))
    mask = np.isin(ty, subset)
    want = jscc.scc_device(3000, src, dst, mask)
    got = pscc.scc_device(3000, src, dst, mask, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert ([sorted(g.tolist()) for g in
             pscc.nontrivial_from_labels(got)]
            == [sorted(g.tolist()) for g in
                jscc.nontrivial_from_labels(want)])


def test_scc_above_device_min_edges_matches_jax():
    """A graph past DEVICE_MIN_EDGES takes the device path in both
    packages (the plain kernel here); many large components."""
    src, dst = _clustered_graph(7, 20_000, 200, 60_000, 12_000)
    assert len(src) >= pscc.DEVICE_MIN_EDGES
    telemetry.reset()
    got = pscc.scc(20_000, src, dst, device="cpu")
    assert telemetry.get().counters().get("scc.path.device") == 1
    want = jscc.scc(20_000, src, dst)
    np.testing.assert_array_equal(got, want)
    groups = pscc.nontrivial_sccs(20_000, src, dst, device="cpu")
    assert len(groups) > 20 and max(len(g) for g in groups) >= 150
    assert ([g.tolist() for g in groups]
            == [g.tolist() for g in jscc.nontrivial_sccs(20_000, src,
                                                         dst)])


def test_decreasing_chain_hits_the_sweep_cap_in_both():
    """A decreasing chain of 3,000 nodes needs ~3,000 forward sweeps:
    the JAX program and the plain kernel both stop at SWEEP_CAP and
    return None (scc() would send this graph to the host outright)."""
    assert (kscc.SWEEP_CAP, kscc.ROUND_CAP) == (jscc.SWEEP_CAP,
                                                jscc.ROUND_CAP)
    n = 3000
    src = np.arange(n - 1, 0, -1)
    dst = np.arange(n - 2, -1, -1)
    assert jscc.scc_device(n, src, dst) is None
    assert pscc.scc_device(n, src, dst, device="cpu") is None
    out = _port_out(n, src, dst)
    assert out[n:].tolist() == [0, 1, kscc.SWEEP_CAP + 1]


def test_short_decreasing_chain_hits_the_round_cap_in_both():
    """Each round retires only the chain's root, so 100 nodes need 100
    rounds: past ROUND_CAP both versions return None."""
    n = 100
    src = np.arange(n - 1, 0, -1)
    dst = np.arange(n - 2, -1, -1)
    assert jscc.scc_device(n, src, dst) is None
    assert pscc.scc_device(n, src, dst, device="cpu") is None
    assert _port_out(n, src, dst)[n:n + 2].tolist() == [0,
                                                        kscc.ROUND_CAP]


def _with_forward_chain(n, src, dst):
    """The graph plus an increasing chain of DEVICE_MIN_EDGES + 1 more
    nodes: enough live edges for scc() to take the device path, each
    chain node its own component, settled in one sweep."""
    m = pscc.DEVICE_MIN_EDGES + 1
    chain = np.arange(n, n + m)
    return (n + m + 1, np.concatenate([src, chain]),
            np.concatenate([dst, chain + 1]))


@pytest.mark.parametrize("shape", ["cycle-600", "decreasing-chain-70"])
def test_nonconverged_graph_relaunches_on_the_device_counted(shape):
    """A cap hit (ok false) is counted and launched again with caps of
    n, on the same device: the labels equal JAX's scc(), which sends the
    graph to scipy. A cycle of 600 needs ~600 sweeps in one round
    (SWEEP_CAP); a decreasing chain of 70 needs 70 rounds (ROUND_CAP)."""
    k = int(shape.rsplit("-", 1)[1])
    if shape.startswith("cycle"):
        src, dst = np.arange(k), (np.arange(k) + 1) % k
    else:
        src, dst = np.arange(k - 1, 0, -1), np.arange(k - 2, -1, -1)
    n, src, dst = _with_forward_chain(k, src, dst)
    assert jscc.scc_device(n, src, dst) is None
    assert pscc.scc_device(n, src, dst, device="cpu") is None
    telemetry.reset()
    before = kscc.launches
    labels = pscc.scc(n, src, dst, device="cpu")
    np.testing.assert_array_equal(labels, jscc.scc(n, src, dst))
    np.testing.assert_array_equal(labels, jscc._scc_host(n, src, dst))
    c = telemetry.get().counters()
    assert c.get("scc.device-nonconverged") == 1
    assert c.get("scc.path.device") == 1 and "scc.path.host" not in c
    assert kscc.launches == before  # the plain version ran: CPU tensors


def test_to_convergence_caps_cannot_be_hit():
    """The convergence launch has no caps: a decreasing chain of 100,
    which hits ROUND_CAP in the capped launch, is a DAG, so trim retires
    it with no colouring round, both ends of the chain in each of 50
    passes, and it comes back ok with every node its own component."""
    n = 100
    args = [torch.from_numpy(a.astype(np.int32)) for a in
            (np.arange(n - 1, 0, -1), np.arange(n - 2, -1, -1))]
    on = torch.ones(n - 1, dtype=torch.bool)
    out = kscc.scc_labels_to_convergence(*args, on, n).numpy()
    assert out[:n].tolist() == list(range(n))
    assert out[n:].tolist() == [1, 0, 0, n // 2]


def test_edges_share_one_array_over_masks():
    """One Edges object solves every mask of cycle_anomalies_arrays'
    cumulative classes, each equal to JAX's scc() on that mask."""
    src, dst = _clustered_graph(8, 20_000, 200, 60_000, 12_000)
    ty = np.random.default_rng(2).integers(0, 5, len(src))
    graph = pscc.Edges(20_000, src, dst, device="cpu")
    for sub in [(0, 1, 2), (0, 1, 2, 3), (0, 1, 2, 3, 4)]:
        mask = np.isin(ty, sub)
        np.testing.assert_array_equal(graph.scc(mask),
                                      jscc.scc(20_000, src, dst, mask))


def test_scc_rounds_count_the_plain_versions_sweeps():
    src, dst = _clustered_graph(5, 3000, 60, 6000, 1500)
    args = [torch.from_numpy(np.asarray(a, np.int32)) for a in (src, dst)]
    on = torch.from_numpy(np.random.default_rng(1).random(len(src)) < 0.7)
    out = kscc.scc_labels_reference(*args, on, 3000)
    work = kscc.scc_rounds(*args, on, 3000)
    assert len(work) == int(out[3001])
    assert sum(f + b for _l, _s, f, b in work) == int(out[3002])
    assert work[0][0] == int(on.sum())  # every node is active at first
    assert all(same <= live for live, same, _f, _b in work)


def test_kernel_failure_raises_out_of_scc(monkeypatch):
    """No hidden fallback: a failed launch is not sent to scipy."""
    def broken(*a, **k):
        raise RuntimeError("scc launch failed: CUDA error 700")

    monkeypatch.setattr(kscc, "scc_labels", broken)
    src, dst = _clustered_graph(1, 20_000, 200, 30_000, 5_000)
    with pytest.raises(RuntimeError, match="scc launch failed"):
        pscc.scc(20_000, src, dst, device="cpu")


def test_counts_and_empty_graphs():
    out = _port_out(0, [], [])
    assert out.tolist() == [1, 0, 0]
    assert pscc.scc(5, [], [], device="cpu").tolist() == list(range(5))
    assert pscc.nontrivial_sccs(0, [], [], device="cpu") == []
    # a 2-cycle and a self-loop: the self-loop is not a cycle
    src, dst = np.array([0, 1, 2]), np.array([1, 0, 2])
    labels = pscc.scc_device(3, src, dst, device="cpu")
    assert labels.tolist() == [1, 1, 2]
    np.testing.assert_array_equal(labels, jscc.scc_device(3, src, dst))
    assert [g.tolist() for g in pscc.nontrivial_from_labels(labels)] == \
        [[0, 1]]


def test_wrapper_rejects_bad_inputs():
    s = torch.tensor([0, 1], dtype=torch.int32)
    on = torch.ones(2, dtype=torch.bool)
    with pytest.raises(TypeError):
        kscc.scc_labels(s.long(), s, on, 2)
    with pytest.raises(TypeError):
        kscc.scc_labels(s, s, on.int(), 2)
    with pytest.raises(ValueError):
        kscc.scc_labels(s, s[:1], on, 2)
    with pytest.raises(ValueError):
        pscc.scc_device(2, [0, 2], [1, 0], device="cpu")
    # a device that is neither the card nor the CPU is refused, never
    # routed to the plain version
    with pytest.raises(ValueError):
        kscc.scc_labels(s.to("meta"), s.to("meta"), on.to("meta"), 2)


def test_plain_version_does_not_count_launches():
    before = kscc.launches
    _port_out(4, [0, 1, 2], [1, 2, 0])
    assert kscc.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_cuda_kernel_matches_plain(cuda_device):
    n = 3000
    chain = (np.arange(n - 1, 0, -1), np.arange(n - 2, -1, -1))
    graphs = [_clustered_graph(s, 20_000, 200, 60_000, 12_000)
              for s in range(2)] + [chain]
    for src, dst in graphs:
        for frac in (1.0, 0.5):
            on = np.random.default_rng(0).random(len(src)) < frac
            args = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda_device)
                    for a in (src, dst)]
            mask = torch.from_numpy(on).to(cuda_device)
            nn = int(max(src.max(), dst.max())) + 1
            before = kscc.launches
            got = kscc.scc_labels(*args, mask, nn)
            assert kscc.launches == before + 1
            want = kscc.scc_labels_reference(*args, mask, nn)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want.cpu())
