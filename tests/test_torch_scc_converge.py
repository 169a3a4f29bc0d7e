"""The port's convergence launch (gpu/kernels/scc.py:
scc_labels_to_convergence and its plain version), the launch that
`Edges.scc` makes after the capped launch hits SWEEP_CAP or ROUND_CAP.

The JAX package hands such a graph to scipy; the port solves it on the
same device by trim (nodes with no live in- or out-edge retire as their
own components, in level-synchronous passes) and colouring rounds
without caps. The same seeded graphs go through the port on the CPU
(the plain version) and through JAX's `scc()` and `_scc_host()`: labels
must be equal. The counts (colouring rounds, sweeps, trim passes) are
order-free, so the plain version's are the kernel's; the last test,
skipped without a card, holds the two against each other.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu.tpu import scc as jscc
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.gpu import scc as pscc
from jepsen_tpu_torch.gpu.kernels import scc as kscc

torch.set_num_threads(1)


def _decreasing_chain(n):
    return n, np.arange(n - 1, 0, -1), np.arange(n - 2, -1, -1)


def _cycle(n):
    return n, np.arange(n), (np.arange(n) + 1) % n


def _cycle_chain(k, size):
    """k cycles of `size` nodes, each joined to the one below it by an
    edge from its first node to the last node of the lower cycle: a
    decreasing chain of non-trivial components, which trim cannot
    touch."""
    base = np.repeat(np.arange(k) * size, size)
    pos = np.tile(np.arange(size), k)
    links = np.arange(1, k) * size
    return (k * size, np.concatenate([base + pos, links]),
            np.concatenate([base + (pos + 1) % size, links - 1]))


def _with_forward_chain(n, src, dst):
    """The graph plus an increasing chain of DEVICE_MIN_EDGES + 1 more
    nodes: enough live edges for scc() to take the device path."""
    m = pscc.DEVICE_MIN_EDGES + 1
    chain = np.arange(n, n + m)
    return (n + m + 1, np.concatenate([src, chain]),
            np.concatenate([dst, chain + 1]))


def _tensors(src, dst, on=None):
    on = np.ones(len(src), dtype=bool) if on is None else on
    return (torch.from_numpy(np.asarray(src, np.int32)),
            torch.from_numpy(np.asarray(dst, np.int32)),
            torch.from_numpy(np.asarray(on, bool)))


SHAPES = {"decreasing-chain-3000": lambda: _decreasing_chain(3000),
          "cycle-chain-100x10": lambda: _cycle_chain(100, 10),
          "cycle-600": lambda: _cycle(600)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cap_hit_converges_on_the_same_device_counted(shape):
    """The capped launch hits a cap (in JAX too), scc() counts it once
    and makes the convergence launch once; the labels equal JAX's scc(),
    which sends the graph to scipy, and scipy's own."""
    n, src, dst = _with_forward_chain(*SHAPES[shape]())
    assert jscc.scc_device(n, src, dst) is None
    assert pscc.scc_device(n, src, dst, device="cpu") is None
    telemetry.reset()
    before = (kscc.launches, kscc.converge_launches)
    labels = pscc.scc(n, src, dst, device="cpu")
    np.testing.assert_array_equal(labels, jscc.scc(n, src, dst))
    np.testing.assert_array_equal(labels, jscc._scc_host(n, src, dst))
    c = telemetry.get().counters()
    assert c.get("scc.device-nonconverged") == 1
    assert c.get("scc.path.device") == 1 and "scc.path.host" not in c
    # the plain versions ran: CPU tensors launch nothing
    assert (kscc.launches, kscc.converge_launches) == before


def test_a_dag_is_retired_by_trim_alone():
    """The 3,000-node decreasing chain joined to the forward chain is a
    DAG: no colouring round and no sweep. Each trim pass retires both
    ends of every chain, so the passes are those of the longer chain,
    (its nodes + 1) // 2."""
    n, src, dst = _with_forward_chain(*_decreasing_chain(3000))
    out = kscc.scc_converge_reference(*_tensors(src, dst), n).numpy()
    longest = pscc.DEVICE_MIN_EDGES + 2  # nodes of the forward chain
    assert out[n:].tolist() == [1, 0, 0, (longest + 1) // 2]
    assert out[:n].tolist() == list(range(n))


def test_cycle_counts():
    """One cycle of 600: no trim pass, one round. The first round, by id,
    gives up unsettled after FIRST_ROUND_SWEEPS (64) forward sweeps; the
    round by priority then floods once round the cycle (600 sweeps, the
    last changing nothing) and so does the backward membership from the
    root: 64 + 1,200 sweeps."""
    n, src, dst = _cycle(600)
    out = kscc.scc_labels_to_convergence(*_tensors(src, dst), n).numpy()
    assert kscc.FIRST_ROUND_SWEEPS == 64
    assert out[n:].tolist() == [1, 1, 1264, 0]
    assert (out[:n] == n - 1).all()


def test_cycle_chain_100_counts_by_id_then_priority():
    """What trim cannot touch, 100 ten-node cycles in a decreasing chain.
    Coloured by id in every round, each round retired the top cycle
    only, after a flood down the rest of the chain: 100 rounds, 11,900
    sweeps. The first round, by id, gives up after 64 forward sweeps;
    later rounds colour by priority, every cycle that beats all the
    active cycles above it retires in the same round, and the retired
    cycles cut the chain: exactly 8 rounds and 705 sweeps (64 of them
    the first round's), no trim pass."""
    n, src, dst = _cycle_chain(100, 10)
    out = kscc.scc_labels_to_convergence(*_tensors(src, dst), n).numpy()
    ok, rounds, sweeps, passes = out[n:].tolist()
    assert (ok, rounds, sweeps, passes) == (1, 8, 705, 0)
    np.testing.assert_array_equal(out[:n], jscc._scc_host(n, src, dst))


# (k, rounds, sweeps) of the plain version on _cycle_chain(k, 10), the
# first round's 64 given-up sweeps included; by id in every round the
# rounds were k and the sweeps k(k + 19): 11,900, 43,800, 167,600 and
# 655,200
CYCLE_CHAIN_COUNTS = [(100, 8, 705), (200, 9, 990), (400, 9, 1002),
                      (800, 10, 2378)]


@pytest.mark.parametrize("k, rounds, sweeps", CYCLE_CHAIN_COUNTS)
def test_cycle_chain_sweeps_stay_linear(k, rounds, sweeps):
    """A chain of k ten-node cycles costs at most 10 n sweeps (n = 10 k
    nodes), with its exact counts pinned, and labels equal to scipy's
    and JAX's scc()."""
    n, src, dst = _cycle_chain(k, 10)
    out = kscc.scc_converge_reference(*_tensors(src, dst), n).numpy()
    assert out[n:].tolist() == [1, rounds, sweeps, 0]
    assert sweeps <= 10 * n
    want = jscc._scc_host(n, src, dst)
    np.testing.assert_array_equal(out[:n], want)
    np.testing.assert_array_equal(
        want, jscc.scc(*_with_forward_chain(n, src, dst))[:n])


def _clustered(seed, n, cluster, inner, cross):
    """Random edges inside clusters of `cluster` nodes plus forward
    edges (to higher ids) between clusters: many large components whose
    ids follow a topological order."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, n // cluster, inner)
    src = blk * cluster + rng.integers(0, cluster, inner)
    dst = blk * cluster + rng.integers(0, cluster, inner)
    cs = rng.integers(0, n - 2 * cluster, cross)
    cd = cs + rng.integers(1, 2 * cluster, cross)
    return n, np.concatenate([src, cs]), np.concatenate([dst, cd])


def test_wide_clustered_graph_retires_in_the_first_round():
    """6,000 nodes in clusters of 300, 30,000 edges inside them and
    6,000 forward edges between them. The first round colours by id, and
    every edge between components goes to higher ids, so no colour from
    another component beats a component's own highest id: every
    component left after trim retires in that one round (coloured by
    priority from the start: 5 rounds, 92 sweeps).
    Labels equal scipy's and JAX's scc()."""
    n, src, dst = _clustered(7, 6000, 300, 30_000, 6000)
    out = kscc.scc_converge_reference(*_tensors(src, dst), n).numpy()
    assert out[n:].tolist() == [1, 1, 16, 2]
    want = jscc._scc_host(n, src, dst)
    np.testing.assert_array_equal(out[:n], want)
    np.testing.assert_array_equal(out[:n], jscc.scc(n, src, dst))


def test_priorities_are_a_bijection():
    """prio and its inverse agree with each other over ids at both ends
    of the int32 range, and stay non-negative."""
    v = torch.tensor([0, 1, 2, 9, 12345, 2 ** 30, 2 ** 31 - 5, 2 ** 31 - 1],
                     dtype=torch.int64)
    p = kscc._prio(v)
    assert (p >= 0).all()
    assert len(set(p.tolist())) == len(v)
    assert kscc._unprio(p).long().tolist() == v.tolist()
    assert (kscc.PRIO * kscc.PRIO_INV) % 2 ** 32 == 1


def _random_graph(seed):
    """Random edges over clusters, with self-loops, repeated edges and a
    mask; many SCCs, trees hanging off them and isolated nodes."""
    rng = np.random.default_rng(seed)
    n = 200 + 150 * seed
    e = 3 * n
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.7,
                   np.minimum(n - 1, src + rng.integers(0, 8, e)),
                   rng.integers(0, n, e))
    src[:5], dst[:5] = src[5:10], src[5:10]  # self-loops
    src[10:20], dst[10:20] = src[20:30], dst[20:30]  # repeats
    return n, src, dst, rng.random(e) < 0.8


@pytest.mark.parametrize("seed", range(6))
def test_random_graphs_match_scipy_and_jax(seed):
    n, src, dst, on = _random_graph(seed)
    out = kscc.scc_labels_to_convergence(*_tensors(src, dst, on), n)
    out = out.numpy()
    assert out[n] == 1
    np.testing.assert_array_equal(out[:n],
                                  jscc._scc_host(n, src[on], dst[on]))
    np.testing.assert_array_equal(out[:n], jscc.scc(n, src, dst, on))


def test_labels_equal_the_capped_launch_where_it_converges():
    """On a graph the capped launch solves, both launches give the same
    labels (their counts differ: they are different algorithms)."""
    n, src, dst, on = _random_graph(2)
    args = _tensors(src, dst, on)
    capped = kscc.scc_labels(*args, n).numpy()
    assert capped[n] == 1
    conv = kscc.scc_labels_to_convergence(*args, n).numpy()
    np.testing.assert_array_equal(conv[:n], capped[:n])


def test_empty_and_edgeless_graphs():
    out = kscc.scc_labels_to_convergence(*_tensors([], []), 0)
    assert out.tolist() == [1, 0, 0, 0]
    out = kscc.scc_labels_to_convergence(*_tensors([2, 1], [2, 1]), 4)
    # self-loops only: every node is trimmed in the first pass
    assert out.tolist() == [0, 1, 2, 3, 1, 0, 0, 1]


def test_syncs_buffer_is_refused_with_cpu_tensors():
    with pytest.raises(ValueError, match="syncs"):
        kscc.scc_labels_to_convergence(*_tensors([0], [1]), 2,
                                       syncs=torch.zeros(2,
                                                         dtype=torch.int32))
    with pytest.raises(ValueError, match="syncs"):
        kscc.scc_labels(*_tensors([0], [1]), 2,
                        syncs=torch.zeros(2, dtype=torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_cuda_convergence_kernel_matches_plain(cuda_device, monkeypatch):
    graphs = [SHAPES[k]() for k in sorted(SHAPES)]
    graphs += [_random_graph(s)[:3] for s in range(3)]
    tails = (-1, kscc.TAIL_WORK, 2 ** 31 - 1)
    for n, src, dst in graphs:
        args = _tensors(src, dst)
        want = kscc.scc_converge_reference(*args, n)
        for tail in tails:
            monkeypatch.setattr(kscc, "TAIL_WORK", tail)
            before = kscc.converge_launches
            got = kscc.scc_labels_to_convergence(
                *(a.to(cuda_device) for a in args), n)
            assert kscc.converge_launches == before + 1
            assert torch.equal(got.cpu(), want)
