"""The port's multi-device form (gpu/spmd.py, gpu/ensemble.py's mesh,
gpu/scc.py's sharded solve) against the JAX package's mesh: the
counterpart of tests/test_spmd.py.

The JAX side runs on conftest's 8 virtual CPU devices; the port's side
on 8 CPU "cards" (the `cards8` fixture gives spmd.cards() eight CPU
entries, the port's counterpart of those virtual devices), so the
automatic route shards every wgl entry point and every SCC solve. Both
are capped at 0/1/2/4/8 devices by the same JEPSEN_TPU_SPMD /
JEPSEN_TPU_SPMD_DEVICES knobs, which each package re-reads per call.
Per-row results, reach masks, `unknown` flags, `it`, the level sums,
`device_entries` and certificates must be the JAX mesh's; the sharded
SCC's labels, ok, rounds and sweeps the one-device plain version's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_tpu import telemetry as jtel
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.tpu import certify as jcertify
from jepsen_tpu.tpu import ensemble as jens
from jepsen_tpu.tpu import profiler as jprof
from jepsen_tpu.tpu import scc as jscc
from jepsen_tpu.tpu import spmd as jspmd
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu.tpu.encode import balanced_groups as jbalanced
from jepsen_tpu.tpu.encode import encode as jencode
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import certify as pcertify
from jepsen_tpu_torch.gpu import ensemble as pens
from jepsen_tpu_torch.gpu import profiler as pprof
from jepsen_tpu_torch.gpu import scc as pscc
from jepsen_tpu_torch.gpu import spmd as pspmd
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl
from jepsen_tpu_torch.gpu.encode import balanced_groups as pbalanced
from jepsen_tpu_torch.gpu.encode import encode as pencode
from jepsen_tpu_torch.gpu.kernels import scc as kscc
from jepsen_tpu_torch.gpu.kernels import scc_shard as kshard

torch.set_num_threads(1)

CPU = torch.device("cpu")
CAPS = (0, 1, 2, 4, 8)
RENAME = {"tpu": "gpu", "tpu-sharded": "gpu-sharded",
          "tpu-segmented": "gpu-segmented",
          "tpu+host-fallback": "gpu+host-fallback"}


@pytest.fixture
def cards8(monkeypatch):
    """Eight CPU entries as the process's cards: the automatic route then
    shards CPU launches as it shards the card's."""
    monkeypatch.setattr(pspmd, "cards", lambda: [(0, CPU)] * 8)
    monkeypatch.delenv("JEPSEN_TPU_SPMD", raising=False)
    monkeypatch.delenv("JEPSEN_TPU_SPMD_DEVICES", raising=False)


@pytest.fixture(scope="module")
def devices8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip(f"the JAX side needs 8 devices, has {len(jax.devices())}")
    return 8


def _cap(monkeypatch, n: int) -> None:
    """Caps both packages' launch sites at an n-device mesh (0: SPMD off,
    the one-device launches)."""
    if n == 0:
        monkeypatch.setenv("JEPSEN_TPU_SPMD", "0")
    else:
        monkeypatch.delenv("JEPSEN_TPU_SPMD", raising=False)
        monkeypatch.setenv("JEPSEN_TPU_SPMD_DEVICES", str(n))


def _norm(x):
    if isinstance(x, dict):
        return {k: (RENAME.get(v, v) if k == "analyzer" else _norm(v))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if hasattr(x, "to_dict") and hasattr(x, "index"):
        return {"op": _norm(x.to_dict())}
    if type(x).__module__.endswith(".models"):
        return {"model": repr(x)}
    if isinstance(x, np.integer):
        return int(x)
    return x


def _both(n_ops, n_procs, seed, crash_p=0.0, corrupt_at=None):
    kw = dict(n_ops=n_ops, n_procs=n_procs, seed=seed, crash_p=crash_p)
    jh, ph = jsynth.register_history(**kw), psynth.register_history(**kw)
    if corrupt_at is not None:
        jh = jsynth.corrupt_register_history(jh, at_frac=corrupt_at)[0]
        ph = psynth.corrupt_register_history(ph, at_frac=corrupt_at)[0]
    return jh, ph


def _encs(pairs):
    return ([jencode(jmodels.cas_register(), j) for j, _p in pairs],
            [pencode(pmodels.cas_register(), p) for _j, p in pairs])


# ---------------------------------------------------------------------------
# plumbing: knobs, meshes, rule table, layout
# ---------------------------------------------------------------------------

def test_spmd_knobs(monkeypatch, cards8):
    monkeypatch.setenv("JEPSEN_TPU_SPMD", "0")
    assert pspmd.spmd_devices() == 0
    monkeypatch.delenv("JEPSEN_TPU_SPMD")
    assert pspmd.spmd_devices() == 8
    monkeypatch.setenv("JEPSEN_TPU_SPMD_DEVICES", "4")
    assert pspmd.spmd_devices() == 4
    monkeypatch.setenv("JEPSEN_TPU_SPMD_DEVICES", "junk")
    assert pspmd.spmd_devices() == 8  # a bad cap is ignored


def test_no_card_means_no_mesh(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_SPMD", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pspmd.spmd_devices() == 0
    assert pspmd.route(CPU, 64) is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pspmd.mesh_for(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pens.default_mesh()


def test_mesh_memoized_and_clamped(cards8):
    assert pspmd.mesh_for(2) is pspmd.mesh_for(2)
    assert pspmd.mesh_for(2).size == 2
    assert pspmd.mesh_for(2).axis_names == (pspmd.AXIS,) == ("b",)
    assert pspmd.mesh_for(64).size == 8
    assert pens.default_mesh().size == 8


def test_route(monkeypatch, cards8):
    assert pspmd.route(CPU, 64).size == 8
    assert pspmd.route(CPU, 5).size == 4          # powers of two only
    assert pspmd.route(CPU, 1) is None            # under MIN_ROWS
    assert pspmd.route(torch.device("cuda"), 64) is None  # other type
    monkeypatch.setenv("JEPSEN_TPU_SPMD_DEVICES", "1")
    assert pspmd.route(CPU, 64) is None


def test_explicit_meshes():
    m = pspmd.mesh_of(["cpu", "cpu", CPU])
    assert m.size == 3 and m.devices == (CPU,) * 3 and m.ranks == (0,) * 3
    assert m.local() == [0, 1, 2] and m.home() == CPU
    assert pspmd.as_mesh("cpu") == pspmd.mesh_of(["cpu"])
    assert pspmd.as_mesh(m) is m
    with pytest.raises(ValueError, match="one rank per device"):
        pspmd.Mesh([CPU, CPU], [0])
    with pytest.raises(ValueError, match="pass a device or a mesh"):
        pscc.Edges(3, [0], [1], device="cpu", mesh="cpu")


@pytest.mark.parametrize("rules,names", [
    ("WGL_RULES", pens.SHARD_ARGS), ("SCC_RULES", pscc.SCC_ARGS)])
def test_partition_rules_equal_jax(rules, names):
    assert names == (jens.SHARD_ARGS if rules == "WGL_RULES"
                     else jscc.SCC_ARGS)
    got = pspmd.match_partition_rules(getattr(pspmd, rules), names)
    want = jspmd.match_partition_rules(getattr(jspmd, rules), names)
    assert got == tuple(tuple(p) for p in want)
    assert pspmd.describe_partition(getattr(pspmd, rules), names) == \
        jspmd.describe_partition(getattr(jspmd, rules), names)


def test_unmatched_arg_raises():
    for mod in (pspmd, jspmd):
        with pytest.raises(ValueError, match="no partition rule"):
            mod.match_partition_rules(mod.WGL_RULES, ("trans", "mystery"))
        with pytest.raises(ValueError, match="no partition rule"):
            mod.describe_partition(mod.SCC_RULES, ("mystery",))


def test_describe_partition_is_the_lint_view():
    d = pspmd.describe_partition(pspmd.WGL_RULES, pens.SHARD_ARGS)
    assert set(d["sharded"]) == {"inv_t", "ret_t", "trans", "mseg",
                                 "sufmin", "row_seg", "st0"}
    assert d["replicated"] == ["inv_perm"] and d["axis"] == "b"


@pytest.mark.parametrize("weights,n", [
    ([10, 1, 9, 2, 8, 3], 2), ([5], 4), ([], 3), ([7, 7, 7, 1, 1], 3),
    (list(range(1, 40)), 8)])
def test_balanced_groups(weights, n):
    groups = pbalanced(weights, n)
    assert groups == jbalanced(weights, n)
    assert len(groups) == n
    assert sorted(i for g in groups for i in g) == list(range(len(weights)))
    assert all(g == sorted(g) for g in groups)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_shard_layout_equals_jax(n_dev):
    pairs = [_both(16 + 8 * i, 3, i) for i in range(5)]
    jencs, pencs = _encs(pairs)
    rows = [(i, e.init_state) for i, e in enumerate(pencs)] + [(1, 0)]
    jl = jens.shard_layout(jwgl.PackedBatch(jencs), rows, n_dev)
    pl = pens.shard_layout(pwgl.PackedBatch(pencs), rows, n_dev)
    for f in ("inv_t", "ret_t", "trans", "mseg", "sufmin", "row_seg",
              "st0", "inv_perm"):
        np.testing.assert_array_equal(getattr(pl, f), getattr(jl, f))
    assert pl.device_entries == jl.device_entries


# ---------------------------------------------------------------------------
# sharded against the JAX mesh: verdicts, masks, statistics, certificates
# ---------------------------------------------------------------------------

def _check_batch_inputs():
    pairs = [_both(26, 3, 700 + i, corrupt_at=0.6 if i in (3, 9) else None)
             for i in range(12)]
    return _encs(pairs)


def test_check_batch_across_mesh_caps(monkeypatch, cards8, devices8):
    jencs, pencs = _check_batch_inputs()
    for n in CAPS:
        _cap(monkeypatch, n)
        ptel.reset()
        got = pwgl.check_batch(pencs, W=16, F=16, device="cpu")
        want = jwgl.check_batch(jencs, W=16, F=16)
        np.testing.assert_array_equal(got, want)
        launches = ptel.get().counters().get("wgl.spmd.launches", 0)
        assert launches == (1 if n >= 2 else 0), n


@pytest.mark.parametrize("reach", [False, True], ids=["verdict", "reach"])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_launch_stats_equal_jax(reach, n_dev, devices8):
    """Per-row results (reach masks and unknown flags), `it` (pmax), the
    level series (psum) and the profiler's device_entries and balance of
    one launch, the port's mesh of n CPU shards against JAX's mesh of n
    virtual devices."""
    pairs = [_both(20 + 6 * i, 3, 40 + i, crash_p=0.1 * (i % 2))
             for i in range(7)]
    jencs, pencs = _encs(pairs)
    rows = [(i, s) for i, e in enumerate(pencs)
            for s in range(min(e.n_states, 2))]
    jprof.reset()
    pprof.reset()
    jout = jens.sharded_launch(jwgl.PackedBatch(jencs), rows, 16, 16,
                               reach=reach, mesh=jens.default_mesh(n_dev))
    jres = jwgl._drain(jout, reach=reach)
    pout = pens.sharded_launch(pwgl.PackedBatch(pencs), rows, 16, 16,
                               reach=reach,
                               mesh=pspmd.mesh_of(["cpu"] * n_dev))
    n_res = 2 if reach else 1
    for a, b in zip(pout.outs[n_res:], jout[n_res:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pres = pwgl._drain(pout, reach=reach)
    for a, b in zip(pres if reach else (pres,), jres if reach else (jres,)):
        np.testing.assert_array_equal(a, np.asarray(b)[:len(rows)])
    prec = [r for r in pprof.get().records() if r["kernel"] == "wgl-sharded"]
    jrec = [r for r in jprof.get().records() if r["kernel"] == "wgl-sharded"]
    assert len(prec) == len(jrec) == 1
    for k in ("devices", "device_entries", "balance", "iterations",
              "states_explored", "dedup_hits", "frontier_peak"):
        assert prec[0][k] == jrec[0][k], k


def test_check_batch_reach_across_mesh_caps(monkeypatch, cards8, devices8):
    pairs = [_both(30, 3, 60 + i, crash_p=0.15) for i in range(6)]
    jencs, pencs = _encs(pairs)
    for n in (0, 2, 8):
        _cap(monkeypatch, n)
        pout, punk = pwgl.check_batch_reach(pencs, W=8, F=8, device="cpu")
        jout, junk = jwgl.check_batch_reach(jencs, W=8, F=8)
        np.testing.assert_array_equal(pout, jout)
        np.testing.assert_array_equal(punk, junk)


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "invalid"])
def test_check_segmented_and_certificates_across_caps(monkeypatch, cards8,
                                                      devices8, valid):
    jh, ph = _both(360, 4, 31 if valid else 32,
                   corrupt_at=None if valid else 0.6)
    jenc = jencode(jmodels.cas_register(), jh)
    penc = pencode(pmodels.cas_register(), ph)
    by_cap = {}
    for n in CAPS:
        _cap(monkeypatch, n)
        ptel.reset()
        got = pwgl.check_segmented(penc, target_len=48, witness=True,
                                   device="cpu")
        pcertify.attach_wgl(pmodels.cas_register(), ph, penc, got)
        want = jwgl.check_segmented(jenc, target_len=48, witness=True)
        jcertify.attach_wgl(jmodels.cas_register(), jh, jenc, want)
        assert _norm(got) == _norm(want), n
        by_cap[n] = got
        spmd = ptel.get().counters().get("wgl.spmd.launches", 0)
        assert (spmd >= 1) == (n >= 2), (n, spmd)
    assert by_cap[0]["valid?"] is valid
    for n in CAPS[1:]:
        assert _norm(by_cap[n]) == _norm(by_cap[0])
    cert = by_cap[8]["certificate"]
    assert "absent" not in cert
    pcertify.validate(ph, cert)
    jcertify.validate(jh, cert)


def test_analysis_certificates_across_caps(monkeypatch, cards8, devices8):
    for valid, seed in ((True, 55), (False, 56)):
        jh, ph = _both(30, 3, seed, corrupt_at=None if valid else 0.5)
        by_cap = {}
        for n in (0, 2, 8):
            _cap(monkeypatch, n)
            got = pwgl.analysis(pmodels.cas_register(), ph, certify=True,
                                device="cpu")
            want = jwgl.analysis(jmodels.cas_register(), jh, certify=True)
            assert _norm(got) == _norm(want)
            by_cap[n] = (got["valid?"], got["certificate"])
        assert by_cap[2] == by_cap[0] == by_cap[8]
        assert by_cap[0][0] is valid
        pcertify.validate(ph, by_cap[0][1])


def test_check_slices_cross_tenant_parity(monkeypatch, cards8, devices8):
    """The fleet's cross-run batching entry point: many tenants' (slice,
    start-state) rows in ONE launch answer what the one-device launch
    and the JAX mesh answer."""
    pairs = [_both(40 + 10 * i, 3, 900 + i) for i in range(4)]
    jencs, pencs = _encs(pairs)

    def slices(encs):
        return [(e, s) for e in encs for s in range(min(e.n_states, 3))]

    _cap(monkeypatch, 0)
    ref_out, ref_unk = pwgl.check_slices(slices(pencs), W=16, F=16,
                                         device="cpu")
    for n in (2, 8):
        _cap(monkeypatch, n)
        ptel.reset()
        out, unk = pwgl.check_slices(slices(pencs), W=16, F=16,
                                     device="cpu")
        jout, junk = jwgl.check_slices(slices(jencs), W=16, F=16)
        assert out.tolist() == ref_out.tolist() == jout.tolist()
        assert unk.tolist() == ref_unk.tolist() == junk.tolist()
        assert ptel.get().counters()["wgl.spmd.launches"] == 1


def test_a_routed_launch_uploads_before_it_dispatches(monkeypatch, cards8):
    """wgl._launch over the mesh uploads every input, inv_perm included,
    before the first shard launches: on the card a copy from pageable
    host memory inside the dispatch would wait for the shards' searches,
    and the launch would no longer return before its search ends."""
    _jencs, pencs = _encs([_both(24, 3, 900 + i) for i in range(8)])
    inside, uploads = [], []
    real_upload, real_timed = pwgl._upload, pwgl._timed_launch
    real_from_numpy = torch.from_numpy

    def upload(parts, device):
        uploads.append(bool(inside))
        return real_upload(parts, device)

    def from_numpy(a):
        assert not inside, "a host array was uploaded in the dispatch"
        return real_from_numpy(a)

    def timed(bucket, dispatch, kernel, meta):
        def watched():
            inside.append(True)
            try:
                return dispatch()
            finally:
                inside.pop()
        return real_timed(bucket, watched, kernel=kernel, meta=meta)

    monkeypatch.setattr(pwgl, "_upload", upload)
    monkeypatch.setattr(pwgl, "_timed_launch", timed)
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    ptel.reset()
    got = pwgl.check_batch(pencs, W=16, F=16, device="cpu")
    monkeypatch.undo()
    assert ptel.get().counters()["wgl.spmd.launches"] == 1
    assert ptel.get().gauges()["wgl.spmd.devices"] == 8
    # eight shard blocks and inv_perm, all before the dispatch
    assert uploads == [False] * 9
    assert got.tolist() == pwgl.check_batch(pencs, W=16, F=16,
                                            device="cpu").tolist()


# ---------------------------------------------------------------------------
# the sharded SCC solve
# ---------------------------------------------------------------------------

def _graph(seed, n=2500, e=30_000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    ring = np.arange(40)
    return (n, np.concatenate([src, ring]),
            np.concatenate([dst, np.roll(ring, -1)]))


def _plain(n, src, dst, emask=None):
    """The one-device plain version's [n + 3]: labels, ok, rounds,
    sweeps."""
    on = np.ones(len(src), bool) if emask is None else emask
    return kscc.scc_labels_reference(
        torch.from_numpy(np.asarray(src, np.int32)),
        torch.from_numpy(np.asarray(dst, np.int32)),
        torch.from_numpy(on), n).numpy()


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_sharded_labels_equal_jax_scipy_and_one_device(monkeypatch,
                                                       devices8, seed):
    n, src, dst = _graph(seed)
    host = pscc._scc_host(n, src, dst)
    one = _plain(n, src, dst)
    assert one[:n].tolist() == host.tolist() and one[n] == 1
    _cap(monkeypatch, 8)
    want = jscc.scc_device(n, src, dst)
    assert want is not None and want[:n].tolist() == host.tolist()
    for k in (2, 4, 8):
        graph = pscc.Edges(n, src, dst, mesh=["cpu"] * k)
        assert graph.sharded
        out = graph.solve_sharded()
        # labels, ok, rounds and sweeps: the one-device launch's
        assert out.tolist() == one.tolist(), k


def test_keyblock_layout_and_masks_change_nothing(devices8):
    n, src, dst = _graph(6)
    ekey = np.random.default_rng(1).integers(-1, 5, len(src))
    emask = np.random.default_rng(2).random(len(src)) < 0.7
    one = _plain(n, src, dst, emask)
    ptel.reset()
    keyed = pscc.Edges(n, src, dst, ekey=ekey, mesh=["cpu"] * 4)
    assert keyed._order is not None
    assert keyed.solve_sharded(emask).tolist() == one.tolist()
    assert keyed.solve_sharded().tolist() == _plain(n, src, dst).tolist()
    assert ptel.get().counters()["scc.keyblock-layouts"] == 1
    # an ordered key array is laid out without a sort
    order = np.argsort(ekey, kind="stable")
    sorted_graph = pscc.Edges(n, src[order], dst[order], ekey=ekey[order],
                              mesh=["cpu"] * 4)
    assert sorted_graph._order is None
    assert sorted_graph.solve_sharded(emask[order]).tolist() == one.tolist()


def _masked_host(n, src, dst, emask):
    return pscc._scc_host(n, src[emask], dst[emask]).tolist()


def test_unsorted_keys_and_a_mask_through_scc(devices8):
    """scc() over an Edges that reorders its edges into key blocks lays
    the caller's mask out once: the answer is the host SCC of the masked
    edges, through the sharded solve and after a cap hit through the
    convergence launch."""
    n, src, dst = _graph(6)
    ekey = np.random.default_rng(1).integers(-1, 5, len(src))
    emask = np.random.default_rng(2).random(len(src)) < 0.7
    want = _masked_host(n, src, dst, emask)
    graph = pscc.Edges(n, src, dst, ekey=ekey, mesh=["cpu"] * 4)
    assert graph._order is not None
    assert graph.scc(emask).tolist() == want
    assert pscc.scc(n, src, dst, emask=emask, ekey=ekey,
                    mesh=["cpu"] * 4).tolist() == want
    # a decreasing chain past SWEEP_CAP with 2-cycles {i, i+1} at even
    # i, the mask keeping about half of them, its edges in scrambled key
    # order
    m = 3 * kscc.SWEEP_CAP
    down, up = np.arange(1, m), np.arange(0, m - 1, 2)
    src = np.concatenate([down, up]).repeat(40)
    dst = np.concatenate([down - 1, up + 1]).repeat(40)
    rng = np.random.default_rng(3)
    emask = np.concatenate([np.ones(len(down), bool),
                            rng.random(len(up)) < 0.5]).repeat(40)
    ekey = rng.integers(0, 7, len(src))
    want = _masked_host(m, src, dst, emask)
    assert want != _masked_host(m, src, dst, np.ones(len(src), bool))
    ptel.reset()
    graph = pscc.Edges(m, src, dst, ekey=ekey, mesh=["cpu"] * 2)
    assert graph._order is not None
    assert graph.scc(emask).tolist() == want
    assert ptel.get().counters()["scc.device-nonconverged"] == 1
    comps = pscc.nontrivial_sccs(m, src, dst, emask, ekey=ekey,
                                 mesh=["cpu"] * 2)
    assert sorted(map(len, comps)) == sorted(
        map(len, pscc.nontrivial_from_labels(np.asarray(want))))


def test_emask_subsets_survive_sharding(monkeypatch, cards8, devices8):
    n, src, dst = _graph(7)
    emask = np.random.default_rng(2).random(len(src)) < 0.7
    _cap(monkeypatch, 0)
    ref = pscc.scc(n, src, dst, emask=emask, device="cpu")
    _cap(monkeypatch, 8)
    pprof.reset()
    got = pscc.scc(n, src, dst, emask=emask, device="cpu")
    want = jscc.scc(n, src, dst, emask=emask)
    assert got.tolist() == ref.tolist() == want.tolist()
    recs = [r for r in pprof.get().records() if r["kernel"] == "scc"]
    assert [r.get("devices") for r in recs] == [8]


def test_small_graphs_stay_on_one_device():
    """Under DEVICE_MIN_EDGES edges a mesh of many shards solves on its
    first device, as the JAX program does."""
    n, src, dst = 50, np.arange(49), np.arange(1, 50)
    graph = pscc.Edges(n, src, dst, mesh=["cpu"] * 4)
    assert not graph.sharded
    assert graph.scc().tolist() == list(range(50))


def test_cap_hit_takes_the_convergence_launch(monkeypatch):
    """A decreasing chain past SWEEP_CAP: the sharded solve reports the
    cap (ok 0, as scc_kernel does), and scc() answers through the
    convergence launch on the first shard's device."""
    n = 3 * kscc.SWEEP_CAP
    src = np.arange(1, n).repeat(40)
    dst = np.arange(n - 1).repeat(40)
    graph = pscc.Edges(n, src, dst, mesh=["cpu"] * 2)
    out = graph.solve_sharded()
    assert out.tolist()[n:] == _plain(n, src, dst).tolist()[n:]
    assert out[n] == 0
    ptel.reset()
    labels = graph.scc()
    assert labels.tolist() == pscc._scc_host(n, src, dst).tolist()
    assert ptel.get().counters()["scc.device-nonconverged"] == 1


def test_elle_presorts_under_the_mesh(monkeypatch, cards8, devices8):
    """cycle_anomalies_arrays sorts the edges into key blocks once, where
    a solve will shard, and the anomalies are the one-device ones."""
    from jepsen_tpu_torch.gpu import elle_device

    n, src, dst = _graph(5)
    ty = np.random.default_rng(3).integers(0, 5, len(src))
    ekey = np.random.default_rng(4).integers(-1, 9, len(src))
    ops = list(range(n))
    # the one-device search over the edges in key-block order: the
    # witness found in an SCC follows the edge order, as in the JAX
    # package, whose sharded path sorts the same way
    o = np.argsort(ekey, kind="stable")
    _cap(monkeypatch, 0)
    ref = elle_device.cycle_anomalies_arrays(n, src[o], dst[o], ty[o],
                                             ops.__getitem__, device="cpu")
    _cap(monkeypatch, 4)
    ptel.reset()
    got = elle_device.cycle_anomalies_arrays(n, src, dst, ty, ops.__getitem__,
                                             device="cpu", ekey=ekey)
    assert got == ref and got
    from jepsen_tpu.tpu import elle_device as jelle_device

    assert got == jelle_device.cycle_anomalies_arrays(
        n, src, dst, ty, ops.__getitem__, device=True, ekey=ekey)
    c = ptel.get().counters()
    # presorted once: no solve needed its own sort
    assert c.get("scc.keyblock-layouts", 0) == 1


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

def _sweep_numpy(src, dst, on, active, x, col, backward, start=None,
                 compact=False):
    """prop after one sweep: `start` (NEUTRAL everywhere by default)
    max-accumulating x along the live edges, or where `compact` the
    fixpoint's starting value of each live edge's source (forward its
    id, backward col[s] == s); and the live (s, d) pairs in edge
    order."""
    n = len(x)
    prop = np.full(n, kshard.NEUTRAL, np.int64) if start is None \
        else np.array(start, np.int64)
    pairs = []
    for s, d, o in zip(src, dst, on):
        if not (o and active[s] and active[d]):
            continue
        if backward:
            if col[s] != col[d]:
                continue
            s, d = d, s
        pairs.append((s, d))
        v = (int(col[s] == s) if backward else s) if compact else x[s]
        prop[d] = max(prop[d], v)
    return prop, pairs


def _t(a, d=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(d)


def _shard_plan(src, dst, on, active, x, col, backward, prop=None,
                st=None):
    """A sweep plan over CPU copies of the arrays, and its tensors."""
    n, E = len(x), len(src)
    prop = torch.full((n,), kshard.NEUTRAL, dtype=torch.int32) \
        if prop is None else _t(prop)
    live = torch.full((E, 2), -7, dtype=torch.int32)
    cnt = torch.zeros(2, dtype=torch.int32)
    st = torch.zeros(kshard.STATE, dtype=torch.int32) if st is None else st
    return kshard.sweep_plan(_t(src), _t(dst), _t(on, torch.bool),
                             _t(active, torch.bool), _t(x), _t(col), prop,
                             live, cnt, st, backward)


def _live_pairs(plan):
    b = plan.params["backward"]
    k = int(plan.outputs["cnt"][b])
    return sorted(map(tuple, plan.outputs["live"][:k].tolist()))


@pytest.mark.parametrize("backward", [False, True])
def test_scc_sweep_plain_version(backward):
    """The compacting sweep lists the live edges and accumulates their
    sources' starting values into prop; a later sweep reads the list
    back and accumulates x; a sweep of a done fixpoint changes
    nothing."""
    rng = np.random.default_rng(9)
    n, E = 60, 400
    src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
    on = rng.random(E) < 0.8
    active = rng.random(n) < 0.9
    x = rng.integers(-1, n, n)
    col = rng.integers(0, 4, n)
    col[:8] = np.arange(8)  # some roots (col == id) for the backward pass
    start = rng.integers(-1, n, n)
    want, pairs = _sweep_numpy(src, dst, on, active, x, col, backward,
                               start, compact=True)
    plan = _shard_plan(src, dst, on, active, x, col, backward, start)
    cnt = plan.outputs["cnt"]
    cnt[1 - int(backward)] = 5
    kshard.scc_sweep(kshard.SweepGroup([plan]), compact=True)
    assert plan.outputs["prop"].tolist() == want.tolist()
    assert _live_pairs(plan) == sorted(pairs) and pairs
    assert cnt[1 - int(backward)] == 0
    prop = plan.outputs["prop"]
    prop.fill_(kshard.NEUTRAL)
    kshard.scc_sweep(kshard.SweepGroup([plan]), compact=False)
    assert prop.tolist() == _sweep_numpy(src, dst, on, active, x, col,
                                         backward)[0].tolist()
    prop.fill_(kshard.NEUTRAL)
    plan.args["st"][kshard.DONE] = kshard.CONVERGED
    kshard.scc_sweep(kshard.SweepGroup([plan]), compact=False)
    assert (prop == kshard.NEUTRAL).all()


@pytest.mark.parametrize("case", ["random", "duplicates", "none-on",
                                  "none-active", "no-class"])
@pytest.mark.parametrize("seed", [1, 2])
def test_compacting_sweep_against_numpy(case, seed):
    """Seeded graphs through the compacting and later sweeps of both
    passes, with repeated edges, and with live sets left empty by the
    edge mask, by the active set or (backward) by the colour classes."""
    rng = np.random.default_rng(seed)
    n, E = 50, 300
    src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
    if case == "duplicates":
        src, dst = np.tile(src[:30], 10), np.tile(dst[:30], 10)
    on = rng.random(E) < 0.7
    active = rng.random(n) < 0.8
    col = rng.integers(0, 3, n)
    if case == "none-on":
        on[:] = False
    elif case == "none-active":
        active[:] = False
    elif case == "no-class":  # every node its own class, no self-loop
        col = np.arange(n)
        dst = np.where(dst == src, (src + 1) % n, dst)
    for backward in (False, True):
        x = rng.integers(0, 2, n) if backward else rng.integers(-1, n, n)
        want, pairs = _sweep_numpy(src, dst, on, active, x, col, backward,
                                   compact=True)
        plan = _shard_plan(src, dst, on, active, x, col, backward)
        kshard.scc_sweep(kshard.SweepGroup([plan]), compact=True)
        prop = plan.outputs["prop"]
        assert prop.tolist() == want.tolist()
        assert _live_pairs(plan) == sorted(pairs)
        empty = case in ("none-on", "none-active") or (
            case == "no-class" and backward)
        assert (not pairs) == empty
        later = np.maximum(want, _sweep_numpy(src, dst, on, active, x, col,
                                              backward)[0])
        for _ in range(2):  # a later sweep accumulates x, idempotently
            kshard.scc_sweep(kshard.SweepGroup([plan]), compact=False)
            assert prop.tolist() == later.tolist()


def _apply_plan(x, prop, cap=kscc.SWEEP_CAP, active=None, c=None,
                backward=False):
    """An apply plan over CPU tensors: forward (c is x) unless
    `backward`, every node active unless `active` says otherwise."""
    st = torch.zeros(kshard.STATE, dtype=torch.int32)
    x = torch.tensor(x, dtype=torch.int32)
    active = torch.ones(len(x), dtype=torch.bool) if active is None \
        else torch.tensor(active)
    c = torch.tensor(c, dtype=torch.int32) if backward else x
    return kshard.apply_plan(x, torch.tensor(prop, dtype=torch.int32), st,
                             active, c, cap, backward)


def test_scc_apply_and_steps_plain_versions():
    """A later apply maxes prop into x and counts the sweep; the retire
    of a done fixpoint labels the members and counts the nodes left;
    the plans refuse wrong dtypes and shapes."""
    plan = _apply_plan([0, 5, -1, 3], [1, 2, -1, 3])
    x, prop, st = (plan.outputs[k] for k in ("x", "prop", "st"))
    st[kshard.SWEEPS] = 4
    kshard.scc_apply(plan, first=False)
    assert x.tolist() == [1, 5, -1, 3]
    assert (prop == kshard.NEUTRAL).all()
    assert st[kshard.SWEEPS] == 5 and st[kshard.DONE] == kshard.RUNNING
    kshard.scc_apply(plan, first=False)
    assert st[kshard.SWEEPS] == 6 and st[kshard.DONE] == kshard.CONVERGED
    active = torch.tensor([True, True, False, True])
    c = torch.tensor([1, 1, -1, 3], dtype=torch.int32)
    m = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    out = torch.full((4,), -1, dtype=torch.int32)
    kshard.scc_retire(kshard.retire_plan(active, c, m, out, st))
    assert out.tolist() == [1, 1, -1, -1]
    assert active.tolist() == [False, False, False, True]
    assert kshard.read_state(st, None) == (6, kshard.CONVERGED, 1)
    with pytest.raises(TypeError, match="int32"):
        kshard.apply_plan(x.long(), x, st, active, x, 8, False)
    with pytest.raises(ValueError, match="want"):
        kshard.apply_plan(x, x[:3], st, active, x, 8, False)
    with pytest.raises(TypeError, match="bool"):
        kshard.retire_plan(m, c, m, out, st)
    with pytest.raises(ValueError, match="want"):
        kshard.retire_plan(active, c, m, out, st[:4])


def _retire_case(done):
    """A backward chunk's tensors mid-round: colours, marks, the active
    set, labels of an earlier round, and the state `done`."""
    rng = np.random.default_rng(12)
    n = 40
    active = torch.from_numpy(rng.random(n) < 0.7)
    c = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    m = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    out = torch.from_numpy(np.where(active.numpy(), -1,
                                    rng.integers(0, n, n)).astype(np.int32))
    st = torch.zeros(kshard.STATE, dtype=torch.int32)
    st[kshard.SWEEPS], st[kshard.DONE], st[kshard.LEFT] = 3, done, 99
    return active, c, m, out, st


@pytest.mark.parametrize("case", [
    "forward-first", "backward-first", "compact-forward",
    "compact-backward", "retire-at-chunk-end", "retire-while-running",
    "left"])
def test_fused_round_steps_plain_versions(case):
    """The round's steps where they now run: the first applies start
    from c0 = active ? id : -1 and m0 = active & (c == id), computed by
    hand here; the compacting sweeps send those values along the live
    edges without reading x; the retire labels a round's members at the
    end of the chunk that ends the backward fixpoint, changes nothing
    while it runs, and leaves active.sum() in LEFT."""
    rng = np.random.default_rng(3)
    n = 50
    active = rng.random(n) < 0.8
    ids = np.arange(n)
    if case in ("forward-first", "backward-first"):
        backward = case == "backward-first"
        col = np.where(rng.random(n) < 0.3, ids, rng.integers(0, n, n))
        x0 = np.where(active & (col == ids), 1, 0) if backward else \
            np.where(active, ids, -1)
        prop = np.where(rng.random(n) < 0.5, kshard.NEUTRAL,
                        rng.integers(-1, n, n))
        stale = rng.integers(-1, n, n)  # the last round's values
        plan = _apply_plan(stale, prop, active=active, c=col,
                           backward=backward)
        plan.outputs["st"][kshard.SWEEPS] = 9
        plan.outputs["st"][kshard.DONE] = kshard.CONVERGED
        kshard.scc_apply(plan, first=True)
        x, st = plan.outputs["x"], plan.outputs["st"]
        assert x.tolist() == np.maximum(x0, prop).tolist()
        assert (plan.outputs["prop"] == kshard.NEUTRAL).all()
        assert st[kshard.SWEEPS] == 1
        assert st[kshard.DONE] == (kshard.RUNNING if (prop > x0).any()
                                   else kshard.CONVERGED)
        return
    if case.startswith("compact"):
        backward = case == "compact-backward"
        E = 300
        src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
        on = rng.random(E) < 0.8
        col = np.where(rng.random(n) < 0.5, ids, rng.integers(0, 3, n))
        # x holds garbage: the compacting sweep must not read it
        x = rng.integers(-50, -2, n)
        want, pairs = _sweep_numpy(src, dst, on, active, x, col, backward,
                                   compact=True)
        plan = _shard_plan(src, dst, on, active, x, col, backward)
        kshard.scc_sweep(kshard.SweepGroup([plan]), compact=True)
        assert plan.outputs["prop"].tolist() == want.tolist()
        assert _live_pairs(plan) == sorted(pairs) and pairs
        assert (want > kshard.NEUTRAL).any()
        return
    done = kshard.RUNNING if case == "retire-while-running" else \
        kshard.CONVERGED
    active, c, m, out, st = _retire_case(done)
    before = [t.clone() for t in (active, out, st)]
    plan = kshard.retire_plan(active, c, m, out, st)
    if case == "retire-at-chunk-end":
        # a backward chunk whose fixpoint ends: k sweeps, then the retire
        E = 10
        x = torch.zeros(len(active), dtype=torch.int32)
        sweep = kshard.sweep_plan(
            torch.zeros(E, dtype=torch.int32),
            torch.zeros(E, dtype=torch.int32),
            torch.zeros(E, dtype=torch.bool), active, m, c,
            torch.full_like(x, kshard.NEUTRAL),
            torch.empty((E, 2), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), st, True)
        apply = kshard.apply_plan(m, sweep.outputs["prop"], st, active, c,
                                  kscc.SWEEP_CAP, True)
        st[kshard.DONE] = kshard.RUNNING
        m_want = (active & (c == torch.arange(len(c)))).to(torch.int32)
        member = active & (m_want > 0)
        kshard.scc_chunk(kshard.ChunkPlan(kshard.SweepGroup([sweep]), apply,
                                          retire=plan), 3, True)
        assert m.tolist() == m_want.tolist()
        assert kshard.read_state(st, None) == (
            1, kshard.CONVERGED, int((before[0] & ~member).sum()))
    else:
        member = before[0] & (m > 0)
        kshard.scc_retire(plan)
    if case == "retire-while-running":
        assert [t.tolist() for t in (active, out, st)] == \
            [t.tolist() for t in before]
        return
    assert out.tolist() == torch.where(member, c, before[1]).tolist()
    assert active.tolist() == (before[0] & ~member).tolist()
    assert st[kshard.LEFT] == int(active.sum())
    assert st[kshard.TALLY] == st[kshard.TICKET] == 0
    if case == "left":
        # a second retire of the same done fixpoint finds no member left
        kshard.scc_retire(plan)
        assert st[kshard.LEFT] == int(active.sum())
        assert active.tolist() == (before[0] & ~member).tolist()


def test_apply_counts_sweeps_and_finishes_the_fixpoint():
    """The apply's device state: sweeps counted from `first`, done on no
    change (converged) or at the cap with a change (capped), and every
    later apply of a done fixpoint a no-op until the next `first`, which
    starts over from the active set (here node 0 alone)."""
    plan = _apply_plan([5, 5, 5], [-1, -1, -1], cap=3,
                       active=[True, False, False])
    x, prop, st = (plan.outputs[k] for k in ("x", "prop", "st"))
    for i in range(3):
        prop[0] = i + 1
        kshard.scc_apply(plan, first=i == 0)
        assert st[kshard.SWEEPS] == i + 1 and x[0] == i + 1
        assert st[kshard.CHANGED] == st[kshard.TICKET] == 0
    assert x.tolist() == [3, -1, -1]
    assert st[kshard.DONE] == kshard.CAPPED
    prop[1] = 9
    kshard.scc_apply(plan, first=False)
    assert x.tolist() == [3, -1, -1] and prop[1] == 9
    assert st[kshard.SWEEPS] == 3 and st[kshard.DONE] == kshard.CAPPED
    kshard.scc_apply(plan, first=True)  # the next fixpoint starts over
    assert x.tolist() == [0, 9, -1]
    assert st[kshard.SWEEPS] == 1 and st[kshard.DONE] == kshard.RUNNING
    kshard.scc_apply(plan, first=False)
    assert st[kshard.SWEEPS] == 2 and st[kshard.DONE] == kshard.CONVERGED
    assert kshard.read_state(st, None) == (2, kshard.CONVERGED, 0)


def test_wrappers_refuse_events_on_the_cpu():
    plan = _apply_plan([0, 0, 0], [0, 0, 0])
    with pytest.raises(ValueError, match="events"):
        kshard.scc_apply(plan, True, events=(None, None))


def test_a_chunk_is_its_sweeps_one_by_one():
    """scc_chunk's plain version: k sweeps of two shards sharing one
    accumulator, then the apply, equal to the launches one by one, and
    a chunk longer than the fixpoint changes nothing past its end."""
    n, src, dst = _graph(5, n=300, e=2_000)
    x0 = np.where(np.random.default_rng(4).random(n) < 0.9,
                  np.arange(n), -1)
    active = x0 >= 0
    on = np.ones(len(src), bool)

    def solve(k):
        x = _t(x0)
        prop = torch.full((n,), kshard.NEUTRAL, dtype=torch.int32)
        st = torch.zeros(kshard.STATE, dtype=torch.int32)
        half = len(src) // 2
        act = _t(active, torch.bool)
        sweeps = [kshard.sweep_plan(
            _t(src[lo:hi]), _t(dst[lo:hi]), _t(on[lo:hi], torch.bool),
            act, x, x, prop,
            torch.empty((hi - lo, 2), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), st, False)
            for lo, hi in ((0, half), (half, len(src)))]
        chunk = kshard.ChunkPlan(kshard.SweepGroup(sweeps),
                                  kshard.apply_plan(x, prop, st, act, x,
                                                    kscc.SWEEP_CAP, False))
        first = True
        while True:
            kshard.scc_chunk(chunk, k, first)
            first = False
            sweeps_done, done, _left = kshard.read_state(st, None)
            if done:
                return x.tolist(), sweeps_done, done, prop.tolist()

    want = solve(1)
    assert want[1] > 2 and want[2] == kshard.CONVERGED
    assert all(v == kshard.NEUTRAL for v in want[3])
    for k in (2, 3, want[1], 64):
        assert solve(k) == want, k


@pytest.mark.parametrize("chunk", [1, 3, 64, 4 * kscc.SWEEP_CAP])
def test_chunk_schedules_keep_sweeps_exact(monkeypatch, chunk):
    """Fixed chunk sizes, from one sweep to more than SWEEP_CAP: labels,
    ok, rounds and sweeps stay the one-device launch's, on a random
    graph and on the decreasing chain that hits SWEEP_CAP."""
    monkeypatch.setattr(pscc, "_schedule",
                        lambda head: iter(lambda: chunk, None))
    n, src, dst = _graph(6)
    graph = pscc.Edges(n, src, dst, mesh=["cpu"] * 4)
    assert graph.solve_sharded().tolist() == _plain(n, src, dst).tolist()
    n = 3 * kscc.SWEEP_CAP
    src = np.arange(1, n).repeat(40)
    dst = np.arange(n - 1).repeat(40)
    out = pscc.Edges(n, src, dst, mesh=["cpu"] * 2).solve_sharded()
    assert out.tolist()[n:] == _plain(n, src, dst).tolist()[n:]
    assert out[n] == 0 and out[n + 2] > kscc.SWEEP_CAP


def test_a_solver_serves_every_mask(monkeypatch):
    """An Edges object builds its sharded solver once: masks solved in
    turn, one of them cut off mid-solve, each answer the one-device
    launch's."""
    n, src, dst = _graph(6)
    rng = np.random.default_rng(8)
    masks = [rng.random(len(src)) < p for p in (0.5, 0.9)]
    graph = pscc.Edges(n, src, dst, mesh=["cpu"] * 4)
    for m in (masks[0], masks[1], masks[0]):
        assert graph.solve_sharded(m).tolist() == \
            _plain(n, src, dst, m).tolist()
    solver = graph._solver
    reads = iter(range(3))

    def cut(st, host):
        if next(reads) == 1:
            raise KeyboardInterrupt
        return orig(st, host)
    orig = kshard.read_state
    monkeypatch.setattr(kshard, "read_state", cut)
    with pytest.raises(KeyboardInterrupt):
        graph.solve_sharded(masks[1])
    monkeypatch.setattr(kshard, "read_state", orig)
    assert graph._solver is solver
    assert graph.solve_sharded(masks[1]).tolist() == \
        _plain(n, src, dst, masks[1]).tolist()


def test_the_combine_across_devices():
    """_combine over two CPU buffers standing for two other cards: maxed
    onto the home's accumulator, each reset to NEUTRAL; and a solve
    whose shards lie on "cpu" and "cpu:0" (two devices to the solve)
    runs launch by launch through it, equal to the one-device launch."""
    prop = torch.tensor([-1, 4, -1, 0], dtype=torch.int32)
    q1 = torch.tensor([2, -1, -1, 7], dtype=torch.int32)
    q2 = torch.tensor([-1, 5, -1, 1], dtype=torch.int32)
    pscc._combine(prop, [q1, q2], group=False)
    assert prop.tolist() == [2, 5, -1, 7]
    assert (q1 == kshard.NEUTRAL).all() and (q2 == kshard.NEUTRAL).all()
    n, src, dst = _graph(7)
    emask = np.random.default_rng(2).random(len(src)) < 0.7
    graph = pscc.Edges(n, src, dst, mesh=["cpu", "cpu:0", "cpu:0", "cpu"])
    solve = pscc._ShardedSolve
    seen = []
    monkey = pytest.MonkeyPatch()
    orig = solve._sweep
    monkey.setattr(solve, "_sweep", lambda self, b, compact: (
        seen.append((len(self.others), self.chunks)),
        orig(self, b, compact)))
    try:
        assert graph.solve_sharded(emask).tolist() == \
            _plain(n, src, dst, emask).tolist()
    finally:
        monkey.undo()
    assert seen and all(k == 1 and c is None for k, c in seen)


def _jax_sharded(n, src, dst, emask=None):
    """The JAX mesh program, `_jitted_scc_sharded` on conftest's 8 CPU
    devices, over the edges laid out as scc_device lays them out (no
    DEVICE_MIN_EDGES: the program itself, at any size): its labels
    (-1 where no round retired the node) and ok."""
    import jax
    from jax.sharding import NamedSharding

    n_dev = 8
    n_pad = jscc._next_pow2(n + 1)
    e_pad = jscc._edge_pad(len(src))
    e_pad += -e_pad % n_dev
    psrc = np.full(e_pad, n, dtype=np.int32)
    pdst = np.full(e_pad, n, dtype=np.int32)
    psrc[:len(src)], pdst[:len(dst)] = src, dst
    pmask = np.zeros(e_pad, dtype=bool)
    pmask[:len(src)] = True if emask is None else emask
    active = np.zeros(n_pad, dtype=bool)
    active[:n] = True
    mesh = jspmd.mesh_for(n_dev)
    fn = jscc._jitted_scc_sharded(mesh, n_pad, e_pad, jscc.SWEEP_CAP,
                                  jscc.ROUND_CAP)
    specs = jspmd.match_partition_rules(jspmd.SCC_RULES, jscc.SCC_ARGS)
    out = np.asarray(fn(*(jax.device_put(a, NamedSharding(mesh, sp))
                          for a, sp in zip((active, psrc, pdst, pmask),
                                           specs))))
    return out[:n].tolist(), int(out[-1])


def _chain(k):
    """A decreasing chain of k nodes: each round retires its root."""
    return k, np.arange(k - 1, 0, -1), np.arange(k - 2, -1, -1)


def _ending_graph(end):
    """A graph whose solve ends `end`'s way, and its edge mask."""
    if end == "all-retired":
        return (*_graph(5, n=400, e=3_000), None)
    if end == "sweep-cap":  # the forward fixpoint hits SWEEP_CAP
        return (*_chain(3 * kscc.SWEEP_CAP), None)
    if end == "round-cap":  # ROUND_CAP rounds, each retiring one node
        return (*_chain(100), None)
    if end == "cycle-600":  # SWEEP_CAP inside the one round
        k = 600
        return k, np.arange(k), (np.arange(k) + 1) % k, None
    n, src, dst = _graph(5, n=400, e=3_000)
    return n, src, dst, np.zeros(len(src), bool)  # "empty-mask"


_JAX_SHARDED: dict = {}


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("end", ["all-retired", "sweep-cap", "round-cap",
                                 "cycle-600", "empty-mask"])
def test_sharded_solve_equals_the_jax_mesh(devices8, end, k):
    """The sharded solve over k CPU shards, its rounds' steps folded into
    the fixpoints' launches: labels and ok equal to the JAX mesh
    program's on 8 devices, rounds and sweeps to the one-device plain
    version's, on graphs that end with every node retired, at SWEEP_CAP
    (forward, or inside the one round of a 600-node cycle), at ROUND_CAP
    and with no edge on."""
    n, src, dst, emask = _ending_graph(end)
    if end not in _JAX_SHARDED:
        _JAX_SHARDED[end] = _jax_sharded(n, src, dst, emask)
    labels, ok = _JAX_SHARDED[end]
    one = _plain(n, src, dst, emask)
    out = pscc.Edges(n, src, dst, mesh=["cpu"] * k).solve_sharded(emask)
    assert out[:n].tolist() == labels and out[n] == ok
    assert out[n + 1:].tolist() == one[n + 1:].tolist()
    assert ok == {"all-retired": 1, "empty-mask": 1}.get(end, 0)
    if end == "round-cap":
        assert out[n + 1] == kscc.ROUND_CAP
    if end == "empty-mask":  # one round: each node its own component
        assert labels == list(range(n)) and out[n + 1] == 1


@pytest.mark.parametrize("mesh", [["cpu"] * 4, ["cpu", "cpu:0"]],
                         ids=["one-device", "launch-by-launch"])
@pytest.mark.parametrize("chunk", [None, 1])
def test_a_solve_retires_once_a_round_and_reads_once_a_chunk(
        monkeypatch, mesh, chunk):
    """Every backward chunk ends in the retire, on one device inside
    scc_chunk and launch by launch as one scc_retire; only the chunk
    that ends its fixpoint retires, once a round. The solve reads the
    state back once a chunk and nothing else: no read of its own a
    round."""
    if chunk is not None:
        monkeypatch.setattr(pscc, "_schedule",
                            lambda head: iter(lambda: chunk, None))
    calls = {"chunks": 0, "reads": 0, "retires": 0, "retired": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    retire = kshard.retire_reference

    def counted_retire(plan):
        calls["retires"] += 1
        calls["retired"] += int(plan.outputs["st"][kshard.DONE]) != \
            kshard.RUNNING
        retire(plan)
    monkeypatch.setattr(kshard, "retire_reference", counted_retire)
    monkeypatch.setattr(kshard, "scc_chunk",
                        count("chunks", kshard.scc_chunk))
    monkeypatch.setattr(pscc._ShardedSolve, "_launches",
                        count("chunks", pscc._ShardedSolve._launches))
    monkeypatch.setattr(kshard, "read_state",
                        count("reads", kshard.read_state))
    n, src, dst = _graph(7, n=400, e=1_200)  # 4 rounds
    emask = np.random.default_rng(2).random(len(src)) < 0.7
    graph = pscc.Edges(n, src, dst, mesh=mesh)
    out = graph.solve_sharded(emask)
    assert out.tolist() == _plain(n, src, dst, emask).tolist()
    rounds = int(out[n + 1])
    assert rounds >= 2
    assert calls["retired"] == rounds
    assert calls["reads"] == calls["chunks"]
    # one retire a backward chunk, and a backward chunk a round at least
    assert rounds <= calls["retires"] < calls["chunks"]
    if chunk == 1:  # one sweep a chunk: every later one is a no-op
        assert calls["retires"] > rounds
    assert not hasattr(graph._solver, "ctl")


# ---------------------------------------------------------------------------
# the fake-8 tripwire
# ---------------------------------------------------------------------------

def test_sharded_launch_spreads_work_over_8_devices(cards8):
    """Every one of 8 shards gets real rows, with a sane balance: if a
    refactor quietly re-serializes or re-replicates the launch, this
    fails here, not on hardware."""
    pprof.reset()
    ptel.reset()
    pairs = [_both(24, 3, 300 + i) for i in range(16)]
    _jencs, pencs = _encs(pairs)
    res = pens.check_batch_sharded(pencs, mesh=pens.default_mesh(8), W=16,
                                   F=16)
    assert all(int(r) == pwgl.VALID for r in res)
    recs = [r for r in pprof.get().records() if r["kernel"] == "wgl-sharded"]
    assert recs, "sharded launch left no profiler record"
    r = recs[0]
    assert r["devices"] == 8 and len(r["device_entries"]) == 8
    assert all(w > 0 for w in r["device_entries"]), r["device_entries"]
    assert r["balance"] and r["balance"] >= 0.5
    assert ptel.get().gauges().get("wgl.spmd.devices") == 8


def test_segmented_path_rides_the_mesh(cards8):
    ptel.reset()
    enc = pencode(pmodels.cas_register(),
                  psynth.register_history(400, n_procs=4, seed=71))
    res = pwgl.check_segmented(enc, target_len=32, device="cpu")
    assert res is not None and res["valid?"] is True
    c = ptel.get().counters()
    assert c.get("wgl.spmd.launches", 0) >= 1
    jtel.reset()


# ---------------------------------------------------------------------------
# the lint reads the layout the launches use
# ---------------------------------------------------------------------------

def test_r4_reads_the_sharded_launches_layout():
    from jepsen_tpu_torch.analysis import registry
    from jepsen_tpu_torch.gpu import lint

    entries = {e.name: e for e in registry.entries()}
    wgl_trace = entries["wgl-sharded"].trace(entries["wgl-sharded"].buckets[0])
    assert wgl_trace.partition == pspmd.describe_partition(
        pspmd.WGL_RULES, pens.SHARD_ARGS)
    assert [a for a, _ax, _why in wgl_trace.batch_axes] == ["row_seg"]
    scc_trace = entries["scc-sharded"].trace(entries["scc-sharded"].buckets[0])
    assert scc_trace.partition == jspmd.describe_partition(
        jspmd.SCC_RULES, jscc.SCC_ARGS)
    assert [a for a, _ax, _why in scc_trace.batch_axes] == ["src"]
    assert {a.name for a in scc_trace.args} >= set(pscc.SCC_ARGS)
    # the layout the launches use gives R4 nothing to price ...
    assert lint.rule_sharding(wgl_trace) == []
    assert lint.rule_sharding(scc_trace) == []
    # ... where a replicated edge list or an unsharded row axis would be
    scc_trace.partition = {"axis": "b", "sharded": [],
                           "replicated": list(pscc.SCC_ARGS)}
    sites = {f.site for f in lint.rule_sharding(scc_trace)}
    assert {"replicated:src", "unsharded-axis:src.0"} <= sites
