"""Parity of the port's batch-checking path with the JAX package's on the
CPU: check_slices masks and unknown flags, analysis_batch and
analysis_batch_streamed result dicts, and the ensemble module
(shard_layout arrays, check_batch_sharded, analysis_batch_sharded).

The port runs its kernel's plain PyTorch version (device="cpu"). The
JAX side runs as tier-1 runs it: conftest pins 8 virtual CPU devices, so
its batch calls of two or more rows go through the shard_map program.
Per-row outputs compare exactly. The launch-wide `it` and level series
compare only where both sides pad alike (a mesh of 1): the port runs one
launch over the one-device layout whatever the mesh it stands for, while
JAX's mesh-8 layout pads each device's block on its own. Histories come
from the same seeded generator on both sides."""

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import op as jop
from jepsen_tpu.tpu import certify as jcertify
from jepsen_tpu.tpu import ensemble as jens
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.tpu import wgl as jwgl
from jepsen_tpu.tpu.encode import encode as jencode
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import certify as pcertify
from jepsen_tpu_torch.gpu import ensemble as pens
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl
from jepsen_tpu_torch.gpu.encode import encode as pencode
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import op as pop

torch.set_num_threads(1)

# the analyzer names differ only by the device family
RENAME = {"tpu": "gpu", "tpu-sharded": "gpu-sharded",
          "tpu+host-fallback": "gpu+host-fallback"}


def _norm(x):
    """Ops and model states are different classes in the two packages:
    compare them as dicts and reprs; analyzer names are renamed."""
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


def _streamed_inputs():
    """The JAX TestStreamedBatch inputs: 40 histories of 60 ops, 2/3 of
    them with crash_p 0.1, and member 7 given a read of a value never
    written."""
    jhs, phs = [], []
    for i in range(40):
        jh, ph = _both(60, 3, 100 + i, crash_p=0.1 if i % 3 else 0.0)
        jhs.append(jh)
        phs.append(ph)
    for hs, mk, H in ((jhs, jop, JHistory), (phs, pop, PHistory)):
        ops = list(hs[7])
        ops.append(mk(type="invoke", process=0, f="read", value=None))
        ops.append(mk(type="ok", process=0, f="read", value=424242))
        hs[7] = H(ops)
    return jhs, phs


@pytest.fixture(scope="module")
def streamed_inputs():
    return _streamed_inputs()


def _tenants(crash_p):
    pairs = [_both(40 + 10 * i, 3, 900 + i, crash_p=crash_p)
             for i in range(4)]
    jencs = [jencode(jmodels.cas_register(), j) for j, _p in pairs]
    pencs = [pencode(pmodels.cas_register(), p) for _j, p in pairs]
    return jencs, pencs


@pytest.mark.parametrize("W,F", [(16, 16), (4, 4)])
@pytest.mark.parametrize("crash_p", [0.0, 0.15])
def test_check_slices_matches(crash_p, W, F):
    """Many tenants' (slice, start-state) rows in one launch, with the
    same Encoded object repeated (deduped into one packed segment)."""
    jencs, pencs = _tenants(crash_p)

    def slices(encs):
        out = [(e, s) for e in encs for s in range(min(e.n_states, 3))]
        return out + [(encs[1], 0), (encs[0], 2), (encs[1], 0)]

    ptel.reset()
    jout, junk = jwgl.check_slices(slices(jencs), W=W, F=F)
    pout, punk = pwgl.check_slices(slices(pencs), W=W, F=F, device="cpu")
    assert pout.dtype == np.uint32 and punk.dtype == bool
    np.testing.assert_array_equal(pout, jout)
    np.testing.assert_array_equal(punk, junk)
    c = ptel.get().counters()
    # one packed segment per distinct Encoded, one row per slice
    assert c["wgl.batch.histories"] == 4
    assert c["wgl.slices.rows"] == len(pout)
    assert c["wgl.slices.unknown-rows"] == int(punk.sum())
    if W == 4:
        assert punk.any()


def test_check_slices_empty_and_wide_states():
    out, unk = pwgl.check_slices([], device="cpu")
    assert out.shape == (0,) and unk.shape == (0,)

    class Wide:
        n_states = 33

    with pytest.raises(ValueError, match="uint32"):
        pwgl.check_slices([(Wide(), 0)], device="cpu")


@pytest.mark.parametrize("mode", ["one-shot", "chunk16", "chunk16-certify"])
def test_analysis_batch_matches(streamed_inputs, mode):
    jhs, phs = streamed_inputs
    jm, pm = jmodels.cas_register(), pmodels.cas_register()
    certify = mode.endswith("certify")
    if mode == "one-shot":
        want = jwgl.analysis_batch(jm, jhs)
        got = pwgl.analysis_batch(pm, phs, device="cpu")
    else:
        want = jwgl.analysis_batch_streamed(jm, jhs, chunk=16,
                                            certify=certify)
        ptel.reset()
        got = pwgl.analysis_batch_streamed(pm, phs, chunk=16,
                                           certify=certify, device="cpu")
        c = ptel.get().counters()
        assert c["wgl.kernel.launches"] == 3  # 16 + 16 + 8
        n_not_valid = sum(r["analyzer"] != "gpu" or r["valid?"] is not True
                          for r in got)
        assert c["wgl.host-resolved-rows"] == n_not_valid >= 1
    assert [r["valid?"] for r in got] == [r["valid?"] for r in want]
    assert got[7]["valid?"] is False
    assert all("degradation" not in r for r in got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _norm(g) == _norm(w), f"member {i}"
    if certify:
        for i in (0, 1, 7):
            pcertify.validate(phs[i], got[i]["certificate"])
            jcertify.validate(jhs[i], got[i]["certificate"])


def _layout_inputs():
    pairs = [_both(16 + 8 * i, 3, i, crash_p=0.1 * (i % 2))
             for i in range(6)]
    jpb = jwgl.PackedBatch([jencode(jmodels.cas_register(), j)
                            for j, _p in pairs])
    ppb = pwgl.PackedBatch([pencode(pmodels.cas_register(), p)
                            for _j, p in pairs])
    # segment 1 and 4 unreferenced, segment 3 repeated
    rows = [(0, 0), (3, 1), (2, 0), (3, 0), (5, 2), (3, 1), (0, 3)]
    return jpb, ppb, rows


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_shard_layout_matches(n_dev):
    jpb, ppb, rows = _layout_inputs()
    jl = jens.shard_layout(jpb, rows, n_dev)
    pl = pens.shard_layout(ppb, rows, n_dev)
    for name in ("inv_t", "ret_t", "trans", "mseg", "sufmin", "row_seg",
                 "st0", "inv_perm"):
        a, b = getattr(pl, name), getattr(jl, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (pl.n_dev, pl.n_rows, pl.device_entries) == \
        (jl.n_dev, jl.n_rows, jl.device_entries)


def test_one_device_layout_is_identity_over_used_segments():
    """The layout the card runs: used segments in ascending order,
    padded to a power of two, the sentinel at K_loc, inv_perm the
    identity."""
    _jpb, ppb, rows = _layout_inputs()
    lay = pens.shard_layout(ppb, rows, 1)
    used = [0, 2, 3, 5]
    np.testing.assert_array_equal(lay.mseg[:4], ppb.m[used])
    assert (lay.mseg[4:] == 0).all() and len(lay.mseg) == 4 + 1
    np.testing.assert_array_equal(lay.inv_perm[:len(rows)],
                                  np.arange(len(rows)))
    assert lay.row_seg[len(rows):].tolist() == [4]


def _sharded_encs():
    pairs = [_both(28, 3, 500 + i, corrupt_at=0.6 if i in (2, 7) else None)
             for i in range(10)]
    return ([jencode(jmodels.cas_register(), j) for j, _p in pairs],
            [pencode(pmodels.cas_register(), p) for _j, p in pairs])


def _segment_rows(wgl_mod, enc):
    """check_segmented's shape: every segment x every start state."""
    cuts = wgl_mod.segment_cuts(enc, target_len=32)
    segs = [enc.segment(cuts[k], cuts[k + 1])
            for k in range(len(cuts) - 1)]
    return segs, [(k, s) for k in range(len(segs))
                  for s in range(enc.n_states)]


@pytest.mark.parametrize("mesh", [1, 8])
def test_check_batch_sharded_matches(mesh):
    jencs, pencs = _sharded_encs()
    want = jens.check_batch_sharded(jencs, mesh=jens.default_mesh(mesh),
                                    W=16, F=16)
    got = pens.check_batch_sharded(pencs, devices="cpu", W=16, F=16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pwgl.check_batch(pencs, W=16, F=16,
                                                        device="cpu"))
    jh, ph = _both(220, 4, 77)
    jsegs, rows = _segment_rows(jwgl, jencode(jmodels.cas_register(), jh))
    psegs, prows = _segment_rows(pwgl, pencode(pmodels.cas_register(), ph))
    assert rows == prows and len(psegs) >= 2
    jout, junk = jens.check_batch_sharded(
        jsegs, mesh=jens.default_mesh(mesh), W=16, F=16, reach=True,
        rows=rows)
    pout, punk = pens.check_batch_sharded(psegs, devices="cpu", W=16, F=16,
                                          reach=True, rows=rows)
    np.testing.assert_array_equal(pout, jout)
    np.testing.assert_array_equal(punk, junk)


@pytest.mark.parametrize("reach", [False, True], ids=["verdict", "reach"])
def test_sharded_launch_stats_match_at_mesh_1(reach):
    """`it` and the level series of one launch, where JAX's layout is the
    port's (one device)."""
    jpb, ppb, rows = _layout_inputs()
    jout = jens.sharded_launch(jpb, rows, 16, 16, reach=reach,
                               mesh=jens.default_mesh(1))
    jres = jwgl._drain(jout, reach=reach)
    pout = pens.sharded_launch(ppb, rows, 16, 16, reach=reach,
                               devices="cpu")
    n_res = 2 if reach else 1
    for a, b in zip(pout.outs[n_res:], jout[n_res:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pres = pwgl._drain(pout, reach=reach)
    for a, b in zip(pres if reach else (pres,), jres if reach else (jres,)):
        np.testing.assert_array_equal(a, np.asarray(b)[:len(rows)])
        assert len(a) == len(rows)


@pytest.mark.parametrize("mesh", [1, 8])
def test_analysis_batch_sharded_matches(mesh):
    pairs = [_both(24, 3, 400 + i, crash_p=0.1 * (i % 2),
                   corrupt_at=0.5 if i == 2 else None) for i in range(8)]
    want = jens.analysis_batch_sharded(
        jmodels.cas_register(), [j for j, _p in pairs],
        mesh=jens.default_mesh(mesh), W=16, F=32)
    ptel.reset()
    got = pens.analysis_batch_sharded(
        pmodels.cas_register(), [p for _j, p in pairs], devices="cpu",
        W=16, F=32)
    assert [r["valid?"] for r in got] == [i != 2 for i in range(8)]
    assert _norm(got) == _norm(want)
    assert got[2]["analyzer"] == "gpu-sharded"
    assert got[2]["op"] is not None
    c = ptel.get().counters()
    assert (c["wgl.spmd.launches"], c["wgl.ensemble.launches"],
            c["wgl.kernel.launches"]) == (1, 1, 1)
    assert ptel.get().gauges()["wgl.spmd.devices"] == 1


def test_more_than_one_device_is_not_ported():
    _jencs, pencs = _sharded_encs()
    with pytest.raises(NotImplementedError, match="A6"):
        pens.check_batch_sharded(pencs, devices=["cpu", "cpu"])
    assert pens.one_device(["cpu"]) == torch.device("cpu")


def test_extract_witness_matches():
    jh, ph = _both(40, 3, 5, corrupt_at=0.5)
    want = jwgl.extract_witness(jencode(jmodels.cas_register(), jh))
    got = pwgl.extract_witness(pencode(pmodels.cas_register(), ph),
                               device="cpu")
    assert got["witness-extraction"] == "host"
    assert _norm(got) == _norm(want)


def test_extract_witness_segments_long_histories():
    jh, ph = _both(5400, 4, 9, corrupt_at=0.7)
    jenc = jencode(jmodels.cas_register(), jh)
    penc = pencode(pmodels.cas_register(), ph)
    assert penc.m >= pwgl.SEGMENT_MIN_M
    want = jwgl.extract_witness(jenc, W=16, F=32)
    got = pwgl.extract_witness(penc, W=16, F=32, device="cpu")
    assert got["witness-extraction"] == "segmented"
    assert got["valid?"] is False
    assert _norm(got) == _norm(want)
