"""Parity of the port's independent-key checker and Linearizable.check_batch
with the JAX package's on the CPU, and the rule that nothing on the
batch path steps down from the device: a launch or drain failure raises
out of every batch entry point.

Multi-key histories fold seeded single-key register histories: values
become (key, value), process ids become disjoint per key, and ops merge
by (per-key time, key) with index and time renumbered. Certificates must
carry their key and the whole history's digest, and pass both
packages' validators."""

import numpy as np
import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import op as jop
from jepsen_tpu.tpu import certify as jcertify
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu_torch import checker as pchecker
from jepsen_tpu_torch import independent as pind
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch import util as putil
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.gpu import certify as pcertify
from jepsen_tpu_torch.gpu import ensemble as pens
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu import wgl as pwgl
from jepsen_tpu_torch.gpu.encode import encode as pencode
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import op as pop

torch.set_num_threads(1)

RENAME = {"tpu": "gpu", "tpu-sharded": "gpu-sharded",
          "tpu+host-fallback": "gpu+host-fallback"}


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


def fold_keys(hists, History, op):
    """One multi-key history out of single-key ones (key k = hists[k])."""
    events = sorted(((o.time, k, o) for k, h in enumerate(hists)
                     for o in h), key=lambda e: (e[0], e[1]))
    return History([op(index=i, time=i, type=o.type,
                       process=k * 1000 + o.process, f=o.f,
                       value=(k, o.value))
                    for i, (_t, k, o) in enumerate(events)],
                   assign_indices=False)


def _keyed(n_keys, n_ops, crash_p=0.0, bad=()):
    """(jax history, port history): n_keys folded register histories,
    the keys in `bad` corrupted."""
    js, ps = [], []
    for k in range(n_keys):
        kw = dict(n_ops=n_ops, n_procs=3, seed=300 + k, crash_p=crash_p)
        jh, ph = jsynth.register_history(**kw), psynth.register_history(**kw)
        if k in bad:
            jh = jsynth.corrupt_register_history(jh, at_frac=0.5)[0]
            ph = psynth.corrupt_register_history(ph, at_frac=0.5)[0]
        js.append(jh)
        ps.append(ph)
    return fold_keys(js, JHistory, jop), fold_keys(ps, PHistory, pop)


def test_subhistories_match():
    jh, ph = _keyed(4, 24, crash_p=0.1)
    js, ps = jind.subhistories(jh), pind.subhistories(ph)
    assert sorted(js) == sorted(ps) == [0, 1, 2, 3]
    for k in js:
        assert [o.to_dict() for o in ps[k]] == [o.to_dict() for o in js[k]]
    # ops keep the whole history's indices
    assert ps[2][0].index == next(o.index for o in ph if o.value[0] == 2)


@pytest.mark.parametrize("crash_p,bad", [(0.0, ()), (0.0, (1, 4)),
                                         (0.1, (3,))],
                         ids=["valid", "two-bad-keys", "crashed-bad-key"])
def test_independent_checker_matches(crash_p, bad):
    jh, ph = _keyed(6, 30, crash_p=crash_p, bad=bad)
    want = jind.checker(jchecker.linearizable(
        {"model": jmodels.cas_register()})).check({}, jh)
    ptel.reset()
    got = pind.checker(pchecker.linearizable(
        {"model": pmodels.cas_register(), "device": "cpu"})).check({}, ph)
    assert got["valid?"] is (not bad)
    assert got["failures"] == want["failures"] == list(bad)
    assert _norm(got) == _norm(want)
    c = ptel.get().counters()
    assert c["wgl.kernel.launches"] == 1  # every key in one launch
    assert c.get("certify.extracted", 0) + c.get("certify.absent", 0) == 6
    digest = pcertify.history_digest(ph)
    for k, r in got["results"].items():
        assert isinstance(r["valid?"], bool) and "error" not in r
        cert = r["certificate"]
        assert cert["key"] == k and cert["history"] == digest
        pcertify.validate(ph, cert)
        jcertify.validate(jh, cert)


@pytest.mark.parametrize("algorithm", ["gpu", "wgl"])
def test_linearizable_check_batch_matches(algorithm):
    pairs = []
    for i in range(6):
        kw = dict(n_ops=30, n_procs=3, seed=40 + i,
                  crash_p=0.1 if i % 2 else 0.0)
        jh, ph = jsynth.register_history(**kw), psynth.register_history(**kw)
        if i == 2:
            jh = jsynth.corrupt_register_history(jh, at_frac=0.5)[0]
            ph = psynth.corrupt_register_history(ph, at_frac=0.5)[0]
        pairs.append((jh, ph))
    jalg = {"gpu": "tpu"}.get(algorithm, algorithm)
    want = jchecker.linearizable({"model": jmodels.cas_register(),
                                  "algorithm": jalg}).check_batch(
        {}, [j for j, _p in pairs])
    got = pchecker.linearizable({"model": pmodels.cas_register(),
                                 "algorithm": algorithm,
                                 "device": "cpu"}).check_batch(
        {}, [p for _j, p in pairs])
    assert [r["valid?"] for r in got] == [i != 2 for i in range(6)]
    assert _norm(got) == _norm(want)
    assert got[2]["anomaly-classes"] == {"nonlinearizable": "witnessed"}
    for (_j, p), r in zip(pairs, got):
        pcertify.validate(p, r["certificate"])


def test_inner_without_check_batch_runs_per_key_check_safe():
    """A sub-checker with no batch form runs once per key; an exception
    in one key's check is that key's 'unknown', as in the reference."""
    jh, ph = _keyed(3, 12)

    def make(chk_mod):
        def run(test, hist, opts):
            if any(o.process >= 2000 for o in hist):
                raise RuntimeError("key 2 is broken")
            return {"valid?": True, "n": len(hist)}
        return chk_mod._Fn(run)

    want = jind.checker(make(jchecker)).check({}, jh)
    got = pind.checker(make(pchecker)).check({}, ph)
    assert got["valid?"] == want["valid?"] == "unknown"
    assert got["failures"] == want["failures"] == []
    for k in (0, 1):
        assert got["results"][k] == want["results"][k]
    assert "key 2 is broken" in got["results"][2]["error"]


def test_merge_valid_and_bounded_pmap():
    assert pchecker.merge_valid([True, "unknown", True]) == "unknown"
    assert pchecker.merge_valid([True, "unknown", False]) is False
    assert pchecker.merge_valid([]) is True
    assert putil.bounded_pmap(lambda x: x * x, range(20), limit=3) == \
        [x * x for x in range(20)]
    assert putil.bounded_pmap(len, []) == []


# ---------------------------------------------------------------------------
# nothing steps down from the device
# ---------------------------------------------------------------------------

def _boom(*_a, **_k):
    raise RuntimeError("wgl_search launch failed: CUDA error 2")


def test_launch_failure_raises_from_every_batch_entry_point(monkeypatch):
    monkeypatch.setattr(pwgl, "_launch", _boom)
    m = pmodels.cas_register()
    hists = [psynth.register_history(20, n_procs=3, seed=i)
             for i in range(4)]
    enc = pencode(m, hists[0])
    _jh, multi = _keyed(3, 12)
    lin = pchecker.linearizable({"model": m, "device": "cpu"})
    for fn in (lambda: pwgl.analysis_batch_streamed(m, hists, chunk=2,
                                                    device="cpu"),
               lambda: pwgl.analysis_batch(m, hists, device="cpu"),
               lambda: pwgl.check_slices([(enc, 0), (enc, 1)],
                                         device="cpu"),
               lambda: lin.check_batch({}, hists),
               lambda: pind.checker(lin).check({}, multi)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn()


def test_drain_and_sharded_failures_raise(monkeypatch):
    m = pmodels.cas_register()
    hists = [psynth.register_history(20, n_procs=3, seed=i)
             for i in range(4)]
    monkeypatch.setattr(pwgl, "_run", _boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        pens.analysis_batch_sharded(m, hists, mesh="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(pwgl, "_drain", _boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        pwgl.analysis_batch_streamed(m, hists, chunk=2, device="cpu")
