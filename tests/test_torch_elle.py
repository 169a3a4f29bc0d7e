"""Parity of the port's elle path (gpu/elle.py, gpu/elle_device.py, the
elle half of gpu/certify.py, checker/cycle.py, native/) with the JAX
package's.

The same seeded histories, built op for op in both packages, go through
`jepsen_tpu.tpu.elle.check_list_append` / `check_rw_register` and the
port's, under the engines host, device and auto (the port's device
engine runs the SCC kernel's plain version: device="cpu"). The whole
result dicts must be equal, with witness ops compared by to_dict(), and
every certificate the port produces must pass both packages'
validators.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import cycle as jcycle
from jepsen_tpu.history import History as JHistory, op as jop
from jepsen_tpu.tpu import certify as jcertify
from jepsen_tpu.tpu import elle as jelle
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu_torch import native, telemetry
from jepsen_tpu_torch.checker import cycle as pcycle
from jepsen_tpu_torch.gpu import certify as pcertify
from jepsen_tpu_torch.gpu import elle as pelle
from jepsen_tpu_torch.gpu import elle_device as pdev
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.history import History as PHistory, op as pop

torch.set_num_threads(1)

CPU = {"device": "cpu"}


def both(events):
    """(JAX history, port history) of (type, process, mops) events."""
    return (JHistory([jop(type=t, process=p, f="txn", value=m)
                      for t, p, m in events]),
            PHistory([pop(type=t, process=p, f="txn", value=m)
                      for t, p, m in events]))


def norm(x):
    """A result tree with every op replaced by its to_dict()."""
    if hasattr(x, "to_dict") and not isinstance(x, dict):
        return {"op": norm(x.to_dict())}
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def assert_same(jh, ph, family, engine, certify=True):
    check_j = (jelle.check_list_append if family == "list-append"
               else jelle.check_rw_register)
    check_p = (pelle.check_list_append if family == "list-append"
               else pelle.check_rw_register)
    want = check_j(jh, {"engine": engine, "certify": certify})
    got = check_p(ph, {"engine": engine, "certify": certify, **CPU})
    assert norm(got) == norm(want)
    if certify:
        cert = got["certificate"]
        if "absent" not in cert:
            pcertify.validate(ph, cert)
            jcertify.validate(jh, cert)
    return got


FIXTURES = {
    "valid_seq": [
        ("invoke", 0, [["append", "x", 1]]), ("ok", 0, [["append", "x", 1]]),
        ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", [1]]]),
        ("invoke", 0, [["append", "x", 2]]), ("ok", 0, [["append", "x", 2]]),
        ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", [1, 2]]])],
    "g0": [("invoke", 0, [["append", "x", 1], ["append", "y", 1]]),
           ("invoke", 1, [["append", "x", 2], ["append", "y", 2]]),
           ("ok", 0, [["append", "x", 1], ["append", "y", 1]]),
           ("ok", 1, [["append", "x", 2], ["append", "y", 2]]),
           ("invoke", 2, [["r", "x", None], ["r", "y", None]]),
           ("ok", 2, [["r", "x", [1, 2]], ["r", "y", [2, 1]]])],
    "g1a": [("invoke", 0, [["append", "x", 9]]),
            ("fail", 0, [["append", "x", 9]]),
            ("invoke", 1, [["r", "x", None]]),
            ("ok", 1, [["r", "x", [9]]])],
    "g1b": [("invoke", 0, [["append", "x", 1], ["append", "x", 2]]),
            ("ok", 0, [["append", "x", 1], ["append", "x", 2]]),
            ("invoke", 1, [["r", "x", None]]),
            ("ok", 1, [["r", "x", [1]]])],
    "g1c": [("invoke", 0, [["append", "x", 1], ["r", "y", None]]),
            ("invoke", 1, [["append", "y", 1], ["r", "x", None]]),
            ("ok", 0, [["append", "x", 1], ["r", "y", [1]]]),
            ("ok", 1, [["append", "y", 1], ["r", "x", [1]]])],
    "g_single": [("invoke", 0, [["r", "x", None], ["r", "y", None]]),
                 ("invoke", 1, [["append", "y", 1], ["append", "x", 1]]),
                 ("ok", 1, [["append", "y", 1], ["append", "x", 1]]),
                 ("ok", 0, [["r", "x", []], ["r", "y", [1]]]),
                 ("invoke", 2, [["r", "x", None]]),
                 ("ok", 2, [["r", "x", [1]]])],
    "g2": [("invoke", 0, [["r", "x", None], ["append", "y", 1]]),
           ("invoke", 1, [["r", "y", None], ["append", "x", 1]]),
           ("ok", 0, [["r", "x", []], ["append", "y", 1]]),
           ("ok", 1, [["r", "y", []], ["append", "x", 1]]),
           ("invoke", 2, [["r", "x", None], ["r", "y", None]]),
           ("ok", 2, [["r", "x", [1]], ["r", "y", [1]]])],
    "incompat": [("invoke", 0, [["r", "x", None]]),
                 ("ok", 0, [["r", "x", [1, 2]]]),
                 ("invoke", 1, [["r", "x", None]]),
                 ("ok", 1, [["r", "x", [2, 1, 3]]])],
    "internal": [("invoke", 0, [["append", "x", 5], ["r", "x", None]]),
                 ("ok", 0, [["append", "x", 5], ["r", "x", [1]]])],
    "dup": [("invoke", 0, [["append", "x", 1]]),
            ("ok", 0, [["append", "x", 1]]),
            ("invoke", 1, [["append", "x", 1]]),
            ("ok", 1, [["append", "x", 1]])],
    "retry_after_fail": [
        ("invoke", 0, [["append", "x", 1]]), ("fail", 0, [["append", "x", 1]]),
        ("invoke", 0, [["append", "x", 1]]), ("ok", 0, [["append", "x", 1]]),
        ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", [1]]])],
    "info_observed": [
        ("invoke", 0, [["append", "x", 1]]), ("info", 0, [["append", "x", 1]]),
        ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", [1]]])],
    "empty_read_info": [
        ("invoke", 0, [["append", "k", 1]]), ("info", 0, [["append", "k", 1]]),
        ("invoke", 1, [["r", "k", None]]), ("ok", 1, [["r", "k", [1]]]),
        ("invoke", 2, [["r", "k", None]]), ("ok", 2, [["r", "k", []]])],
    "rt_beyond": [
        ("invoke", 1, [["append", "z", 1]]), ("invoke", 0, [["append", "y", 1]]),
        ("ok", 0, [["append", "y", 1]]), ("ok", 1, [["append", "z", 1]]),
        ("invoke", 2, [["r", "y", None]]), ("ok", 2, [["r", "y", []]])],
    "unobservable_last": [
        ("invoke", 0, [["append", "x", 1]]), ("ok", 0, [["append", "x", 1]]),
        ("invoke", 1, [["append", "x", 2]]), ("ok", 1, [["append", "x", 2]]),
        ("invoke", 2, [["r", "x", None]]),
        ("ok", 2, [["r", "x", [1, 999, 2]]]),
        ("invoke", 3, [["r", "x", None]]),
        ("ok", 3, [["r", "x", [1, 999]]])],
    "empty": [],
    "no_appends": [("invoke", 0, [["r", "x", None]]),
                   ("ok", 0, [["r", "x", []]])],
}

RW_FIXTURES = {
    "valid": [("invoke", 0, [["w", "x", 1]]), ("ok", 0, [["w", "x", 1]]),
              ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", 1]])],
    "g1c": [("invoke", 0, [["w", "x", 1], ["r", "y", None]]),
            ("invoke", 1, [["w", "y", 2], ["r", "x", None]]),
            ("ok", 0, [["w", "x", 1], ["r", "y", 2]]),
            ("ok", 1, [["w", "y", 2], ["r", "x", 1]])],
    "none_first_read": [
        ("invoke", 0, [["w", "x", 1]]), ("ok", 0, [["w", "x", 1]]),
        ("invoke", 1, [["w", "x", 2]]), ("ok", 1, [["w", "x", 2]]),
        ("invoke", 2, [["r", "x", None], ["r", "x", None]]),
        ("ok", 2, [["r", "x", None], ["r", "x", 1]]),
        ("invoke", 3, [["r", "x", None], ["w", "x", 3]]),
        ("ok", 3, [["r", "x", 1], ["w", "x", 3]])],
    "g1a_g1b_internal": [
        ("invoke", 0, [["w", "x", 7]]), ("fail", 0, [["w", "x", 7]]),
        ("invoke", 1, [["w", "y", 1], ["w", "y", 2]]),
        ("ok", 1, [["w", "y", 1], ["w", "y", 2]]),
        ("invoke", 2, [["r", "x", None], ["r", "y", None],
                       ["w", "z", 5], ["r", "z", None]]),
        ("ok", 2, [["r", "x", 7], ["r", "y", 1], ["w", "z", 5],
                   ["r", "z", 6]])],
    "dup_writes": [("invoke", 0, [["w", "x", 1]]), ("ok", 0, [["w", "x", 1]]),
                   ("invoke", 1, [["w", "x", 1]]), ("ok", 1, [["w", "x", 1]])],
    "string_values": [
        ("invoke", 0, [["w", "x", "a"]]), ("ok", 0, [["w", "x", "a"]]),
        ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", "a"]])],
}

ENGINES = ["host", "device", "auto"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_list_append_fixture_matches_jax(name, engine):
    assert_same(*both(FIXTURES[name]), "list-append", engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(RW_FIXTURES))
def test_rw_register_fixture_matches_jax(name, engine):
    assert_same(*both(RW_FIXTURES[name]), "rw-register", engine)


def gen_events(rng, n_txns, n_keys=8, max_len=4, rotate=24):
    """Concurrent valid-by-construction list-append events with
    ok/fail/info completions and key rotation (the generator of
    tests/test_elle_device.py)."""
    store = {}
    epoch = 0
    events = []
    open_t = {}
    t_count = 0
    nv = 1
    while t_count < n_txns or open_t:
        idle = [p for p in range(5) if p not in open_t]
        if t_count < n_txns and idle and (rng.random() < 0.6
                                          or not open_t):
            p = rng.choice(idle)
            txn = []
            for _ in range(rng.randint(1, max_len)):
                k = f"k{rng.randrange(n_keys)}e{epoch}"
                if rng.random() < 0.5:
                    txn.append(["append", k, nv])
                    nv += 1
                else:
                    txn.append(["r", k, None])
            events.append(("invoke", p, txn))
            open_t[p] = txn
            t_count += 1
            if t_count % rotate == 0:
                epoch += 1
        else:
            p = rng.choice(list(open_t))
            txn = open_t.pop(p)
            r = rng.random()
            if r < 0.85:
                res = []
                for f, k, v in txn:
                    if f == "append":
                        store.setdefault(k, []).append(v)
                        res.append(["append", k, v])
                    else:
                        res.append(["r", k, list(store.get(k, []))])
                events.append(("ok", p, res))
            elif r < 0.95:
                events.append(("fail", p, txn))
            else:
                if rng.random() < 0.5:
                    for f, k, v in txn:
                        if f == "append":
                            store.setdefault(k, []).append(v)
                events.append(("info", p, txn))
    return events


def corrupt_events(rng, events):
    """Damage one committed read (drop, swap, phantom or truncate)."""
    events = [(t, p, [list(m) for m in v]) for t, p, v in events]
    mode = rng.choice(["drop_elem", "swap", "phantom", "truncate"])
    oks = [i for i, (t, _p, v) in enumerate(events)
           if t == "ok" and any(m[0] == "r" and m[2] for m in v)]
    if not oks:
        return events
    i = rng.choice(oks)
    for m in events[i][2]:
        if m[0] == "r" and m[2]:
            lst = list(m[2])
            if mode == "drop_elem" and len(lst) > 1:
                del lst[rng.randrange(len(lst) - 1)]
            elif mode == "swap" and len(lst) > 1:
                a, b = rng.sample(range(len(lst)), 2)
                lst[a], lst[b] = lst[b], lst[a]
            elif mode == "phantom":
                lst.append(999999999)
            elif mode == "truncate" and len(lst) > 1:
                lst = lst[:-1]
            m[2] = lst
            break
    return events


@pytest.mark.parametrize("trial", range(12))
def test_random_list_append_matches_jax(trial):
    rng = random.Random(100 + trial)
    events = gen_events(rng, rng.choice([20, 60, 150]))
    if trial % 2:
        events = corrupt_events(rng, events)
    jh, ph = both(events)
    for engine in ("host", "device"):
        assert_same(jh, ph, "list-append", engine)


@pytest.mark.parametrize("corrupted", [False, True], ids=["valid", "bad"])
def test_list_append_auto_takes_device_and_matches_jax(corrupted):
    """>= 4000 ops: auto picks the device engine in both packages, and
    past DEVICE_MIN_EDGES the SCC runs the kernel's plain version."""
    jh = jsynth.list_append_history(4000, seed=5)
    ph = psynth.list_append_history(4000, seed=5)
    if corrupted:
        ph = psynth.corrupt_list_append_history(ph, at_frac=0.6)[0]
        jh = JHistory([jop(**o.to_dict()) for o in ph],
                      assign_indices=False)
    assert len(ph) >= pelle._DEVICE_MIN_OPS
    telemetry.reset()
    got = assert_same(jh, ph, "list-append", "auto")
    counters = telemetry.get().counters()
    assert counters.get("elle.txns") == 4000
    assert counters.get("scc.path.device", 0) >= 1
    assert got["valid?"] is (not corrupted)
    if corrupted:
        assert "incompatible-order" in got["anomaly-types"]
        assert "cycle" in got["certificate"]


@pytest.mark.parametrize("n,seed", [(400, 9), (4000, 17)])
def test_rw_register_generated_matches_jax(n, seed):
    jh = jsynth.rw_register_history(n, seed=seed)
    ph = psynth.rw_register_history(n, seed=seed)
    for engine in ENGINES:
        got = assert_same(jh, ph, "rw-register", engine)
        assert got["valid?"] is True


def test_unvectorizable_append_values():
    jh, ph = both([("invoke", 0, [["append", "x", "s"]]),
                   ("ok", 0, [["append", "x", "s"]]),
                   ("invoke", 1, [["r", "x", None]]),
                   ("ok", 1, [["r", "x", ["s"]]])])
    assert_same(jh, ph, "list-append", "auto")
    with pytest.raises(pdev.Unvectorizable):
        pelle.check_list_append(ph, {"engine": "device", **CPU})


@pytest.mark.parametrize("family", ["list-append", "rw-register"])
def test_python_flattening_matches_native(monkeypatch, family):
    """The C flattener and its Python fallback give the same result."""
    rng = random.Random(3)
    if family == "list-append":
        ph = both(corrupt_events(rng, gen_events(rng, 300)))[1]
        check = pelle.check_list_append
    else:
        ph = psynth.rw_register_history(300, seed=4)
        check = pelle.check_rw_register
    opts = {"engine": "device", "certify": True, **CPU}
    fast = check(ph, opts)

    def unavailable(*a, **k):
        raise RuntimeError("native elleflat unavailable")

    monkeypatch.setattr(native, "elle_flatten", unavailable)
    monkeypatch.setattr(native, "realtime_edges", unavailable)
    telemetry.reset()
    assert norm(check(ph, opts)) == norm(fast)
    assert telemetry.get().counters().get("elle.flatten.python") == 1


@pytest.mark.parametrize("family", ["list-append", "rw-register",
                                    "rw-register-unvectorizable"])
def test_out_of_memory_raises(monkeypatch, family):
    """An out-of-memory error of the card is not sent to the host
    engine: it raises out of the check (engine="host" is the caller's
    way to the host). The unvectorizable rw-register history infers its
    edges on the host and still solves its SCCs on the device."""
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    if family == "list-append":
        ph = psynth.list_append_history(200, seed=2)
        monkeypatch.setattr(pdev, "check_list_append_device", oom)
        check = pelle.check_list_append
    else:
        ph = psynth.rw_register_history(200, seed=2)
        if family.endswith("unvectorizable"):
            def unvectorizable(*a, **k):
                raise pdev.Unvectorizable("string values")

            monkeypatch.setattr(pdev, "check_rw_register_device",
                                unvectorizable)
            monkeypatch.setattr(pdev, "cycle_anomalies_arrays", oom)
        else:
            monkeypatch.setattr(pdev, "check_rw_register_device", oom)
        check = pelle.check_rw_register
    with pytest.raises(torch.cuda.OutOfMemoryError):
        check(ph, {"engine": "device", **CPU})
    assert check(ph, {"engine": "host"})["valid?"] is True


def test_other_device_errors_raise(monkeypatch):
    """No hidden fallback: an error of the card raises."""
    ph = psynth.list_append_history(200, seed=2)

    def broken(*a, **k):
        raise RuntimeError("scc launch failed: CUDA error 700")

    monkeypatch.setattr(pdev, "check_list_append_device", broken)
    with pytest.raises(RuntimeError, match="scc launch failed"):
        pelle.check_list_append(ph, {"engine": "device", **CPU})
    monkeypatch.setattr(pdev, "check_rw_register_device", broken)
    with pytest.raises(RuntimeError, match="scc launch failed"):
        pelle.check_rw_register(psynth.rw_register_history(50, seed=1),
                                {"engine": "device", **CPU})


@pytest.mark.parametrize("family", ["list-append", "rw-register"])
def test_checkers_match_jax_and_certify(family):
    if family == "list-append":
        jh = jsynth.list_append_history(300, seed=8)
        ph = psynth.list_append_history(300, seed=8)
        jc, pc = jcycle.append_checker(), pcycle.append_checker(CPU)
    else:
        jh = jsynth.rw_register_history(300, seed=8)
        ph = psynth.rw_register_history(300, seed=8)
        jc, pc = jcycle.wr_checker(), pcycle.wr_checker(CPU)
    want = jc.check({}, jh)
    got = pc.check({}, ph)
    assert norm(got) == norm(want)
    assert got["valid?"] is True
    pcertify.validate(ph, got["certificate"])
    jcertify.validate(jh, got["certificate"])
    # the validator is not fooled by a forged order
    forged = dict(got["certificate"])
    forged["topo-order"] = list(reversed(forged["topo-order"]))
    with pytest.raises(pcertify.CertificateError):
        pcertify.validate(ph, forged)


def test_invalid_certificates_validate_in_both():
    for name in ("g0", "g1a", "g1c", "g2", "g_single", "dup"):
        jh, ph = both(FIXTURES[name])
        got = pelle.check_list_append(ph, {"engine": "device",
                                           "certify": True, **CPU})
        cert = got["certificate"]
        assert got["valid?"] is False and "absent" not in cert, name
        pcertify.validate(ph, cert)
        jcertify.validate(jh, cert)
        bad = dict(cert, history=pcertify.history_digest(
            both(FIXTURES["valid_seq"])[1]))
        with pytest.raises(pcertify.CertificateError):
            pcertify.validate(ph, bad)


@pytest.mark.parametrize("gen", ["append_gen", "wr_gen"])
def test_generators_match_jax(gen):
    j = getattr(jcycle, gen)(key_count=4, max_writes_per_key=6, seed=3)
    p = getattr(pcycle, gen)(key_count=4, max_writes_per_key=6, seed=3)
    for _ in range(300):
        assert next(p) == next(j)


@pytest.mark.parametrize("name,kw", [
    ("list_append_history", {"n_txns": 500, "seed": 11}),
    ("rw_register_history", {"n_txns": 500, "seed": 17}),
    ("bank_history", {"n_txns": 500, "n_accounts": 32, "seed": 11}),
    ("bank_history", {"n_txns": 500, "seed": 3}),
])
def test_synth_generators_match_jax(name, kw):
    j = getattr(jsynth, name)(**kw)
    p = getattr(psynth, name)(**kw)
    assert [o.to_dict() for o in p] == [o.to_dict() for o in j]


def test_corrupt_list_append_history_swaps_one_read():
    h = psynth.list_append_history(400, seed=11)
    bad, i = psynth.corrupt_list_append_history(h, at_frac=0.85)
    assert i >= int(0.85 * len(h))
    diff = [k for k in range(len(h)) if h[k].value != bad[k].value]
    assert diff == [i]
    got = assert_same(
        JHistory([jop(**o.to_dict()) for o in bad], assign_indices=False),
        bad, "list-append", "device")
    assert "incompatible-order" in got["anomaly-types"]


def test_order_edges_match_jax():
    rng = np.random.default_rng(1)
    inv = np.sort(rng.integers(0, 10_000, 500))
    comp = inv + rng.integers(1, 300, 500)
    ids = np.arange(500) * 3
    proc = rng.integers(0, 7, 500)
    for a, b in zip(pelle.order_edges_from_arrays(ids, inv, comp, proc),
                    jelle.order_edges_from_arrays(ids, inv, comp, proc)):
        np.testing.assert_array_equal(a, b)
