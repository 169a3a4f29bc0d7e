"""The whole slice across packages: each workload run clusterless on one
package's interpreter, at a small size with "device": "cpu", and the
history it recorded checked by both packages' checkers (converted through
dicts for the other package). Verdicts, failures and anomaly types must
be equal: exact comparisons of integers, strings and verdicts.

Each workload runs valid and with a client at fault (its twin: the
register's stale reads, the bank's wrong total, the transactions' reads
from a snapshot), the lock workload valid. The faulty clients are
chip_smoke.py's phase-20 fixtures, so the CPU holds them to the verdicts
phase 20 asks of them on the card.
"""

from __future__ import annotations

import pytest

import chip_smoke as cs
from jepsen_tpu import generator as jgen
from jepsen_tpu import interpreter as jinterp
from jepsen_tpu import testing as jtesting
from jepsen_tpu import util as jutil
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.workloads import bank as jbank
from jepsen_tpu.workloads import lock as jlock
from jepsen_tpu.workloads import register as jregister
from jepsen_tpu.workloads import txn_append as jappend
from jepsen_tpu.workloads import txn_wr as jwr
from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch import interpreter as pinterp
from jepsen_tpu_torch import testing as ptesting
from jepsen_tpu_torch import util as putil
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.workloads import bank as pbank
from jepsen_tpu_torch.workloads import lock as plock
from jepsen_tpu_torch.workloads import register as pregister
from jepsen_tpu_torch.workloads import txn_append as pappend
from jepsen_tpu_torch.workloads import txn_wr as pwr

JAX = {"gen": jgen, "interp": jinterp, "testing": jtesting, "util": jutil,
       "History": JHistory, "register": jregister, "bank": jbank,
       "append": jappend, "wr": jwr, "lock": jlock}
PORT = {"gen": pgen, "interp": pinterp, "testing": ptesting, "util": putil,
        "History": PHistory, "register": pregister, "bank": pbank,
        "append": pappend, "wr": pwr, "lock": plock}

REG = {"keys": list(range(6)), "group-size": 3, "ops_per_key": 50,
       "seed": 8}
BANK = {"accounts": list(range(5)), "ops": 300, "seed": 11}
TXN = {"ops": 300, "seed": 9}
BAD_KEY = 2


def _kv(pkg, twin):
    if twin:
        return cs.StaleReadKVClient(ptesting.KVState(), BAD_KEY, every=1,
                                    latency_s=0.0002)
    return pkg["testing"].KVClient(pkg["testing"].KVState())


def _bank(pkg, twin):
    return pkg["testing"].BankClient(pkg["testing"].BankState(
        BANK["accounts"], initial=11 if twin else 10))


def _txn(pkg, twin):
    return (cs.SnapshotTxnClient(every=4) if twin
            else pkg["testing"].TxnClient())


# name: (workload key, constructor, opts, client, concurrency)
RUNS = {
    "register": ("register", "workload", REG, _kv, 6),
    "bank": ("bank", "workload", BANK, _bank, 5),
    "txn-append": ("append", "workload", TXN, _txn, 4),
    "txn-wr": ("wr", "workload", TXN, _txn, 4),
    "fenced-lock": ("lock", "fenced_lock_workload", {"ops": 120},
                    lambda pkg, twin: pkg["testing"].LockClient(), 4),
}


def workload(pkg, name: str):
    key, ctor, opts, _client, _conc = RUNS[name]
    return getattr(pkg[key], ctor)(dict(opts, device="cpu"))


def run_on(pkg, name: str, twin: bool):
    """The workload on pkg's interpreter with worker threads."""
    _key, _ctor, _opts, client, conc = RUNS[name]
    w = workload(pkg, name)
    test = pkg["testing"].noop_test()
    test.update(concurrency=conc, client=client(pkg, twin),
                generator=pkg["gen"].clients(w["generator"]))
    for k, v in w.items():
        if k not in ("generator", "checker"):
            test[k] = v
    with pkg["util"].with_relative_time():
        return pkg["interp"].run(test)


def verdicts(res) -> dict:
    """The verdict, failures, anomaly types and bank errors, wherever they
    sit in a result tree."""
    out = {}

    def walk(x, where):
        if isinstance(x, dict):
            for k, v in x.items():
                if k in ("valid?", "failures", "anomaly-types",
                         "error-count", "read-count"):
                    out[f"{where}/{k}"] = v
                elif k == "first-error" and isinstance(v, dict):
                    out[f"{where}/first-error"] = (v.get("type"),
                                                   v.get("found"))
                else:
                    walk(v, f"{where}/{k}")

    walk(res, "")
    return out


def check_both(name: str, test: dict) -> tuple[dict, dict]:
    """The recorded history through both packages' checkers: each gets
    its own package's ops, rebuilt from the other's through dicts."""
    dicts = [o.to_dict() for o in test["history"]]
    out = []
    for pkg in (PORT, JAX):
        hist = pkg["History"](dicts, assign_indices=False)
        t = {k: v for k, v in test.items() if k not in ("history",)}
        out.append(verdicts(workload(pkg, name)["checker"].check(t, hist)))
    return out[0], out[1]


TWINS = ("register", "bank", "txn-append", "txn-wr")
PORT_CASES = [(n, False) for n in sorted(RUNS)] + [(n, True) for n in TWINS]
# the faulty fixtures are port clients; the JAX package's own fixtures
# give the bank twin
JAX_CASES = [(n, False) for n in sorted(RUNS)] + [("bank", True)]


def _id(case) -> str:
    return f"{case[0]}-{'twin' if case[1] else 'valid'}"


@pytest.mark.parametrize("name,twin", PORT_CASES,
                         ids=[_id(c) for c in PORT_CASES])
def test_port_run_checked_by_both(name, twin):
    test = run_on(PORT, name, twin)
    hist = test["history"]
    assert len(hist) == 2 * sum(1 for o in hist if o.type == "invoke")
    port, jax = check_both(name, test)
    assert port == jax
    assert port["/valid?"] is (not twin)
    if twin and name == "register":
        assert cs.forced_stale_reads(hist, BAD_KEY) >= 1
        assert BAD_KEY in port["/failures"]
    if twin and name == "bank":
        assert port["/bank/first-error"][0] == "wrong-total"
    if twin and name.startswith("txn"):
        assert port["/anomaly-types"]


@pytest.mark.parametrize("name,twin", JAX_CASES,
                         ids=[_id(c) for c in JAX_CASES])
def test_jax_run_checked_by_both(name, twin):
    test = run_on(JAX, name, twin)
    port, jax = check_both(name, test)
    assert port == jax
    assert port["/valid?"] is (not twin)


def test_register_results_equal_per_key():
    """Beyond the verdicts: every key's result of the port's checker on a
    port-recorded twin history equals the JAX checker's, analyzer name
    aside, with the stale key's counterexample op."""
    test = run_on(PORT, "register", True)
    assert cs.forced_stale_reads(test["history"], BAD_KEY) >= 1
    dicts = [o.to_dict() for o in test["history"]]
    pres = workload(PORT, "register")["checker"].check(
        {}, PHistory(dicts, assign_indices=False))
    jres = workload(JAX, "register")["checker"].check(
        {}, JHistory(dicts, assign_indices=False))
    assert sorted(pres["results"]) == sorted(jres["results"])
    for k in pres["results"]:
        p, j = pres["results"][k], jres["results"][k]
        assert p["valid?"] == j["valid?"]
        if p["valid?"] is False:
            assert p["op"].to_dict() == j["op"].to_dict()
            assert p["op-indices"] == j["op-indices"]


def test_bank_workload_bundle_entries():
    """The bank bundle composes the conservation checker, the balance
    plot and stats; an unstored test's plot entry answers skipped, as
    the JAX package's does."""
    test = run_on(PORT, "bank", False)
    res = workload(PORT, "bank")["checker"].check(test, test["history"])
    jres = workload(JAX, "bank")["checker"].check(
        test, JHistory([o.to_dict() for o in test["history"]],
                       assign_indices=False))
    assert sorted(res) == sorted(jres)
    assert res["balance-plot"] == jres["balance-plot"] == {
        "valid?": True, "skipped": "no store directory"}
    assert res["stats"]["count"] == jres["stats"]["count"]


def test_bank_balance_plot_written_to_a_store(tmp_path):
    """With a store directory, the plot entry renders bank-balances.png
    when matplotlib is importable, and is "unknown" (its ImportError
    through check_safe) when it is not, as in the JAX package."""
    test = run_on(PORT, "bank", False)
    test["store_dir"] = str(tmp_path)
    res = workload(PORT, "bank")["checker"].check(test, test["history"])
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert res["balance-plot"]["valid?"] == "unknown"
        return
    assert res["balance-plot"]["valid?"] is True
    assert res["balance-plot"]["files"] == [
        str(tmp_path / "bank-balances.png")]
    assert (tmp_path / "bank-balances.png").stat().st_size > 0


@pytest.mark.parametrize("name", ("txn-append", "txn-wr"))
def test_elle_twin_results_equal_on_the_device_engine(name):
    """The snapshot twin's whole Elle result, cycles and steps included,
    from the device engine (the kernel's plain version on the CPU) equals
    the JAX package's device engine on the same recorded history: the
    path chip_smoke's 30,000-txn twins take on the card."""
    from jepsen_tpu.tpu import elle as jelle
    from jepsen_tpu_torch.gpu import elle as pelle

    test = run_on(PORT, name, True)
    dicts = [o.to_dict() for o in test["history"]]
    check = ("check_list_append" if name == "txn-append"
             else "check_rw_register")
    p = getattr(pelle, check)(PHistory(dicts, assign_indices=False),
                              {"engine": "device", "device": "cpu"})
    j = getattr(jelle, check)(JHistory(dicts, assign_indices=False),
                              {"engine": "device"})
    assert p["valid?"] is False
    assert cs._norm(p) == cs._norm(j)


def _kv_history(events):
    """A one-key history from (process, type, f, value) events."""
    return PHistory([{"process": p, "type": t, "f": f, "value": (BAD_KEY, v)}
                     for p, t, f, v in events])


FORCED_CASES = {
    # write 2 completes after every write of 1 and before the read of 1
    "ruled-out": ([(0, "invoke", "write", 1), (0, "ok", "write", 1),
                   (1, "invoke", "write", 2), (1, "ok", "write", 2),
                   (2, "invoke", "read", None), (2, "ok", "read", 1)], 1),
    # a write of 1 overlaps write 2 and the read: the read may follow it
    "saved-by-a-write": ([(0, "invoke", "write", 1), (0, "ok", "write", 1),
                          (1, "invoke", "write", 2), (3, "invoke", "write", 1),
                          (1, "ok", "write", 2), (2, "invoke", "read", None),
                          (3, "ok", "write", 1), (2, "ok", "read", 1)], 0),
    # a successful cas writes its new value; a failed one writes nothing
    "cas": ([(0, "invoke", "write", 1), (0, "ok", "write", 1),
             (1, "invoke", "cas", [1, 3]), (1, "ok", "cas", [1, 3]),
             (4, "invoke", "cas", [0, 1]), (4, "fail", "cas", [0, 1]),
             (2, "invoke", "read", None), (2, "ok", "read", 1)], 1),
    # nil reads are never ruled out (the model reads nil as unknown)
    "nil": ([(0, "invoke", "write", 1), (0, "ok", "write", 1),
             (2, "invoke", "read", None), (2, "ok", "read", None)], 0),
}


@pytest.mark.parametrize("case", sorted(FORCED_CASES))
def test_forced_stale_reads_by_history_order(case):
    """chip_smoke's count of stale reads the history rules out agrees
    with the linearizable checker: a history with one is invalid, one
    without is valid."""
    events, want = FORCED_CASES[case]
    hist = _kv_history(events)
    assert cs.forced_stale_reads(hist, BAD_KEY) == want
    res = workload(PORT, "register")["checker"].check({}, hist)
    assert res["valid?"] is (want == 0)
