"""The port's test lifecycle (core.py) against the JAX package's.

- core.run at concurrency 1, with a deterministic generator that runs
  the combined package's partition, kill, pause and clock nemeses
  between phases of client ops over the dummy remote, must give the JAX
  package's history (type, f, value, process), the same command log on
  every node's session and the same results, certificates byte for
  byte. Left out of the comparison, by name: the clock offsets the
  clock nemesis reads (node clock minus the control machine's clock at
  the call), the clock-skew bound built from them, and the telemetry
  summary (durations); the JAX package's analyzer names ("tpu") are
  read as the port's ("gpu"), as in the earlier slices' tests.
- Each package's stored run loads in the other, and is analysed again
  by the other's core.analyze with the same verdicts.
- The helpers of the lifecycle (synchronize, primary, prepare_test, the
  tolerant teardown, final_heal, snarf_logs, analyze's stamping) behave
  as the JAX package's.
- Every switch of the JAX package's run that the port does not have
  raises NotImplementedError naming its ROADMAP item.
- The port's core.run of a clusterless test runs in a process that
  never loads jax or jepsen_tpu, and chip_smoke's phase 21 passes every
  check on the CPU at a small size.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import subprocess
import sys
import threading
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
NODES = ["n1", "n2", "n3", "n4", "n5"]


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    """core.run resolves node addresses through each package's net
    module, which memoizes them at module level: clear both caches
    before and after every test."""
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


def responder(node, action):
    cmd = action.cmd
    if cmd.startswith("getent ahostsv4"):
        host = cmd.split()[-1]
        return f"10.0.0.{host[1:]}   STREAM {host}"
    if cmd == "ip -o link show":
        return "1: lo: <LOOPBACK>\n2: eth0: <BROADCAST>"
    if cmd.startswith(("date +%s.%N", "/opt/jepsen/bump-time")):
        return "1000.25"
    if cmd == "cat /run/db.pid":
        return "1234"
    return None


def fake_db(root):
    control = mod(root, "control")
    cu = mod(root, "control.util")

    class FakeDB(mod(root, "db").DB):
        supports_kill = True
        supports_pause = True

        def setup(self, test, node):
            control.exec_("install-db", node)

        def teardown(self, test, node):
            cu.stop_daemon("/run/db.pid")

        def kill(self, test, node):
            control.exec_("killall", "-9", "-w", "db")
            return "killed"

        def start(self, test, node):
            control.exec_("start-db")
            return "started"

        def pause(self, test, node):
            control.exec_("killall", "-s", "STOP", "db")
            return "paused"

        def resume(self, test, node):
            control.exec_("killall", "-s", "CONT", "db")
            return "resumed"

        def log_files(self, test, node):
            return ["/var/log/db.log"]

    return FakeDB()


def nem(root, f, value=None):
    return mod(root, "generator").nemesis(
        {"type": "info", "f": f, "value": value})


def deterministic_test(root, store_base=None):
    """A register test at concurrency 1 whose nemesis ops run between
    phases of client ops: the interleaving is fixed."""
    gen = mod(root, "generator")
    testing = mod(root, "testing")
    chk = mod(root, "checker")
    db = fake_db(root)
    pkg = mod(root, "nemesis.combined").nemesis_package(
        {"db": db, "faults": ["partition", "kill", "pause", "clock"],
         "interval": 1})
    lin = mod(root, "independent").checker(chk.linearizable(
        {"model": mod(root, "checker.models").cas_register(),
         "device": "cpu"} if root == "jepsen_tpu_torch" else
        {"model": mod(root, "checker.models").cas_register()}))

    def client_ops(seed, n):
        rng = random.Random(seed)
        out = []
        for _ in range(n):
            k = rng.randrange(3)
            r = rng.random()
            if r < 0.4:
                out.append({"f": "read", "value": (k, None)})
            elif r < 0.7:
                out.append({"f": "write", "value": (k, rng.randrange(3))})
            else:
                out.append({"f": "cas", "value": (k, [rng.randrange(3),
                                                      rng.randrange(3)])})
        return gen.clients(out)

    test = testing.noop_test()
    test.update({
        "name": "lifecycle-parity" if store_base else None,
        "store_base": str(store_base) if store_base else None,
        "remote": mod(root, "control.dummy").DummyRemote(responder),
        "db": db, "concurrency": 1,
        "client": testing.KVClient(testing.KVState(), latency_s=0),
        "nemesis": pkg["nemesis"],
        "checker": chk.compose({"workload": lin, "stats": chk.stats()}),
        "plot": {"nemeses": pkg["perf"]},
        "generator": gen.phases(
            nem(root, "start-partition", "majority"), client_ops(1, 12),
            nem(root, "kill", "one"), client_ops(2, 12),
            nem(root, "start", "all"), nem(root, "pause", ["n2", "n3"]),
            client_ops(3, 12), nem(root, "resume", "all"),
            nem(root, "bump-clock", {"n1": 4000, "n4": -300}),
            nem(root, "stop-partition"), client_ops(4, 12),
            gen.nemesis(pkg["final_generator"]))})
    return test


TIMING = ("telemetry", "clock-skew-bound")


def untimed(x):
    """A result tree or op without what reads the control machine's
    clock (TIMING keys, clock offsets), analyzer names in the port's
    terms."""
    if hasattr(x, "to_dict") and not isinstance(x, dict):
        return untimed(x.to_dict())
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in TIMING:
                continue
            if k == "clock-offsets":
                v = "<clock>"
            elif k == "analyzer" and isinstance(v, str):
                v = v.replace("tpu", "gpu")
            out[str(k)] = untimed(v)
        return out
    if isinstance(x, (list, tuple)):
        return [untimed(v) for v in x]
    return x


def run_both(store_base=None):
    out = {}
    for root in ROOTS:
        random.seed(7)
        sb = store_base / root if store_base else None
        out[root] = mod(root, "core").run(deterministic_test(root, sb))
    return out["jepsen_tpu"], out["jepsen_tpu_torch"]


def certificates(res) -> dict:
    out = {}

    def walk(x, where):
        if isinstance(x, dict):
            for k, v in x.items():
                if k == "certificate":
                    out[where] = json.dumps(
                        mod("jepsen_tpu_torch", "store.format").jsonable(v),
                        sort_keys=True).encode()
                else:
                    walk(v, f"{where}/{k}")

    walk(res, "")
    return out


def test_core_run_matches_the_jax_package():
    j, p = run_both()
    hj = [(o.type, o.f, untimed(o.value), o.process) for o in j["history"]]
    hp = [(o.type, o.f, untimed(o.value), o.process) for o in p["history"]]
    assert hp == hj and len(hp) == 2 * 48 + 2 * 11
    assert {o.f for o in p["history"] if o.process == "nemesis"} >= {
        "start-partition", "kill", "pause", "bump-clock", "stop-partition",
        "reset-clock"}
    for n in NODES:
        lj = [a.cmd for a in j["sessions"][n].log if not isinstance(a, tuple)]
        lp = [a.cmd for a in p["sessions"][n].log if not isinstance(a, tuple)]
        assert lp == lj, n
        assert any("-j DROP" in c for c in lp) and "iptables -F -w" in lp
    assert untimed(p["results"]) == untimed(j["results"])
    assert p["results"]["valid?"] is True
    certs = certificates(p["results"])
    assert certs and certs == certificates(j["results"])
    assert set(p["results"]["telemetry"]["phases"]) == \
        set(j["results"]["telemetry"]["phases"])


def test_stored_runs_load_and_analyse_across(tmp_path):
    j, p = run_both(tmp_path)
    runs = {"jepsen_tpu": j, "jepsen_tpu_torch": p}
    for writer, reader in [(w, r) for w in ROOTS for r in ROOTS]:
        d = runs[writer]["store_dir"]
        loaded = mod(reader, "store").load(d)
        assert [o.to_dict() for o in loaded["history"]] == json.loads(
            json.dumps([mod(writer, "store.format").jsonable(o)
                        for o in runs[writer]["history"]]))
        with open(Path(d) / "results.json") as f:
            assert loaded["results"] == json.load(f)
        again = dict(loaded,
                     checker=deterministic_test(reader)["checker"])
        res = mod(reader, "core").analyze(again)["results"]
        assert untimed(res) == untimed(runs[writer]["results"]), \
            (writer, reader)
        assert certificates(res) == certificates(runs[writer]["results"])
        assert mod(reader, "coverage").validate_record(
            mod(reader, "coverage").load_record(d)) > 0
        events, metrics = mod(reader, "store").load_telemetry(d)
        assert mod(reader, "telemetry").validate_metrics(metrics) > 0
        # snarf_logs fetched each node's DB log into the run dir
        dl = [a for a in runs[writer]["sessions"]["n1"].log
              if isinstance(a, tuple) and a[0] == "download"]
        assert dl and str(dl[0][2]).startswith(d)


def test_core_run_cas_register_e2e():
    """tests/test_interpreter.py:171 on the port."""
    from jepsen_tpu_torch import checker, core, testing
    from jepsen_tpu_torch import generator as gen

    state = testing.AtomState()
    meta_log: list = []
    rng = random.Random(42)

    def rand_op():
        r = rng.random()
        if r < 0.4:
            return {"f": "read"}
        if r < 0.7:
            return {"f": "write", "value": rng.randint(0, 2)}
        return {"f": "cas", "value": [rng.randint(0, 2),
                                      rng.randint(0, 2)]}

    t = testing.noop_test()
    t.update(nodes=["n1", "n2", "n3"], concurrency=4,
             db=testing.AtomDB(state),
             client=testing.AtomClient(state, meta_log),
             checker=checker.compose({
                 "stats": checker.stats(),
                 "optimism": checker.unbridled_optimism()}),
             generator=gen.clients(gen.limit(150, lambda: rand_op())))
    t = core.run(t)
    assert t["results"]["valid?"] is True, t["results"]
    assert t["results"]["stats"]["ok-count"] > 0
    assert len(t["history"]) == 300
    assert {"open", "setup", "teardown", "close"} <= set(meta_log)


# ---------------------------------------------------------------------------
# The lifecycle's helpers
# ---------------------------------------------------------------------------

def test_prepare_test_primary_and_synchronize():
    def scen(root):
        core = mod(root, "core")
        t = core.prepare_test({"nodes": ["a", "b"]})
        t2 = core.prepare_test({"nodes": []})
        core.synchronize({"barrier": core.NO_BARRIER})
        core.synchronize({})
        one = core.prepare_test({"nodes": ["x"]})
        core.synchronize(one)
        return (t["concurrency"], type(t["barrier"]).__name__,
                t2["barrier"], t2["concurrency"], core.primary(t),
                bool(t["start_time"]))

    j, p = scen("jepsen_tpu"), scen("jepsen_tpu_torch")
    assert p == j == (2, "Barrier", "::no-barrier", 0, "a", True)


def test_teardown_attempts_every_node_and_raises_all():
    def scen(root):
        core = mod(root, "core")
        remote = mod(root, "control.dummy").DummyRemote()
        t = {"nodes": ["n1", "n2", "n3"], "remote": remote}
        t = mod(root, "control").open_sessions(t)
        seen = []

        def fn(test, node):
            seen.append(node)
            if node != "n2":
                raise ValueError(f"bad {node}")

        with pytest.raises(mod(root, "util").RealPmapError) as ei:
            core._teardown_tolerantly(t, "db", fn)
        one = {"nodes": ["n1"], "sessions": t["sessions"]}
        with pytest.raises(ValueError, match="bad n1"):
            core._teardown_tolerantly(one, "db", fn)
        core._teardown_tolerantly(t, "db", lambda test, node: None)
        return sorted(seen), sorted(str(e) for e in ei.value.args[0])

    assert scen("jepsen_tpu_torch") == scen("jepsen_tpu")


def test_final_heal_and_snarf_logs(tmp_path):
    def scen(root):
        core = mod(root, "core")
        remote = mod(root, "control.dummy").DummyRemote(responder)
        t = {"nodes": ["n1", "n2"], "remote": remote,
             "net": mod(root, "net").iptables, "restore_clocks?": True,
             "db": fake_db(root), "name": "snarf",
             "start_time": "20260801T000000.0000",
             "store_dir": str(tmp_path / root)}
        core.final_heal(t)  # no sessions: nothing to heal
        t = mod(root, "control").open_sessions(t)
        core.final_heal(t)
        core.snarf_logs(t)
        return {n: [a.cmd if not isinstance(a, tuple)
                    else (a[0], a[1], str(a[2]).replace(str(tmp_path), ""))
                    for a in s.log] for n, s in t["sessions"].items()}

    j, p = scen("jepsen_tpu"), scen("jepsen_tpu_torch")
    assert [x.replace("jepsen_tpu_torch", "jepsen_tpu")
            if isinstance(x, str) else
            (x[0], x[1], x[2].replace("/jepsen_tpu_torch/", "/jepsen_tpu/"))
            for x in p["n1"]] == j["n1"]
    assert "iptables -F -w" in p["n1"] and \
        "ntpdate -b time.google.com" in p["n1"]
    assert any(isinstance(x, tuple) and x[0] == "download" for x in p["n2"])


def test_analyze_stamps_certificates_and_the_skew_bound(tmp_path):
    """core.analyze re-validates every certificate (`certified`) and,
    offline, re-reads nodes.jsonl for the clock-skew bound."""
    def scen(root):
        core = mod(root, "core")
        synth = mod(root, "gpu.synth" if root == "jepsen_tpu_torch"
                    else "tpu.synth")
        models = mod(root, "checker.models")
        h = synth.register_history(60, n_procs=3, seed=4)
        opts = {"model": models.cas_register()}
        if root == "jepsen_tpu_torch":
            opts["device"] = "cpu"
        d = tmp_path / root
        d.mkdir()
        (d / "nodes.jsonl").write_text(json.dumps(
            {"kind": "sample", "node": "n1", "t": 5,
             "clock_offset_s": -0.25}) + "\n")
        t = {"history": h, "store_dir": str(d),
             "checker": mod(root, "checker").linearizable(opts)}
        res = core.analyze(t)["results"]
        return untimed(res), res.get("clock-skew-bound"), \
            sorted(res["telemetry"])

    j, p = scen("jepsen_tpu"), scen("jepsen_tpu_torch")
    assert p == j
    assert p[0]["certified"] is True and p[1] == 0.25


# ---------------------------------------------------------------------------
# What the port does not have raises
# ---------------------------------------------------------------------------

def clusterless(**kw):
    from jepsen_tpu_torch import testing

    t = testing.noop_test()
    t.update(nodes=["n1"], concurrency=1, generator=None)
    t.update(kw)
    return t


@pytest.mark.parametrize("kw,item", [
    ({"quarantine?": {"threshold": 2}}, "A3c"),
    ({"fleet": {"addr": "localhost:1"}}, "A4"),
    ({"profile?": True}, "A5"),
    ({"xla-trace?": True}, "A5"),
    ({"profile_dir": "/tmp/x"}, "A5"),
    ({"ssh": {}}, "A3c"),
    ({"ssh": {"username": "admin"}}, "A3c")])
def test_unported_switches_raise(tmp_path, kw, item):
    from jepsen_tpu_torch import core

    t = clusterless(name="refused", store_base=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        core.run(t)
    if item != "A3c" or "quarantine?" in kw:
        assert not (tmp_path / "refused").exists()


@pytest.mark.parametrize("key", ["profile?", "xla-trace?", "profile_dir"])
def test_a_profiled_analysis_raises(key):
    from jepsen_tpu_torch import core

    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        core.analyze({"history": [], key: "/tmp/x"})


@pytest.mark.parametrize("var", ["JAX_COORDINATOR_ADDRESS",
                                 "JEPSEN_TPU_MULTIHOST"])
def test_multihost_raises(monkeypatch, var):
    from jepsen_tpu_torch import core

    monkeypatch.setenv(var, "localhost:1234")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        core.run(clusterless())


def test_membership_fault_raises_through_the_package():
    from jepsen_tpu_torch.nemesis import combined

    with pytest.raises(NotImplementedError, match="ROADMAP A3c"):
        combined.nemesis_package({"db": fake_db("jepsen_tpu_torch"),
                                  "faults": ["membership"]})


# ---------------------------------------------------------------------------
# Hygiene and the phase 21 rehearsal
# ---------------------------------------------------------------------------

def test_core_run_without_loading_jax(tmp_path):
    code = f"""
import sys
from jepsen_tpu_torch import checker, core, nodeprobe, testing
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import models
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.nemesis import combined
from jepsen_tpu_torch.workloads import register

w = register.workload({{"keys": range(4), "ops_per_key": 20, "seed": 3,
                        "device": "cpu"}})
pkg = combined.nemesis_package({{"db": testing.AtomDB(
    testing.AtomState()), "faults": ["partition"], "interval": 0.05}})
synth = nodeprobe.synthetic_responder(7)

def respond(node, action):
    if action.cmd.startswith("getent ahostsv4"):
        return "10.0.0." + node[1:] + " STREAM " + node
    if action.cmd == "ip -o link show":
        return "2: eth0: <BROADCAST>"
    return synth(node, action)

t = testing.noop_test()
t.update(name="nojax", store_base={str(tmp_path)!r}, concurrency=5,
         remote=DummyRemote(respond), client=testing.KVClient(
             testing.KVState(), latency_s=0), nemesis=pkg["nemesis"],
         checker=w["checker"], monitor_interval_s=0.2,
         **{{"nodeprobe?": True}},
         generator=gen.phases(gen.clients(w["generator"],
                                          gen.limit(4, pkg["generator"])),
                              gen.nemesis(pkg["final_generator"])))
t = core.run(t)
assert t["results"]["valid?"] is True, t["results"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LOADED", loaded)
assert not loaded, loaded
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_chip_smoke_phase_21_on_the_cpu():
    """chip_smoke's lifecycle phase at a small size on the CPU: every
    check of the phase runs (verdicts, the run directory against the run
    in memory, the CPU re-analysis, no leaked thread or handler); the
    card-only launch counts are skipped by the phase itself."""
    import torch

    import chip_smoke

    threads = threading.active_count()
    got = chip_smoke.lifecycle_path(torch.device("cpu"), False, {
        "register_keys": 10, "register_concurrency": 10,
        "bank_ops": 1000, "txn_ops": 1500, "nemesis_ops": 8,
        "stale_every": 1})
    assert got["wgl_search"] == {"lifecycle-register": 1,
                                 "lifecycle-register-twin": 1}
    assert got["scc"]["lifecycle-list-append"] >= 0
    assert threading.active_count() == threads
