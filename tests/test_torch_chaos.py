"""The port's harness chaos rig (chaos.py), retry layer (control/retry.py,
reconnect.py) and quarantine breakers (control/health.py, core.run's
quarantine? path, the node probe's quarantine records) against the JAX
package's.

- The five chaos invariants hold on the port's core.run: the run
  terminates, its history is well-formed, teardown heals, the store
  validates, and the verdict is True, False or "unknown"; every
  certificate of a chaotic run is certified or honestly absent.
- At concurrency 1 the same seed gives the same fault schedule and the
  same history as the JAX package's core.run.
- Retry budgets, jitter sequences, breaker transitions, the guarded and
  lazy sessions, results["degraded"] of a quarantined run and the node
  probe's quarantine gaps, breaker records and advisories equal the JAX
  package's.

Both packages' net._ip_cache are cleared around each test.
"""

from __future__ import annotations

import importlib
import json
import random

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PORT = "jepsen_tpu_torch"
SEED = 1337


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


def both(scenario, *args):
    """(jax, port) outcomes of one scenario, each seeding the global
    random module the same way first; asserts they are equal."""
    out = []
    for root in ROOTS:
        random.seed(1234)
        out.append(scenario(root, *args))
    assert out[0] == out[1]
    return out[1]


def recording_net(root):
    class RecordingNet(mod(root, "net").Net):
        """Counts heal/drop calls; never touches a real network."""

        def __init__(self):
            self.heals = 0
            self.drops = 0

        def drop(self, test, src, dest):
            self.drops += 1

        def drop_all(self, test, grudge):
            self.drops += 1

        def heal(self, test):
            self.heals += 1

        def slow(self, *a, **kw):
            pass

        def flaky(self, *a, **kw):
            pass

        def fast(self, *a, **kw):
            pass

        def shape(self, *a, **kw):
            pass

    return RecordingNet()


def op_view(o):
    return (o.type, o.f, o.value if not isinstance(o.value, tuple)
            else list(o.value), o.process, o.get("error"))


# ---------------------------------------------------------------------------
# the chaos invariants on the port's core.run
# ---------------------------------------------------------------------------

def assert_invariants(root, test):
    chaos, store = mod(root, "chaos"), mod(root, "store")
    fmt = mod(root, "store.format")
    assert chaos.validate_history(test["history"]) == []
    d = store.path(test)
    log = d / "history.jlog"
    assert fmt._valid_prefix_end(log) == log.stat().st_size
    assert len(list(fmt.read_ops(log))) == len(test["history"])
    results = json.loads((d / "results.json").read_text())
    assert results["valid?"] in (True, False, "unknown")


def chaos_run(root, tmp_path, name, *, client_rates=None, nemesis=None,
              net=None, nodes=3, ops=120, concurrency=None, gen_ops=None,
              checker_=None):
    testing, chaos = mod(root, "testing"), mod(root, "chaos")
    checker, gen = mod(root, "checker"), mod(root, "generator")
    state = testing.AtomState()
    inner = testing.AtomClient(state, latency_s=0.0005 if gen_ops is None
                               else 0)
    test = testing.noop_test()
    if gen_ops is None:
        generator = gen.clients(
            gen.limit(ops, lambda: {"f": "read"}),
            gen.limit(6, gen.cycle(gen.phases(
                gen.sleep(0.02), {"type": "info", "f": "start"},
                gen.sleep(0.02), {"type": "info", "f": "stop"}))))
    else:
        generator = gen.clients(gen_ops)
    test.update(
        name=name, store_base=str(tmp_path),
        nodes=[f"n{i}" for i in range(1, nodes + 1)],
        concurrency=concurrency or nodes,
        net=net if net is not None else recording_net(root),
        db=testing.AtomDB(state),
        client=chaos.ChaosClient(inner, seed=SEED, rates=client_rates),
        checker=checker_ or checker.compose({
            "stats": checker.stats(),
            "exceptions": checker.unhandled_exceptions()}),
        generator=generator)
    if nemesis is not None:
        test["nemesis"] = nemesis
    return mod(root, "core").run(test)


def test_seeded_chaos_run_keeps_invariants(tmp_path):
    telemetry = mod(PORT, "telemetry")
    t = chaos_run(PORT, tmp_path, "chaos-client",
                  nemesis=mod(PORT, "nemesis").partition_random_node())
    assert_invariants(PORT, t)
    assert sum(t["client"].tally.values()) > 0
    assert "ok" in {o.type for o in t["history"]}
    assert telemetry.get().counters().get("chaos.drop-connection", 0) + \
        telemetry.get().counters().get("chaos.command-timeout", 0) + \
        telemetry.get().counters().get("chaos.duplicate", 0) + \
        telemetry.get().counters().get("chaos.exception", 0) > 0


def test_chaos_faults_map_to_honest_completions(tmp_path):
    t = chaos_run(PORT, tmp_path, "chaos-honest", client_rates={
        "drop-connection": 0.2, "command-timeout": 0.2, "exception": 0.1})
    assert_invariants(PORT, t)
    hist, tally = t["history"], t["client"].tally
    fails = sum(1 for o in hist if o.type == "fail")
    infos = sum(1 for o in hist if o.type == "info"
                and isinstance(o.process, int))
    assert fails >= tally["drop-connection"] > 0
    assert infos >= tally["command-timeout"] > 0
    assert tally["exception"] > 0


def test_nemesis_teardown_crash_still_heals(tmp_path):
    telemetry = mod(PORT, "telemetry")
    net = recording_net(PORT)
    nem = mod(PORT, "chaos").CrashingNemesis(
        mod(PORT, "nemesis").partition_halves())
    t = chaos_run(PORT, tmp_path, "chaos-nem-crash", net=net, nemesis=nem)
    assert_invariants(PORT, t)
    assert net.heals >= 1
    assert telemetry.get().counters().get(
        "chaos.nemesis-teardown-crashes", 0) >= 1


def test_chaos_run_certificates_validate(tmp_path):
    """Client chaos never yields a certificate that fails validation: each
    is stamped `certified` by core.analyze, or honestly absent."""
    checker, models = mod(PORT, "checker"), mod(PORT, "checker.models")
    certify = mod(PORT, "gpu.certify")
    t = chaos_run(PORT, tmp_path, "chaos-certs", client_rates={
        "drop-connection": 0.15, "command-timeout": 0.1,
        "exception": 0.05}, checker_=checker.compose({
            "linear": checker.linearizable({
                "model": models.cas_register(0), "device": "cpu"}),
            "stats": checker.stats()}))
    assert_invariants(PORT, t)
    assert sum(t["client"].tally.values()) > 0
    seen = 0
    for path, res in certify.iter_certificates(t["results"]):
        seen += 1
        certify.validate_schema(res["certificate"])
        if "absent" not in res["certificate"]:
            assert res.get("certified") is True, (
                path, res.get("certificate-error"))
    assert seen >= 1


def test_same_seed_same_schedule_and_history_as_jax(tmp_path):
    """Concurrency 1 over one node: the client's fault rolls, and so the
    history, follow the seed alone (an injected exception crashes the
    worker, whose next process reopens the client: the next seeded
    stream)."""
    def scenario(root):
        rng = random.Random(9)
        ops = []
        for _ in range(80):
            if rng.random() < 0.5:
                ops.append({"f": "read"})
            else:
                ops.append({"f": "write", "value": rng.randrange(5)})
        t = chaos_run(root, tmp_path / root, "chaos-seeded", nodes=1,
                      concurrency=1, gen_ops=ops, client_rates={
                          "drop-connection": 0.1, "command-timeout": 0.1,
                          "duplicate": 0.05, "exception": 0.05})
        assert_invariants(root, t)
        return ([op_view(o) for o in t["history"]
                 if isinstance(o.process, int)],
                dict(t["client"].tally),
                t["results"]["exceptions"]["valid?"])

    got = both(scenario)
    assert sum(got[1].values()) > 4 and got[1]["exception"] >= 1


# ---------------------------------------------------------------------------
# seeded fault schedules of the other rigs
# ---------------------------------------------------------------------------

def test_chaos_remote_schedule_equal():
    def scenario(root):
        chaos = mod(root, "chaos")
        Action = mod(root, "control.core").Action
        TransportError = mod(root, "control.core").TransportError
        crm = chaos.ChaosRemote(mod(root, "control.dummy").DummyRemote(),
                                seed=SEED, rates={"drop-connection": 0.2,
                                                  "command-timeout": 0.1,
                                                  "duplicate": 0.1},
                                connect_rate=0.2)
        out = []
        for node in ("n1", "n2", "n1", "n3", "n1"):
            try:
                s = crm.connect({"host": node})
            except TransportError as e:
                out.append((node, "connect", str(e)))
                continue
            for i in range(15):
                try:
                    s.execute(Action(cmd=f"echo {i}"))
                    out.append((node, i, "ok"))
                except TransportError as e:
                    out.append((node, i, str(e)))
        return out, dict(crm.tally)

    got = both(scenario)
    assert got[1]["drop-connection"] > 0


def test_durability_chaos_schedule_and_corruptions_equal(tmp_path):
    def scenario(root):
        chaos = mod(root, "chaos")
        dc = chaos.DurabilityChaos(seed=SEED)
        out = []
        for i in range(40):
            try:
                dc._wal_hook("w", {"t": "chunk", "seq": i})
                out.append("wal-ok")
            except OSError as e:
                out.append(("wal", e.errno))
            try:
                out.append(dc._ckpt_hook("c", bytes([i % 256]) * 10))
            except OSError as e:
                out.append(("ckpt", e.errno))
        files = []
        for mode in ("torn", "garbage", "magic"):
            p = tmp_path / root / f"{mode}.ckpt"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"JTPUCKP1" + bytes(range(40)))
            chaos.corrupt_checkpoint(p, mode)
            files.append(p.read_bytes())
        with pytest.raises(ValueError):
            chaos.corrupt_checkpoint(p, "nope")
        return out, dict(dc.tally), files

    got = both(scenario)
    assert got[1]


def test_durability_chaos_installs_both_hooks():
    chaos = mod(PORT, "chaos")
    wal = mod(PORT, "fleet.wal")
    ckpt = mod(PORT, "gpu.ckpt")
    with chaos.DurabilityChaos(seed=1) as dc:
        assert wal._fault_hook == dc._wal_hook
        assert ckpt._fault_hook == dc._ckpt_hook
    assert wal._fault_hook is None and ckpt._fault_hook is None


BAD_HISTORIES = [
    [("invoke", 0, "read"), ("ok", 0, "read")],
    [("ok", 0, "read")],
    [("invoke", 0, "read"), ("ok", 0, "write")],
    [("invoke", 0, "read"), ("invoke", 0, "read"), ("ok", 0, "read")],
    [("invoke", 0, "read"), ("bogus", 0, "read")],
    [("info", "nemesis", "start"), ("invoke", 1, "read"),
     ("info", 1, "read")],
]


@pytest.mark.parametrize("i", range(len(BAD_HISTORIES)))
def test_validate_history_equal(i):
    def scenario(root):
        mk = mod(root, "history").op
        ops = [mk(index=k, time=k, type=t, process=p, f=f)
               for k, (t, p, f) in enumerate(BAD_HISTORIES[i])]
        if i == 0:
            ops[1] = ops[1].copy(index=5)
        return mod(root, "chaos").validate_history(ops)

    both(scenario)


# ---------------------------------------------------------------------------
# retry.py and reconnect.py
# ---------------------------------------------------------------------------

def dead_remote(root, pattern):
    """A remote whose sessions fail by `pattern(call number)`."""
    core = mod(root, "control.core")
    DummySession = mod(root, "control.dummy").DummySession

    class R(core.Remote):
        def __init__(self):
            self.calls = 0

        def connect(self, spec):
            outer = self

            class S(DummySession):
                def execute(self, action):
                    outer.calls += 1
                    if pattern(outer.calls):
                        raise core.TransportError("down")
                    return core.Result(0, "ok", "", action.cmd)

            return S(spec.get("host"))

    return R()


def test_retry_budgets_equal(monkeypatch):
    def scenario(root):
        retry = mod(root, "control.retry")
        core = mod(root, "control.core")
        telemetry = mod(root, "telemetry")
        monkeypatch.setattr(retry, "BACKOFF_S", 0.001)
        telemetry.reset()
        out = []
        down = dead_remote(root, lambda n: True)
        sess = retry.RetryingRemote(down, budget_limit=3).connect(
            {"host": "n1"})
        for _ in range(2):
            with pytest.raises(core.TransportError):
                sess.execute(core.Action(cmd="true"))
            out.append((down.calls, sess.budget.spent,
                        sess.budget.exhausted))
        flaky = dead_remote(root, lambda n: n % 2 == 1)
        r = retry.RetryingRemote(flaky, budget_limit=2)
        s1, s2 = r.connect({"host": "n1"}), r.connect({"host": "n2"})
        out.append([s1.execute(core.Action(cmd="x")).out for _ in range(5)])
        out.append((s1.budget is s2.budget, s1.budget.exhausted,
                    flaky.calls))
        b = retry.RetryBudget(2)
        out.append([b.try_spend() for _ in range(3)] + [b.spent])
        b.refund()
        out.append((b.spent, b.exhausted))
        out.append({k: v for k, v in telemetry.get().counters().items()
                    if k.startswith("control.")})
        return out

    got = both(scenario)
    assert got[0] == (4, 3, True) and got[1] == (5, 3, True)


def test_jitter_sequences_equal():
    def scenario(root):
        retry = mod(root, "control.retry")
        rng = random.Random(7)
        s = retry.BACKOFF_S
        seq = []
        for _ in range(50):
            s = retry.decorrelated_jitter(s, rng=rng)
            seq.append(s)
        seq.append(retry.decorrelated_jitter(0.05, base_s=0.05, cap_s=1.0,
                                             rng=rng))
        return seq, (retry.RETRIES, retry.BACKOFF_S, retry.BACKOFF_CAP_S,
                     retry.SESSION_RETRY_BUDGET)

    got = both(scenario)
    assert all(0.1 <= s <= 3.0 for s in got[0][:50])


def test_retry_stack_absorbs_transport_chaos(monkeypatch):
    def scenario(root):
        retry, chaos = mod(root, "control.retry"), mod(root, "chaos")
        control, testing = mod(root, "control"), mod(root, "testing")
        monkeypatch.setattr(retry, "BACKOFF_S", 0.001)
        crm = chaos.ChaosRemote(mod(root, "control.dummy").DummyRemote(),
                                seed=SEED, rates={"drop-connection": 0.15,
                                                  "command-timeout": 0.1})
        test = testing.noop_test()
        test.update(nodes=["n1", "n2", "n3"],
                    remote=retry.RetryingRemote(crm), ssh={})
        test = control.open_sessions(test)
        outs = []
        try:
            for _ in range(10):
                outs.append(sorted(control.on_nodes(
                    test, lambda t, n: control.exec_("true"))))
        finally:
            control.close_sessions(test)
        return outs, sum(crm.tally.values()) > 0

    assert both(scenario)[1] is True


def test_reconnect_wrapper_equal():
    def scenario(root):
        reconnect = mod(root, "reconnect")
        opened, closed = [], []

        def opener():
            opened.append(len(opened))
            return {"conn": len(opened)}

        w = reconnect.Wrapper(open=opener, close=closed.append,
                              name="db", log=False)
        out = [w.conn()]
        w.open()
        out.append(w.conn())
        with pytest.raises(KeyError):
            with w.with_conn(cycle_on=KeyError) as c:
                out.append(c)
                raise KeyError("boom")
        out.append(w.conn())
        with pytest.raises(ValueError):
            with w.with_conn(cycle_on=KeyError):
                raise ValueError("kept")
        out.append(w.conn())
        out.append(w.call(lambda c: c["conn"] * 10))
        w.reopen()
        w.close()
        out.append((w.conn(), list(opened), list(closed)))
        bad = reconnect.Wrapper(open=lambda: None, close=lambda c: None)
        with pytest.raises(RuntimeError, match="returned None"):
            bad.open()
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# health.py: breakers, guarded and lazy sessions
# ---------------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_breaker_transitions_equal(monkeypatch):
    def scenario(root):
        health, telemetry = mod(root, "control.health"), mod(root,
                                                              "telemetry")
        clock = Clock()
        monkeypatch.setattr(health._time, "monotonic", clock)
        telemetry.reset()
        b = health.CircuitBreaker("n1", threshold=2, cooldown_s=5.0)
        seq = []

        def note(what):
            seq.append((what, b.state(), b.is_open, b.opened_count))

        note("fresh")
        for step in ("failure", "failure", "admit", "tick", "admit",
                     "admit", "failure", "tick", "admit", "abort",
                     "admit", "success", "admit", "failure", "failure"):
            if step == "tick":
                clock.t += 6.0
                note(step)
            elif step == "admit":
                seq.append(("admit", b.admit()))
            else:
                getattr(b, step if step != "abort" else "abort_probe")()
                note(step)
        hr = health.HealthRegistry.from_test(
            {"quarantine?": {"threshold": 1, "cooldown_s": 3}})
        hr.breaker("n2").failure()
        hr.breaker("n3")
        hr.advise("n3", "low-memory", 10)
        seq.append((hr.threshold, hr.cooldown_s, hr.quarantined(),
                    hr.ever_quarantined(), sorted(hr.states().items()),
                    hr.advisories(),
                    health.HealthRegistry.from_test(
                        {"quarantine?": True}).threshold))
        seq.append({k: v for k, v in telemetry.get().counters().items()
                    if k.startswith("control.")})
        monkeypatch.undo()
        return seq

    both(scenario)


def test_guarded_and_lazy_sessions_equal(monkeypatch):
    def scenario(root):
        health = mod(root, "control.health")
        retry = mod(root, "control.retry")
        core = mod(root, "control.core")
        DummySession = mod(root, "control.dummy").DummySession
        monkeypatch.setattr(retry, "BACKOFF_S", 0.001)
        out = []
        # a lazy connect through the retry stack is not a breaker success
        reg = health.HealthRegistry(threshold=3)
        guarded = health.GuardedRemote(retry.RetryingRemote(
            dead_remote(root, lambda n: True), budget_limit=2), reg)
        lazy = health.LazyConnectSession(guarded, {"host": "n1"})
        for _ in range(4):
            with pytest.raises(core.TransportError) as ei:
                lazy.execute(core.Action(cmd="true"))
            out.append(type(ei.value).__name__)
        out.append(reg.quarantined())

        # a probe dying locally frees the half-open probe slot
        class LocalBoom(DummySession):
            def execute(self, action):
                raise OSError("disk full")

        b = health.CircuitBreaker("n1", threshold=1, cooldown_s=0.0)
        b.failure()
        with pytest.raises(OSError):
            health.GuardedSession(LocalBoom("n1"), b).execute(
                core.Action(cmd="true"))
        out.append((b.is_open, b.admit()))

        # only transport errors count: nonzero exits never open
        class Exiting(DummySession):
            def execute(self, action):
                return core.Result(exit=1, out="", err="nope",
                                   cmd=action.cmd)

        class R(core.Remote):
            def connect(self, spec):
                return Exiting(spec.get("host"))

        reg2 = health.HealthRegistry(threshold=1)
        sess = health.GuardedRemote(R(), reg2).connect({"host": "n1"})
        out.append([sess.execute(core.Action(cmd="false")).exit
                    for _ in range(5)] + [reg2.quarantined()])
        monkeypatch.undo()
        return out

    got = both(scenario)
    assert got[4] == ["n1"]


def test_probe_and_probe_all_equal():
    def scenario(root):
        health = mod(root, "control.health")
        core = mod(root, "control.core")
        DummyRemote = mod(root, "control.dummy").DummyRemote

        class Mixed(core.Remote):
            def connect(self, spec):
                if spec.get("host") == "n2":
                    raise core.TransportError("refused", node="n2")
                return DummyRemote().connect(spec)

        reg = health.HealthRegistry(threshold=1)
        test = {"nodes": ["n1", "n2", "n3"], "remote": Mixed(),
                "health": reg}
        return (health.probe(test, "n1"), health.probe_all(test),
                reg.quarantined(), sorted(reg.states().items()))

    got = both(scenario)
    assert got[1] == {"n1": True, "n2": False, "n3": True}


def test_open_sessions_defers_a_dead_node_under_quarantine():
    def scenario(root):
        health = mod(root, "control.health")
        control, core = mod(root, "control"), mod(root, "control.core")
        DummyRemote = mod(root, "control.dummy").DummyRemote

        class DeadN2(core.Remote):
            def connect(self, spec):
                if spec.get("host") == "n2":
                    raise core.TransportError("refused", node="n2")
                return DummyRemote().connect(spec)

        test = {"nodes": ["n1", "n2"], "remote": DeadN2()}
        with pytest.raises(mod(root, "util").RealPmapError,
                           match="refused"):
            control.open_sessions(test)
        test["health"] = health.HealthRegistry(threshold=2)
        t = control.open_sessions(test)
        kinds = {n: type(s).__name__ for n, s in t["sessions"].items()}
        guarded = type(control.remote_for(t)).__name__
        bare = type(control.remote_for(t, guarded=False)).__name__
        control.close_sessions(t)
        return kinds, guarded, bare

    got = both(scenario)
    assert got == ({"n1": "GuardedSession", "n2": "LazyConnectSession"},
                   "GuardedRemote", "DeadN2")


# ---------------------------------------------------------------------------
# core.run under quarantine
# ---------------------------------------------------------------------------

def quarantine_run(root, tmp_path):
    """A node dead from the start: its ops crash fast to :info and the
    run finishes :degraded instead of aborting."""
    core, control = mod(root, "core"), mod(root, "control")
    cc = mod(root, "control.core")
    testing, checker = mod(root, "testing"), mod(root, "checker")
    gen, jclient = mod(root, "generator"), mod(root, "client")
    DummySession = mod(root, "control.dummy").DummySession

    class DeadNodeRemote(cc.Remote):
        def connect(self, spec):
            if spec.get("host") == "n2":
                raise cc.TransportError("connection refused", node="n2")
            return DummySession(spec.get("host"))

    class CmdClient(jclient.Client):
        def __init__(self, node=None):
            self.node = node

        def open(self, test, node):
            return CmdClient(node)

        def invoke(self, test, op_):
            with control.with_session(test, self.node):
                control.exec_("true")
            return op_.copy(type="ok")

    test = testing.noop_test()
    test.update(name="chaos-quarantine", store_base=str(tmp_path / root),
                nodes=["n1", "n2"], concurrency=2,
                remote=DeadNodeRemote(), ssh={}, net=recording_net(root),
                client=CmdClient(), checker=checker.stats(),
                generator=gen.clients(gen.limit(24, lambda: {"f": "read"})))
    test["quarantine?"] = {"threshold": 2, "cooldown_s": 60}
    t = core.run(test)
    assert mod(root, "chaos").validate_history(t["history"]) == []
    assert any(o.type == "ok" for o in t["history"])
    c = t["results"]["telemetry"]["counters"]
    return (t["results"]["degraded"], t["results"]["valid?"],
            c.get("control.quarantine.opened"))


def test_quarantined_run_degraded_equal(tmp_path):
    got = both(quarantine_run, tmp_path)
    assert got[0] == {"quarantined-nodes": ["n2"],
                      "still-quarantined": ["n2"]}


def test_degraded_client_open_closes_half_open_client(tmp_path):
    def scenario(root):
        testing, checker = mod(root, "testing"), mod(root, "checker")
        gen, jclient = mod(root, "generator"), mod(root, "client")
        cc = mod(root, "control.core")
        closed = []

        class HalfDeadClient(jclient.Client):
            def __init__(self, node=None):
                self.node = node

            def open(self, test, node):
                return HalfDeadClient(node)

            def setup(self, test):
                if self.node == "n2":
                    raise cc.TransportError("died in setup", node="n2")

            def invoke(self, test, op_):
                return op_.copy(type="ok")

            def close(self, test):
                closed.append(self.node)

        test = testing.noop_test()
        test.update(name="chaos-half-open", store_base=str(tmp_path / root),
                    nodes=["n1", "n2"], concurrency=2,
                    net=recording_net(root), client=HalfDeadClient(),
                    checker=checker.stats(),
                    generator=gen.clients(gen.limit(8, lambda: {
                        "f": "read"})))
        test["quarantine?"] = {"threshold": 2, "cooldown_s": 60}
        t = mod(root, "core").run(test)
        c = t["results"]["telemetry"]["counters"]
        return ("n2" in closed, t["results"]["valid?"],
                c.get("core.degraded-client-opens"))

    assert both(scenario) == (True, True, 1)


def test_tolerant_teardown_and_transport_classification_equal():
    import errno

    def scenario(root):
        core, testing, util = (mod(root, "core"), mod(root, "testing"),
                               mod(root, "util"))
        telemetry = mod(root, "telemetry")
        cc = mod(root, "control.core")
        DummySession = mod(root, "control.dummy").DummySession
        test = testing.noop_test()
        test.update(nodes=["n1", "n2"],
                    sessions={"n1": DummySession("n1"),
                              "n2": DummySession("n2")},
                    health=object())

        def real_bug(t, n):
            if n == "n1":
                raise cc.TransportError("down", node="n1")
            raise AssertionError("real teardown bug")

        with pytest.raises(util.RealPmapError) as e:
            core._teardown_tolerantly(test, "db", real_bug)
        kinds = sorted(type(x).__name__ for x in e.value.errors)
        telemetry.reset()

        def all_down(t, n):
            raise cc.TransportError("down", node=n)

        core._teardown_tolerantly(test, "db", all_down)
        degraded = telemetry.get().counters()["core.degraded-teardowns"]
        no_health = dict(test, health=None)
        with pytest.raises(util.RealPmapError):
            core._teardown_tolerantly(no_health, "db", all_down)
        cls = [core._transport_failure(x) for x in (
            OSError(errno.EHOSTUNREACH, "no route"),
            ConnectionRefusedError(), cc.TransportError("down"),
            FileNotFoundError(2, "missing"), TypeError("bug"),
            TimeoutError(), OSError(errno.ENOENT, "x"))]
        return kinds, degraded, cls

    got = both(scenario)
    assert got[2] == [True, True, True, False, False, True, False]


def test_final_heal_skips_quarantined_nodes():
    def scenario(root):
        core, health = mod(root, "core"), mod(root, "control.health")
        healed = []

        class Net(mod(root, "net").Net):
            def heal(self, test):
                healed.append(list(test["nodes"]))

        hr = health.HealthRegistry(threshold=1)
        hr.breaker("n2").failure()
        core.final_heal({"nodes": ["n1", "n2", "n3"], "sessions": {"x": 1},
                         "net": Net(), "health": hr})
        return healed

    assert both(scenario) == [["n1", "n3"]]


# ---------------------------------------------------------------------------
# the node probe under quarantine
# ---------------------------------------------------------------------------

def probe_test(root, **kw):
    util, nodeprobe = mod(root, "util"), mod(root, "nodeprobe")
    util.init_relative_time()
    t = {"nodes": ["n1"], "ssh": {"dummy": True},
         "remote": mod(root, "control.dummy").DummyRemote(
             nodeprobe.synthetic_responder(7)),
         "node_log_files": ["/var/log/db.log"]}
    t.update(kw)
    return t


def untimed_records(recs):
    return [{k: v for k, v in r.items() if k not in ("t", "clock_offset_s")}
            for r in recs if r["kind"] in ("gap", "breaker")]


def test_probe_quarantine_gaps_breakers_and_advisories_equal():
    def scenario(root):
        health, nodeprobe = (mod(root, "control.health"),
                             mod(root, "nodeprobe"))
        telemetry = mod(root, "telemetry")
        telemetry.reset()
        seen = []
        hr = health.HealthRegistry(threshold=1, cooldown_s=3600)
        synth = nodeprobe.synthetic_responder(7)

        def counting(node, action):
            seen.append(node)
            return synth(node, action)

        t = probe_test(root, health=hr,
                       remote=mod(root, "control.dummy").DummyRemote(
                           counting))
        p = nodeprobe.NodeProbe(t, interval_s=0.01)
        p.tick("n1")                       # closed: a sample
        n_before = len(seen)
        hr.breaker("n1").failure()         # circuit opens
        p.tick("n1")                       # quarantined: no traffic
        p.tick("n1")
        quiet = len(seen) == n_before
        hr.breaker("n1").success()         # healed
        p.tick("n1")
        st = p._states["n1"]
        sample = {"kind": "sample", "node": "n1", "t": 1,
                  "mem": {"total_kb": 1000, "free_kb": 10,
                          "used_frac": 0.99}, "cpu": {"busy": 0.999}}
        p._advise("n1", st, sample)
        p._advise("n1", st, sample)        # repeated: warned once
        p._advise("n1", st, {"kind": "sample", "mem": {}, "cpu": {}})
        p._advise("n1", st, sample)        # cleared, then warned again
        p.stop()
        recs = p.records()
        nodeprobe.validate_records(recs)
        return (untimed_records(recs), quiet, hr.advisories(),
                hr.quarantined(),
                {k: v for k, v in telemetry.get().counters().items()
                 if k.startswith(("control.", "nodeprobe.gaps"))})

    got = both(scenario)
    assert [r["kind"] for r in got[0]] == ["breaker", "breaker", "gap",
                                           "gap", "breaker"]
    assert got[1] is True
    assert got[4]["control.health.advisories"] == 4
