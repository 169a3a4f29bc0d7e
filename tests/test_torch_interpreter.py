"""The port's interpreter, against the semantics of
tests/test_interpreter.py:35-115 and against the JAX package's
interpreter, and its trace recorder against the JAX package's reader.

Worker threads make a run's interleaving depend on timing, so the
scenarios check invariants (dense indices, monotonic times, every
invoke paired, crash -> :info and a new process, :sleep/:log not
journaled, nemesis ops routed). At concurrency 1 with a deterministic
client the interleaving is fixed, and the port's run must give the JAX
package's (type, f, value, process) sequence exactly. No timing floors.
"""

from __future__ import annotations

import random
from pathlib import Path

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu import interpreter as jinterp
from jepsen_tpu import testing as jtesting
from jepsen_tpu import tracing as jtracing
from jepsen_tpu import util as jutil
from jepsen_tpu_torch import client as pclient
from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch import interpreter as pinterp
from jepsen_tpu_torch import nemesis as pnemesis
from jepsen_tpu_torch import telemetry as ptelemetry
from jepsen_tpu_torch import testing as ptesting
from jepsen_tpu_torch import tracing as ptracing
from jepsen_tpu_torch import util as putil

JAX = {"gen": jgen, "interp": jinterp, "testing": jtesting,
       "util": jutil, "tracing": jtracing}
PORT = {"gen": pgen, "interp": pinterp, "testing": ptesting,
        "util": putil, "tracing": ptracing}


def base_test(pkg, **kw):
    t = pkg["testing"].noop_test()
    t["concurrency"] = 4
    t.update(kw)
    return t


def run_interp(pkg, test):
    with pkg["util"].with_relative_time():
        return pkg["interp"].run(dict(test))


def test_basic_run_produces_history():
    n = 50
    t = base_test(PORT, client=pclient.noop, generator=pgen.clients(
        pgen.limit(n, pgen.repeat({"f": "write", "value": 1}))))
    hist = run_interp(PORT, t)["history"]
    assert len(hist) == 2 * n
    invokes = [o for o in hist if o.type == "invoke"]
    assert len(invokes) == n
    assert len([o for o in hist if o.type == "ok"]) == n
    # dense indices in order, monotonic times, every invoke paired
    assert [o.index for o in hist] == list(range(2 * n))
    times = [o.time for o in hist]
    assert times == sorted(times)
    pair = hist.pair_index()
    assert all(pair[o.index] >= 0 for o in invokes)


class CrashingClient(pclient.Client):
    def open(self, test, node):
        return self

    def invoke(self, test, op):
        raise RuntimeError("kaboom")


def test_crash_becomes_info_and_new_process():
    n = 6
    t = base_test(PORT, concurrency=1, client=CrashingClient(),
                  generator=pgen.on_threads({0}, pgen.limit(
                      n, pgen.repeat({"f": "write", "value": 1}))))
    ptelemetry.reset()
    hist = run_interp(PORT, t)["history"]
    infos = [o for o in hist if o.type == "info"]
    assert len(infos) == n
    assert all(o.get("error") == "indeterminate: kaboom" for o in infos)
    # each crash reincarnates the process: 0, 1, 2, ... (one int thread)
    procs = [o.process for o in hist if o.type == "invoke"]
    assert procs == list(range(n))
    c = ptelemetry.get().counters()
    assert c["interpreter.worker-crashes"] == n
    assert c["interpreter.dispatched"] == n


def test_sleep_and_log_not_in_history():
    t = base_test(PORT, client=pclient.noop, generator=pgen.clients([
        pgen.log("hello"), {"f": "write", "value": 1},
        pgen.once(pgen.sleep(0.01))]))
    hist = run_interp(PORT, t)["history"]
    assert all(o.type not in ("sleep", "log") for o in hist)
    assert len(hist) == 2


def test_nemesis_ops_routed():
    class Nem(pnemesis.Nemesis):
        def __init__(self):
            self.seen = []

        def invoke(self, test, op):
            self.seen.append(op.f)
            return op.copy(type="info")

    nem = Nem()
    t = base_test(PORT, client=pclient.noop, nemesis=nem,
                  generator=pgen.nemesis(
                      pgen.limit(2, [{"f": "start"}, {"f": "stop"}])))
    hist = run_interp(PORT, t)["history"]
    assert nem.seen == ["start", "stop"]
    nem_ops = [o for o in hist if o.process == "nemesis"]
    assert len(nem_ops) == 4  # 2 invokes + 2 infos
    # a nemesis :info does not reincarnate the nemesis process
    assert {o.process for o in nem_ops} == {"nemesis"}


def test_validated_client_rejects_a_bad_completion():
    """ClientWorker validates the client: a completion that changes f
    crashes the op to :info, as in the reference."""
    class Bad(pclient.Client):
        def invoke(self, test, op):
            return op.copy(type="ok", f="other")

    t = base_test(PORT, concurrency=1, client=Bad(),
                  generator=pgen.clients(pgen.limit(3, {"f": "w"})))
    hist = run_interp(PORT, t)["history"]
    assert [o.type for o in hist] == ["invoke", "info"]
    assert "f should be the same" in hist[1].get("error")


def test_monitor_and_watchdog_hooks():
    """The optional duck-typed hooks: the monitor sees every dispatch and
    completion, and a tripped watchdog with early_abort stops the run."""
    class Monitor:
        def __init__(self):
            self.events = []

        def on_dispatch(self, op, thread, now):
            self.events.append(("dispatch", op.index))

        def on_complete(self, op, thread, now):
            self.events.append(("complete", op.index))

        def on_stall(self):
            self.events.append(("stall",))

    class Watchdog:
        early_abort = True

        def __init__(self):
            self.tripped = False
            self.seen = 0

        def observe(self, op):
            self.seen += 1
            if op.type == "ok" and op.value == 3:
                self.tripped = True

    mon, wd = Monitor(), Watchdog()
    t = base_test(PORT, concurrency=1, client=pclient.noop,
                  monitor=mon, watchdog=wd,
                  generator=pgen.clients([{"f": "w", "value": v}
                                          for v in range(10)]))
    out = run_interp(PORT, t)
    assert out["aborted"] == "watchdog"
    assert len(out["history"]) == 8  # through the ok of value 3
    assert wd.seen == 8
    assert [e for e in mon.events if e[0] != "stall"] == [
        (k, i) for i in range(8) for k in ("dispatch", "complete")
        if (k == "dispatch") == (i % 2 == 0)]


# ---------------------------------------------------------------------------
# Against the JAX package's interpreter
# ---------------------------------------------------------------------------

def _ops(seed: int, n: int) -> list[dict]:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.4:
            out.append({"f": "read"})
        elif r < 0.7:
            out.append({"f": "write", "value": rng.randint(0, 4)})
        else:
            out.append({"f": "cas", "value": [rng.randint(0, 4),
                                              rng.randint(0, 4)]})
    return out


def flaky_atom(pkg):
    """An atom register client of either package that crashes every 7th
    op."""
    class FlakyAtom(pkg["testing"].AtomClient):
        n = 0

        def invoke(self, test, op):
            FlakyAtom.n += 1
            if FlakyAtom.n % 7 == 0:
                raise RuntimeError("flaky")
            return super().invoke(test, op)

    return FlakyAtom(pkg["testing"].AtomState(0), latency_s=0)


@pytest.mark.parametrize("case", ("atom", "atom-crashing", "sleep-log"))
def test_concurrency_one_matches_the_jax_interpreter(case):
    out = {}
    for label, pkg in (("jax", JAX), ("port", PORT)):
        g = pkg["gen"]
        if case == "atom":
            client = pkg["testing"].AtomClient(
                pkg["testing"].AtomState(0), latency_s=0)
            gen = g.clients(g.limit(60, _ops(11, 100)))
        elif case == "atom-crashing":
            client = flaky_atom(pkg)
            gen = g.clients(g.limit(60, _ops(12, 100)))
        else:
            client = pkg["testing"].AtomClient(
                pkg["testing"].AtomState(0), latency_s=0)
            gen = g.clients([g.log("a"), {"f": "write", "value": 2},
                             g.once(g.sleep(0.001)), {"f": "read"},
                             g.log("b"), {"f": "cas", "value": [2, 3]},
                             {"f": "read"}])
        t = base_test(pkg, concurrency=1, client=client, generator=gen)
        hist = run_interp(pkg, t)["history"]
        out[label] = [(o.type, o.f, o.value, o.process) for o in hist]
        assert [o.index for o in hist] == list(range(len(hist)))
    assert out["port"] == out["jax"]
    assert out["port"]


# ---------------------------------------------------------------------------
# The trace recorder
# ---------------------------------------------------------------------------

def _traced_run(pkg, store: Path, n: int = 40):
    """A traced run: the lifecycle the JAX package's core.run wires
    (reset enabled, open optrace.jsonl, run, flush, close)."""
    tr = pkg["tracing"].get()
    tr.reset(enabled=True)
    try:
        tr.open(store / pkg["tracing"].TRACE_FILE)
        g = pkg["gen"]
        state = pkg["testing"].KVState()
        t = base_test(pkg, concurrency=4,
                      client=pkg["testing"].KVClient(state, latency_s=0),
                      generator=g.clients(g.limit(n, [
                          {"f": "write", "value": (i % 3, i)}
                          if i % 2 else {"f": "read", "value": (i % 3, None)}
                          for i in range(n)])))
        hist = run_interp(pkg, t)["history"]
        tr.flush()
    finally:
        tr.reset(enabled=False)
    return hist


def test_port_trace_read_by_the_jax_package(tmp_path):
    hist = _traced_run(PORT, tmp_path)
    path = tmp_path / "optrace.jsonl"
    recs = list(jtracing.read_records(path))
    assert jtracing.validate_records(recs) == len(recs)
    assert ptracing.validate_records(recs) == len(recs)
    by_op = jtracing.by_op(recs)
    invokes = [o.index for o in hist if o.type == "invoke"]
    # one op span per invocation and a client call span under it (the
    # first op of a process also opens its client: client.open)
    assert sorted(by_op) == invokes
    for i in invokes:
        names = sorted(r["name"] for r in by_op[i] if r["kind"] == "client")
        f = hist[i].f
        assert names in ([f"client.{f}"], ["client.open", f"client.{f}"])
        op_rec = [r for r in by_op[i] if r["kind"] == "op"]
        assert len(op_rec) == 1 and op_rec[0]["status"] == "ok"
    assert ptracing.by_op(recs) == by_op


def test_jax_trace_read_by_the_port(tmp_path):
    hist = _traced_run(JAX, tmp_path)
    recs = list(ptracing.read_records(tmp_path / "optrace.jsonl"))
    assert ptracing.validate_records(recs) == len(recs) > 0
    assert sorted(ptracing.by_op(recs)) == [
        o.index for o in hist if o.type == "invoke"]
    assert ptracing.by_op(recs) == jtracing.by_op(recs)


def test_tracer_records_are_off_by_default_and_validated():
    tr = ptracing.Tracer()
    with tr.op_span(pclient_op(3)) as rec:
        assert rec is None
    tr.reset(enabled=True)
    with tr.op_span(pclient_op(3)) as root:
        with tr.span("client", "client.read", node="n1") as child:
            tr.annotate(retries=2)
        tr.event("reconnect", node="n1")
    tr.event("context-free")
    recs = tr.records()
    assert ptracing.validate_records(recs) == 4
    assert jtracing.validate_records(recs) == 4
    assert child["parent"] == root["span"]
    assert child["attrs"] == {"node": "n1", "retries": 2}
    bad = [dict(recs[0], t1=-1)]
    with pytest.raises(ValueError):
        ptracing.validate_records(bad)


def pclient_op(index):
    from jepsen_tpu_torch.history import Op

    return Op(index=index, type="invoke", process=0, f="read")


def test_telemetry_spans_ride_the_relative_clock():
    with putil.with_relative_time():
        ptelemetry.reset()
        with ptelemetry.span("x"):
            pass
        sp = ptelemetry.get().spans()[-1]
        assert 0 <= sp["t0"] <= sp["t1"] <= putil.relative_time_nanos()
    e0 = ptelemetry.get().epoch
    ptelemetry.reset()
    assert ptelemetry.get().epoch == e0 + 1
