"""Parity of the port's composition layer (jepsen_tpu_torch/checker:
check_safe, Compose, ConcurrencyLimit and the small checkers) and of
util.timeout with the JAX package's on the CPU: the merge of the
sub-results' verdicts, the crash-surviving partial_results sink, the
resume of recorded results, a raising and a hung checker, and the
telemetry both count. Results are compared exactly, except a traceback's
text, which names each package's own files."""

import sys
import threading
import time

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import telemetry as jtel
from jepsen_tpu import util as jutil
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import op as jop
from jepsen_tpu_torch import checker as pchecker
from jepsen_tpu_torch import telemetry as ptel
from jepsen_tpu_torch import util as putil
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import op as pop

PKGS = {"jax": (jchecker, jtel, JHistory, jop),
        "port": (pchecker, ptel, PHistory, pop)}


def both(fn):
    """fn(package's checker module, telemetry, History, op) for each
    package, telemetry reset before each: (JAX result, port result)."""
    out = []
    for name in ("jax", "port"):
        chk, tel, History, op = PKGS[name]
        tel.reset()
        out.append(fn(chk, tel, History, op))
    return tuple(out)


def tiny(History, op):
    return History([op(type="invoke", process=0, f="read", value=None),
                    op(type="ok", process=0, f="read", value=1)])


class Sink:
    """A partial_results sink recording every put."""

    def __init__(self, fail_on=()):
        self.puts, self.fail_on = [], set(fail_on)
        self._lock = threading.Lock()

    def put(self, name, result):
        if name in self.fail_on:
            raise OSError("sink full")
        with self._lock:
            self.puts.append((name, result))


VALIDS = [True, False, "unknown", None]


@pytest.mark.parametrize("a", VALIDS, ids=str)
@pytest.mark.parametrize("b", VALIDS, ids=str)
def test_compose_merges_verdicts(a, b):
    def run(chk, tel, History, op):
        def fixed(v):
            return chk.checker(lambda t, h, o: None if v is None
                               else {"valid?": v, "n": 1})
        return chk.compose({"a": fixed(a), "b": fixed(b),
                            "ok": chk.unbridled_optimism(),
                            "nothing": chk.noop()}).check(
            {}, tiny(History, op))

    jres, pres = both(run)
    assert pres == jres
    assert pres["valid?"] == jchecker.merge_valid([a, b])


def test_merge_valid():
    for vs in ([], [True], [True, "unknown"], ["unknown", False, True],
               [None, True], [False, "unknown"]):
        assert pchecker.merge_valid(vs) == jchecker.merge_valid(vs)


def test_partial_results_sink_gets_every_result():
    def run(chk, tel, History, op):
        sink = Sink()
        res = chk.compose({
            "x": chk.checker(lambda t, h, o: {"valid?": True, "k": 1}),
            "y": chk.checker(lambda t, h, o: {"valid?": False}),
            "z": chk.unbridled_optimism()}).check(
            {}, tiny(History, op), {"partial_results": sink})
        return res, sorted(sink.puts, key=lambda p: p[0])

    (jres, jputs), (pres, pputs) = both(run)
    assert (pres, pputs) == (jres, jputs)
    assert [n for n, _ in pputs] == ["x", "y", "z"]


def test_a_failing_sink_never_sinks_the_check(caplog):
    def run(chk, tel, History, op):
        sink = Sink(fail_on={"y"})
        res = chk.compose({"x": chk.unbridled_optimism(),
                           "y": chk.unbridled_optimism()}).check(
            {}, tiny(History, op), {"partial_results": sink})
        return res, sorted(n for n, _ in sink.puts)

    jres, pres = both(run)
    assert pres == jres == ({"x": {"valid?": True}, "y": {"valid?": True},
                             "valid?": True}, ["x"])
    assert "writing partial result failed" in caplog.text


def test_resume_results_skip_the_checker():
    def run(chk, tel, History, op):
        calls = []
        sink = Sink()

        def counted(t, h, o):
            calls.append(1)
            return {"valid?": True}

        res = chk.compose({"done": chk.checker(counted),
                           "todo": chk.checker(counted)}).check(
            {}, tiny(History, op),
            {"resume_results": {"done": {"valid?": False, "old": 1}},
             "partial_results": sink})
        return (res, len(calls), tel.get().counters().get(
            "checker.resumed"), sorted(n for n, _ in sink.puts))

    jres, pres = both(run)
    assert pres == jres
    assert pres == ({"done": {"valid?": False, "old": 1},
                     "todo": {"valid?": True}, "valid?": False}, 1, 1,
                    ["done", "todo"])


def test_nested_compose_does_not_inherit_the_sink():
    def run(chk, tel, History, op):
        sink = Sink()
        seen = []

        def look(t, h, o):
            seen.append(sorted(o))
            return {"valid?": True}

        inner = chk.compose({"stats": chk.checker(look),
                             "w": chk.unbridled_optimism()})
        res = chk.compose({"workload": inner,
                           "stats": chk.unbridled_optimism()}).check(
            {}, tiny(History, op),
            {"partial_results": sink, "resume_results": {},
             "subdirectory": "s"})
        return res, sorted(n for n, _ in sink.puts), seen

    jres, pres = both(run)
    assert pres == jres
    assert pres[1] == ["stats", "workload"]
    assert pres[2] == [["subdirectory"]]


def test_composed_checkers_record_spans():
    ptel.reset()
    pchecker.compose({"a": pchecker.unbridled_optimism(),
                      "b": pchecker.noop()}).check(
        {}, tiny(PHistory, pop))
    names = sorted(s["name"] for s in ptel.get().spans())
    assert names == ["checker:a", "checker:b"]


def test_a_raising_checker_gives_unknown_with_its_traceback():
    def run(chk, tel, History, op):
        def boom(t, h, o):
            raise ValueError("no such key")

        res = chk.compose({"bad": chk.checker(boom),
                           "good": chk.unbridled_optimism()}).check(
            {}, tiny(History, op))
        err = res["bad"].pop("error")
        assert "ValueError: no such key" in err and "Traceback" in err
        return res

    jres, pres = both(run)
    assert pres == jres == {"bad": {"valid?": "unknown"},
                            "good": {"valid?": True}, "valid?": "unknown"}


@pytest.mark.parametrize("where", ["test", "opts"])
def test_a_hung_checker_times_out(where):
    release = threading.Event()

    def run(chk, tel, History, op):
        def hang(t, h, o):
            release.wait(5)
            return {"valid?": True}

        test = {"checker_timeout_s": 0.2} if where == "test" else {}
        opts = {"checker_timeout_s": 0.2} if where == "opts" else {}
        t0 = time.monotonic()
        res = chk.compose({"hung": chk.checker(hang),
                           "fast": chk.unbridled_optimism()}).check(
            test, tiny(History, op), opts)
        assert time.monotonic() - t0 < 3
        return res, tel.get().counters().get("checker.timeouts")

    try:
        jres, pres = both(run)
    finally:
        release.set()
    assert pres == jres == ({"hung": {"valid?": "unknown",
                                      "error": "checker timed out after "
                                               "0.2s"},
                             "fast": {"valid?": True},
                             "valid?": "unknown"}, 1)


def test_check_safe_with_a_timeout_that_does_not_fire():
    def run(chk, tel, History, op):
        ok = chk.check_safe(chk.unbridled_optimism(), {},
                            tiny(History, op), timeout_s=5)
        bad = chk.check_safe(chk.checker(lambda t, h, o: 1 / 0), {},
                             tiny(History, op), timeout_s=5)
        return ok, bad["valid?"], "ZeroDivisionError" in bad["error"]

    jres, pres = both(run)
    assert pres == jres == ({"valid?": True}, "unknown", True)


@pytest.mark.parametrize("test,opts", [
    ({}, None), ({"checker_timeout_s": 3}, None),
    ({"checker_timeout_s": 3}, {"checker_timeout_s": 1.5}),
    ({"checker_timeout_s": 0}, {}), ("not a map", {})])
def test_checker_timeout_s(test, opts):
    assert pchecker.checker_timeout_s(test, opts) == \
        jchecker.checker_timeout_s(test, opts)


def test_util_timeout():
    release = threading.Event()
    try:
        for util in (jutil, putil):
            assert util.timeout(2, lambda: 7) == 7
            assert util.timeout(0.05, lambda: release.wait(5),
                                default="late") == "late"
            with pytest.raises(util.Timeout):
                util.timeout(0.05, lambda: release.wait(5))
            with pytest.raises(KeyError):
                util.timeout(2, lambda: {}["k"])
    finally:
        release.set()


def test_concurrency_limit_bounds_concurrent_checks():
    """More threads than cores, a short switch interval: the number of
    checks inside the limited checker never exceeds the limit."""
    limit, threads = 3, 24
    state = {"in": 0, "max": 0}
    lock = threading.Lock()

    def body(t, h, o):
        with lock:
            state["in"] += 1
            state["max"] = max(state["max"], state["in"])
        time.sleep(0.002)
        with lock:
            state["in"] -= 1
        return {"valid?": True}

    limited = pchecker.concurrency_limit(limit, pchecker.checker(body))
    hist = tiny(PHistory, pop)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=lambda: [
            limited.check({}, hist) for _ in range(5)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert state["in"] == 0 and 1 < state["max"] <= limit


def test_concurrency_limit_passes_results_through():
    def run(chk, tel, History, op):
        return chk.concurrency_limit(1, chk.checker(
            lambda t, h, o: {"valid?": False, "o": dict(o)})).check(
            {}, tiny(History, op), {"x": 1})

    jres, pres = both(run)
    assert pres == jres == {"valid?": False, "o": {"x": 1}}
