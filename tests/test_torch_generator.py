"""The port's generators against the JAX package's, op for op.

Every combinator scenario of tests/test_generator.py is built once from
each package's `generator` module and run through each package's
deterministic simulator (`quick`, `perfect`, `perfect_info`,
`imperfect`) with the same seed and context. The ops must be equal in
type, f, value, process and time: the comparison is exact (integers and
strings). The independent generators and the five workloads' generators
are held the same way, and the lock models to the JAX models' verdicts
on seeded histories of the in-memory lock client.
"""

from __future__ import annotations

import random

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu import testing as jtesting
from jepsen_tpu.checker import models as jmodels
from jepsen_tpu.generator import test_support as jsim
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.workloads import bank as jbank
from jepsen_tpu.workloads import lock as jlock
from jepsen_tpu.workloads import register as jregister
from jepsen_tpu.workloads import txn_append as jappend
from jepsen_tpu.workloads import txn_wr as jwr
from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch import independent as pind
from jepsen_tpu_torch import testing as ptesting
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.generator import test_support as psim
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.workloads import bank as pbank
from jepsen_tpu_torch.workloads import lock as plock
from jepsen_tpu_torch.workloads import register as pregister
from jepsen_tpu_torch.workloads import txn_append as pappend
from jepsen_tpu_torch.workloads import txn_wr as pwr

JAX = {"gen": jgen, "sim": jsim, "ind": jind, "register": jregister,
       "bank": jbank, "append": jappend, "wr": jwr, "lock": jlock,
       "testing": jtesting, "History": JHistory}
PORT = {"gen": pgen, "sim": psim, "ind": pind, "register": pregister,
        "bank": pbank, "append": pappend, "wr": pwr, "lock": plock,
        "testing": ptesting, "History": PHistory}

SIMULATORS = ("quick", "perfect", "perfect_info", "imperfect")
# no scenario may outlive this many invocations under any simulator
CAP = 60


def fields(ops) -> list[tuple]:
    return [(o.type, o.f, o.value, o.process, o.time) for o in ops]


def integers(**kv):
    x = 0
    while True:
        yield dict(value=x, **kv)
        x += 1


# Each scenario builds a fresh generator from one package's generator
# module; randomness it needs comes from its own seeded Random, so the two
# packages see the same draws.

def _promise(g):
    p = g.Promise()

    def updater(this, test, ctx, event):
        if event.type == "ok" and event.f == "write":
            p.deliver({"f": "confirm", "value": event.value})
        return this

    return g.on_threads({0, 1}, g.limit(5, g.on_update(
        updater, g.any_gen(p, [{"f": "read"}, {"f": "write", "value": "x"},
                               g.repeat({"f": "hold"})]))))


def _delayed(g):
    return g.clients(g.phases({"f": "write"}, {"f": "read"},
                              g.Delayed(lambda: g.limit(
                                  3, lambda test, ctx: {"f": "delayed"}))))


def _synchronize(g):
    def make(test, ctx):
        p = ctx.some_free_process()
        delay = {0: 2, 1: 1, "nemesis": 2}.get(p, 3)
        return {"f": "a", "process": p, "time": ctx.time + delay}

    return [g.limit(3, make), g.synchronize(g.repeat(2, {"f": "b"}))]


def _fn_random(g):
    rng = random.Random(5)
    return g.limit(5, lambda: {"f": "write", "value": rng.randint(0, 9)})


def _fn_repeat(g):
    rng = random.Random(6)
    return g.limit(5, lambda: g.repeat({"f": "write",
                                        "value": rng.randint(0, 9)}))


SCENARIOS = {
    "nil": lambda g: None,
    "map-once": lambda g: {"f": "write"},
    "repeat-map": lambda g: g.repeat(6, {"f": "write"}),
    "limit": lambda g: g.limit(2, g.repeat({"f": "write", "value": 1})),
    "repeat-iterator": lambda g: g.repeat(
        3, ({"value": x} for x in range(100))),
    "delay": lambda g: g.limit(5, g.delay(3e-9, g.repeat({"f": "write"}))),
    "seq-vectors": lambda g: [{"value": 1}, {"value": 2}, {"value": 3}],
    "seq-nested": lambda g: [[{"value": 1}, {"value": 2}],
                             [[{"value": 3}], {"value": 4}], {"value": 5}],
    "seq-until-ok": lambda g: g.clients(g.limit(CAP, [
        g.until_ok(g.repeat({"f": "read"})), {"f": "done"}])),
    "fn-nil": lambda g: (lambda: None),
    "fn-random-map": _fn_random,
    "fn-repeat-map": _fn_repeat,
    "on-update-promise": _promise,
    "delayed": _delayed,
    "synchronize": _synchronize,
    "clients": lambda g: g.limit(5, g.clients(g.repeat({}))),
    "nemesis": lambda g: g.nemesis(g.limit(3, g.repeat({"f": "break"}))),
    "phases": lambda g: g.clients(g.phases(g.repeat(2, {"f": "a"}),
                                           g.repeat(1, {"f": "b"}),
                                           g.repeat(3, {"f": "c"}))),
    "then": lambda g: g.clients(g.then(g.repeat(2, {"f": "b"}),
                                       g.repeat(2, {"f": "a"}))),
    "any": lambda g: g.limit(4, g.any_gen(
        g.on_threads({0}, g.delay(20e-9, g.repeat({"f": "a"}))),
        g.on_threads({1}, g.delay(20e-9, g.repeat({"f": "b"}))))),
    "each-thread": lambda g: g.each_thread([{"f": "a"}, {"f": "b"}]),
    "each-thread-exhausted": lambda g: g.each_thread(
        g.limit(0, {"f": "read"})),
    "stagger": lambda g: g.stagger(20e-9, [{"f": "write", "value": x}
                                           for x in range(50)]),
    "f-map": lambda g: g.f_map({"a": "b"}, {"f": "a", "value": 2}),
    "gmap": lambda g: g.limit(6, g.gmap(
        lambda o: o.copy(value=(o.value or 0) + 100),
        ({"f": "w", "value": x} for x in range(100)))),
    "filter": lambda g: g.gfilter(lambda o: o.value % 2 == 0, g.limit(
        10, ({"value": x} for x in range(100)))),
    "log": lambda g: g.phases(g.log("first"), {"f": "a"}, g.log("second"),
                              {"f": "b"}),
    "mix": lambda g: g.mix([g.repeat(5, {"f": "a"}),
                            g.repeat(10, {"f": "b"})]),
    "process-limit": lambda g: g.limit(CAP, g.clients(g.process_limit(
        5, ({"value": x} for x in range(100))))),
    # (quick never advances the clock: CAP bounds it there)
    "time-limit": lambda g: g.limit(CAP, [
        g.time_limit(20e-9, g.repeat({"value": "a"})),
        g.time_limit(10e-9, g.repeat({"value": "b"}))]),
    "reserve-default": lambda g: g.limit(3, g.reserve(integers(f="a"))),
    "reserve-ranges": lambda g: g.limit(15, g.reserve(
        2, integers(f="a"), 3, integers(f="b"), integers(f="c"))),
    "until-ok": lambda g: g.limit(CAP, g.clients(
        g.until_ok(g.repeat({"f": "read"})))),
    "flip-flop": lambda g: g.limit(5, g.flip_flop(
        ({"f": "a", "value": x} for x in range(100)),
        [{"f": "b", "value": 0}, {"f": "b", "value": 1}])),
    "concat": lambda g: [g.limit(2, integers(f="a")),
                         g.limit(2, integers(f="b"))],
    "cycle": lambda g: g.cycle(g.limit(2, integers(f="a")), times=2),
    "cycle-times": lambda g: g.limit(12, g.on_threads({0}, g.cycle_times(
        5e-9, g.repeat({"f": "a"}), 10e-9, g.repeat({"f": "b"})))),
    "once-sleep": lambda g: g.clients([g.log("hello"),
                                       {"f": "write", "value": 1},
                                       g.once(g.sleep(1e-8)),
                                       {"f": "read"}]),
    "fn-constant-depth": lambda g: g.limit(
        500, lambda: {"f": "w", "value": 1}),
    "trace": lambda g: g.trace("t", g.limit(3, g.repeat({"f": "x"}))),
}

# the scenarios that need a wider context than the default two threads
CONTEXTS = {"reserve-ranges": 5}


def _context(pkg, name: str):
    n = CONTEXTS.get(name)
    return (pkg["sim"].n_plus_nemesis_context(n) if n is not None
            else None)


def _simulate(pkg, name: str, sim: str):
    g = SCENARIOS[name](pkg["gen"])
    return fields(getattr(pkg["sim"], sim)(g, ctx=_context(pkg, name)))


@pytest.mark.parametrize("sim", SIMULATORS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_combinator_ops_equal(name, sim):
    want = _simulate(JAX, name, sim)
    got = _simulate(PORT, name, sim)
    assert got == want
    assert len(got) <= 2 * 500 + CAP


@pytest.mark.parametrize("sim", SIMULATORS)
def test_seeded_context_rng(sim):
    """test["seed"] installs a per-test RNG in the context (context.py
    :120-124): mix's choices and stagger's jitter draw from it, not from
    the fallback the simulator seeds."""
    def build(g):
        return g.limit(40, g.stagger(1e-8, g.mix(
            [g.repeat({"f": "a"}), g.repeat({"f": "b"}),
             g.repeat({"f": "c"})])))

    out = {}
    for label, pkg in (("jax", JAX), ("port", PORT)):
        ctx = pkg["gen"].context({"concurrency": 3, "seed": 7})
        out[label] = fields(getattr(pkg["sim"], sim)(build(pkg["gen"]),
                                                     ctx=ctx))
    assert out["port"] == out["jax"]
    ctx8 = PORT["gen"].context({"concurrency": 3, "seed": 8})
    other = fields(getattr(PORT["sim"], sim)(build(PORT["gen"]), ctx=ctx8))
    assert other != out["port"]


def test_seeded_context_op_by_op():
    """The per-test RNG straight through gen.op, without the simulator:
    two seeded tests keep their own schedules in both packages."""
    def schedule(pkg, seed):
        g = pkg["gen"]
        test = {"concurrency": 3, "seed": seed}
        ctx = g.context(test)
        mix = g.mix([g.repeat({"f": "a"}), g.repeat({"f": "b"}),
                     g.repeat({"f": "c"})])
        out = []
        for _ in range(30):
            o, mix = g.op(mix, test, ctx)
            out.append((o.f, o.process, o.time))
        return out

    for seed in (7, 8):
        assert schedule(PORT, seed) == schedule(JAX, seed)


def test_invalid_ops_and_generator_errors_raise_alike():
    for pkg in (JAX, PORT):
        g = pkg["gen"]

        class Bad(g.Generator):
            def op(self, test, ctx):
                return _bad_op(pkg), None

        with pytest.raises(g.InvalidOp):
            pkg["sim"].quick(Bad())

        def boom():
            raise ValueError("boom")

        with pytest.raises(g.GeneratorError):
            g.op(g.friendly_exceptions(boom), {},
                 pkg["sim"].default_context())


def _bad_op(pkg):
    from jepsen_tpu.history import Op as JOp
    from jepsen_tpu_torch.history import Op as POp

    cls = JOp if pkg is JAX else POp
    return cls(type="bogus", process=0, time=0)


def test_context_operations_agree():
    out = {}
    for label, pkg in (("jax", JAX), ("port", PORT)):
        ctx = pkg["sim"].n_plus_nemesis_context(3)
        trail = [ctx.some_free_process()]
        ctx = ctx.busy_thread(5, 0)
        trail.append(ctx.some_free_process())
        ctx = ctx.with_next_process(1)
        trail += [ctx.thread_to_process(1), ctx.process_to_thread_name(4),
                  sorted(map(str, ctx.free_processes()))]
        ctx = ctx.free_thread(9, 0)
        f = pkg["gen"].make_thread_filter(
            pkg["gen"].all_but("nemesis"), ctx)
        trail += [sorted(map(str, f(ctx).all_thread_names())), ctx.time]
        out[label] = trail
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# Independent generators
# ---------------------------------------------------------------------------

INDEPENDENT = {
    "sequential": (lambda p: p["ind"].sequential_generator(
        ["a", "b", "c"], lambda k: p["gen"].limit(
            4, lambda: {"f": "read"})), 2),
    "concurrent": (lambda p: p["ind"].concurrent_generator(
        2, list(range(5)), lambda k: p["gen"].limit(
            6, lambda: {"f": "read"})), 4),
    "concurrent-mixed": (lambda p: p["ind"].concurrent_generator(
        3, list(range(7)), lambda k: p["register"].key_gen(
            k, ops_per_key=9, seed=3)), 6),
}


@pytest.mark.parametrize("sim", ("quick", "perfect", "imperfect"))
@pytest.mark.parametrize("name", sorted(INDEPENDENT))
def test_independent_generators_equal(name, sim):
    build, n = INDEPENDENT[name]
    got = {}
    for label, pkg in (("jax", JAX), ("port", PORT)):
        g = pkg["gen"].clients(build(pkg))
        got[label] = fields(getattr(pkg["sim"], sim)(
            g, ctx=pkg["sim"].n_plus_nemesis_context(n)))
    assert got["port"] == got["jax"]
    assert got["port"]


# ---------------------------------------------------------------------------
# The workloads' generators
# ---------------------------------------------------------------------------

WORKLOADS = {
    "register": (lambda p: p["register"].workload(
        {"keys": list(range(6)), "group-size": 3, "ops_per_key": 20,
         "seed": 8, "device": "cpu"}), 6),
    "bank": (lambda p: p["bank"].workload(
        {"accounts": list(range(5)), "ops": 80, "seed": 11,
         "device": "cpu"}), 4),
    "txn-append": (lambda p: p["append"].workload(
        {"ops": 80, "seed": 9, "device": "cpu"}), 4),
    "txn-wr": (lambda p: p["wr"].workload(
        {"ops": 80, "seed": 9, "device": "cpu"}), 4),
    "lock": (lambda p: p["lock"].lock_workload({"ops": 40}), 3),
    "owner-lock": (lambda p: p["lock"].owner_lock_workload(
        {"ops": 40}), 3),
    "fenced-lock": (lambda p: p["lock"].fenced_lock_workload(
        {"ops": 40}), 3),
    "reentrant-lock": (lambda p: p["lock"].reentrant_lock_workload(
        {"ops": 40, "limit": 3}), 3),
    "semaphore": (lambda p: p["lock"].semaphore_workload(
        {"ops": 40, "permits": 2}), 3),
}


@pytest.mark.parametrize("sim", ("quick", "perfect", "imperfect"))
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_generators_equal(name, sim):
    build, n = WORKLOADS[name]
    got = {}
    for label, pkg in (("jax", JAX), ("port", PORT)):
        w = build(pkg)
        got[label] = fields(getattr(pkg["sim"], sim)(
            pkg["gen"].clients(w["generator"]),
            ctx=pkg["sim"].n_plus_nemesis_context(n)))
    assert got["port"] == got["jax"]
    assert len([o for o in got["port"] if o[0] == "invoke"]) > 10


# ---------------------------------------------------------------------------
# Lock models: the same verdicts on seeded histories
# ---------------------------------------------------------------------------

LOCK_CASES = {
    # name: (workload, client kwargs, state permits, concurrency)
    "plain": ("lock_workload", {"fences": False}, 1, 4),
    "owner": ("owner_lock_workload", {"fences": False}, 1, 4),
    "fenced": ("fenced_lock_workload", {}, 1, 4),
    "stolen-owner": ("owner_lock_workload",
                     {"fences": False, "steal_every": 3}, 1, 4),
    "stale-fence": ("fenced_lock_workload", {"steal_every": 3}, 1, 4),
    "reentrant": ("reentrant_lock_workload", {"reentrant_limit": 2}, 1, 4),
    "non-reentrant-service": ("reentrant_lock_workload",
                              {"reentrant_limit": 1}, 1, 4),
    "semaphore": ("semaphore_workload", {"semaphore": True}, 2, 4),
    "overgranting-semaphore": ("semaphore_workload", {"semaphore": True},
                               3, 6),
}


def _lock_history(pkg, name: str, ops: int):
    """A seeded lock history: the workload's generator through the
    simulator, each invocation completed by the in-memory lock client of
    the same package (single-threaded, so the history is a function of
    the seed)."""
    wl, kw, permits, conc = LOCK_CASES[name]
    t = pkg["testing"]
    opts = {"ops": ops, "permits": 2, "device": "cpu"}
    w = getattr(pkg["lock"], wl)(opts)
    client = t.LockClient(t.LockState(permits=permits), **kw).open({}, None)

    def complete(ctx, inv):
        return client.invoke({}, inv).copy(time=inv.time + 7)

    ops_ = pkg["sim"].simulate(pkg["gen"].clients(w["generator"]),
                               complete,
                               ctx=pkg["sim"].n_plus_nemesis_context(conc),
                               seed=ops)
    return w["checker"], pkg["History"](ops_)


@pytest.mark.parametrize("name", sorted(LOCK_CASES))
def test_lock_models_agree(name):
    ops = 120 if "semaphore" in name else 80
    jc, jh = _lock_history(JAX, name, ops)
    pc, ph = _lock_history(PORT, name, ops)
    assert fields(ph) == fields(jh)
    jres = jc.check({}, jh)
    pres = pc.check({}, ph)
    assert pres["valid?"] == jres["valid?"]
    # the plain mutex is tabulable and takes the search kernel (the JAX
    # package names its analyzer "tpu", the port "gpu"); the owner-aware
    # models step on op.process and take the host object-model search
    want = "model" if name not in ("plain",) else "gpu"
    assert pres.get("analyzer") == want
    assert jres.get("analyzer") == want.replace("gpu", "tpu")
    if name.startswith(("plain", "owner", "fenced", "reentrant",
                        "semaphore", "non-")):
        assert pres["valid?"] is True
    # and each model checks the other package's history the same way
    assert pc.check({}, PHistory([o.to_dict() for o in jh]))["valid?"] \
        == jres["valid?"]


def test_faulty_lock_services_are_caught():
    """The seeded faulty services of tests/test_new_workloads.py:37-95
    are invalid under both packages' models."""
    for name in ("stolen-owner", "stale-fence", "overgranting-semaphore"):
        jc, jh = _lock_history(JAX, name, 140)
        pc, ph = _lock_history(PORT, name, 140)
        assert jc.check({}, jh)["valid?"] is False, name
        assert pc.check({}, ph)["valid?"] is False, name


@pytest.mark.parametrize("model", ("OwnerMutex", "FencedMutex",
                                   "ReentrantMutex", "Semaphore"))
def test_lock_model_steps_agree(model):
    """Stepping each model over a seeded op sequence gives the same
    states and inconsistencies in both packages."""
    from jepsen_tpu.history import Op as JOp
    from jepsen_tpu_torch.history import Op as POp

    rng = random.Random(model)
    seq = []
    fence = 0
    for _ in range(60):
        f = rng.choice(["acquire", "release"])
        fence += rng.choice([1, 1, 0, -1])
        seq.append(dict(type="ok", process=rng.randrange(3), f=f,
                        value={"fence": fence} if f == "acquire"
                        else None))
    out = {}
    for label, mod, models, Op in (("jax", jlock, jmodels, JOp),
                                   ("port", plock, pmodels, POp)):
        m = getattr(mod, model)()
        trail = []
        for d in seq:
            m2 = m.step(Op(**d))
            trail.append(repr(m2))
            if not models.is_inconsistent(m2):
                m = m2
        out[label] = trail
    assert out["port"] == out["jax"]
