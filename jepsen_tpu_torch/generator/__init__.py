"""Purely functional operation generators (the port's copy of
jepsen_tpu/generator: the same combinators, drawing from the same RNGs in
the same order, so a seeded schedule is the JAX package's op for op).

Generators tell the framework what to do during a test. A generator
supports two functions:

  op(gen, test, ctx)  ->  None                 generator exhausted
                          (PENDING, gen')      can't tell yet
                          (op, gen')           next op + successor state

  update(gen, test, ctx, event) -> gen'        react to invoke/complete

Plain Python values are generators: dicts are one-shot ops, lists/tuples
run their elements in order, callables are invoked (with (test, ctx) or no
args) to produce generators repeatedly until they return None, and Python
iterators/generator-objects are consumed lazily.

Capability reference: jepsen/src/jepsen/generator.clj (protocol 408-416,
default impls 560-612, fill-in-op 500-537, combinators 644-1608). The
semantics here track the reference's docstring spec (generator.clj:1-200)
combinator-for-combinator; the implementation is new (Python value
dispatch + int-bitset contexts rather than protocol extension over JVM
types).
"""

from __future__ import annotations

import inspect
import logging
import random as _random
import weakref

from .. import util
from ..history import Op
from .context import (AllBut, Context, NEMESIS, all_but, make_thread_filter,
                      truthy)

logger = logging.getLogger(__name__)

# Public sentinel: "I might have an op later, but not yet."
PENDING = "pending"

# Module fallback RNG, used when the context carries no "rng". Tests
# that set test["seed"] get a per-test RNG installed by
# Context.for_test(test), so two concurrent seeded tests in one
# process can't perturb each other's schedules; seedless tests share
# this fallback, which set_seed controls (the simulator relies on it).
_rng = _random.Random()


def set_seed(seed) -> None:
    """Seeds the fallback generator-scheduling RNG (mix choice, stagger
    jitter, soonest-op tie-breaks). Setting test["seed"] instead scopes
    determinism to that one test's context."""
    _rng.seed(seed)


def _ctx_rng(ctx):
    """The context's per-test RNG, else the module fallback."""
    r = ctx.get("rng") if ctx is not None else None
    return r if r is not None else _rng


# ---------------------------------------------------------------------------
# Context helpers re-exported (generator.clj import-vars)
# ---------------------------------------------------------------------------

def context(test) -> Context:
    return Context.for_test(test)


def all_threads(ctx: Context):
    return ctx.all_thread_names()


def free_threads(ctx: Context):
    return ctx.free_thread_names()


def all_processes(ctx: Context):
    return ctx.all_processes()


def free_processes(ctx: Context):
    return ctx.free_processes()


def some_free_process(ctx: Context):
    return ctx.some_free_process()


def process_to_thread(ctx: Context, process):
    return ctx.process_to_thread_name(process)


def thread_to_process(ctx: Context, thread):
    return ctx.thread_to_process(thread)


# ---------------------------------------------------------------------------
# fill-in-op
# ---------------------------------------------------------------------------

def fill_in_op(m: dict, ctx: Context):
    """Fills in :type :process :time from context; returns PENDING when no
    process is free (generator.clj:500-537)."""
    p = ctx.some_free_process()
    if p is None:
        return PENDING
    time = m.get("time", ctx.time)
    type_ = m.get("type", "invoke")
    process = m.get("process", p)
    f = m.get("f")
    value = m.get("value")
    ext = {k: v for k, v in m.items()
           if k not in ("time", "type", "process", "f", "value")}
    return Op(index=-1, time=time, type=type_, process=process, f=f,
              value=value, ext=ext or None)


# ---------------------------------------------------------------------------
# Generator base + value dispatch
# ---------------------------------------------------------------------------

class Generator:
    """Base class for combinator generators."""

    def op(self, test, ctx):
        raise NotImplementedError

    def update(self, test, ctx, event):
        return self


class _LazyList:
    """Append-only cache over an iterator so lazy (even infinite) Python
    iterables behave as persistent sequences."""

    __slots__ = ("_it", "_cache", "_done")

    def __init__(self, iterable):
        self._it = iter(iterable)
        self._cache: list = []
        self._done = False

    def get(self, i: int):
        cache = self._cache
        while len(cache) <= i and not self._done:
            try:
                cache.append(next(self._it))
            except StopIteration:
                self._done = True
        if i < len(cache):
            return True, cache[i]
        return False, None


class Seq(Generator):
    """Sequence generator: runs each element to exhaustion in order
    (generator.clj Seqable impl, 583-612). `current` holds the evolved
    state of the element at position i (or _FRESH)."""

    _FRESH = object()

    __slots__ = ("items", "i", "current")

    def __init__(self, items, i=0, current=_FRESH):
        self.items = items  # list/tuple or _LazyList
        self.i = i
        self.current = current

    @classmethod
    def of(cls, items):
        if isinstance(items, (list, tuple)):
            return cls(items)
        return cls(_LazyList(items))

    def _get(self, i):
        items = self.items
        if isinstance(items, _LazyList):
            return items.get(i)
        if i < len(items):
            return True, items[i]
        return False, None

    def _head(self, i, current):
        if current is not Seq._FRESH:
            return True, current
        return self._get(i)

    def op(self, test, ctx):
        i, current = self.i, self.current
        while True:
            found, head = self._head(i, current)
            if not found:
                return None
            res = op(head, test, ctx)
            if res is None:
                i += 1
                current = Seq._FRESH
                continue
            o, g2 = res
            # Tail flattening: a Seq at its final element is equivalent
            # to that element's continuation. Returning it bare keeps
            # fn-generator chains (Seq([g, fn]) rebuilt per call) at
            # constant depth instead of nesting once per exhaustion,
            # which blew the recursion limit past ~400 consumed ops.
            if (not isinstance(self.items, _LazyList)
                    and i == len(self.items) - 1):
                return o, g2
            return o, Seq(self.items, i, g2)

    def update(self, test, ctx, event):
        found, head = self._head(self.i, self.current)
        if not found:
            return self
        return Seq(self.items, self.i, update(head, test, ctx, event))


class _FnGen(Generator):
    """Function generator: calls f to produce a generator, exhausts it,
    then calls f again (generator.clj Fn record, 539-556)."""

    __slots__ = ("f", "arity")

    def __init__(self, f, arity):
        self.f = f
        self.arity = arity

    def op(self, test, ctx):
        g = self.f(test, ctx) if self.arity == 2 else self.f()
        if g is None:
            return None
        return op(Seq([g, self]), test, ctx)

    def __repr__(self):
        return f"FnGen<{getattr(self.f, '__name__', self.f)!r}>"


def _fn_arity(f) -> int:
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return 0
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            if p.default is p.empty:
                n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return 2
    return 2 if n >= 2 else 0


class Delayed(Generator):
    """Not evaluated until it could produce an op; then replaced by the
    generator the thunk returns (generator.clj Delay impl, 579-582)."""

    __slots__ = ("thunk", "_forced", "_value")

    def __init__(self, thunk):
        self.thunk = thunk
        self._forced = False
        self._value = None

    def _force(self):
        if not self._forced:
            self._value = self.thunk()
            self._forced = True
        return self._value

    def op(self, test, ctx):
        return op(self._force(), test, ctx)

    def update(self, test, ctx, event):
        return self


class Promise(Generator):
    """PENDING until delivered, then behaves as the delivered generator
    (generator.clj init! promise extension, 622-643)."""

    __slots__ = ("_value", "_delivered")

    def __init__(self):
        self._value = None
        self._delivered = False

    def deliver(self, gen):
        self._value = gen
        self._delivered = True

    def op(self, test, ctx):
        if self._delivered:
            return op(self._value, test, ctx)
        return PENDING, self

    def update(self, test, ctx, event):
        return self


# Iterators are the one non-persistent generator input: consuming them in
# place would break combinators (like Repeat) that re-run the *same*
# generator value. Cache the persistent Seq wrapper per iterator object so
# every use sees the same append-only view.
_iter_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _coerce_iterator(gen) -> Seq:
    try:
        seq = _iter_cache.get(gen)
        if seq is None:
            seq = Seq.of(gen)
            _iter_cache[gen] = seq
        return seq
    except TypeError:  # not weak-referenceable; accept one-shot semantics
        return Seq.of(gen)


def op(gen, test, ctx):
    """Asks a generator for its next operation. Returns None, (PENDING, g),
    or (Op, g')."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.op(test, ctx)
    if isinstance(gen, dict):
        o = fill_in_op(gen, ctx)
        if o is PENDING:
            return PENDING, gen
        return o, None
    if isinstance(gen, (list, tuple)):
        return Seq(gen).op(test, ctx)
    if callable(gen):
        return _FnGen(gen, _fn_arity(gen)).op(test, ctx)
    if hasattr(gen, "__next__"):
        return _coerce_iterator(gen).op(test, ctx)
    if hasattr(gen, "__iter__"):
        return Seq.of(gen).op(test, ctx)
    raise TypeError(f"Not a generator: {gen!r}")


def update(gen, test, ctx, event):
    """Updates a generator with an invoke/complete event."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.update(test, ctx, event)
    if isinstance(gen, dict):
        return gen
    if isinstance(gen, (list, tuple)):
        return Seq(gen).update(test, ctx, event)
    if callable(gen):
        return gen
    if hasattr(gen, "__next__"):
        return _coerce_iterator(gen).update(test, ctx, event)
    if hasattr(gen, "__iter__"):
        return Seq.of(gen).update(test, ctx, event)
    raise TypeError(f"Not a generator: {gen!r}")


# ---------------------------------------------------------------------------
# Validation wrappers
# ---------------------------------------------------------------------------

class InvalidOp(Exception):
    def __init__(self, problems, res, gen):
        self.problems = problems
        self.res = res
        self.gen = gen
        super().__init__(
            "Generator produced an invalid [op, gen'] tuple: "
            f"{problems} (result {res!r})")


class Validate(Generator):
    """Asserts well-formedness of emitted ops (generator.clj:644-699)."""

    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        if not (isinstance(res, tuple) and len(res) == 2):
            raise InvalidOp(["should return a pair of [op, gen']"], res,
                            self.gen)
        o, g2 = res
        if o is not PENDING:
            problems = []
            if not isinstance(o, Op):
                problems.append("should be PENDING or an Op")
            else:
                if o.type not in ("invoke", "info", "sleep", "log"):
                    problems.append(
                        "type should be invoke, info, sleep, or log")
                if not isinstance(o.time, (int, float)):
                    problems.append("time should be a number")
                if o.process is None:
                    problems.append("no process")
                else:
                    thread = ctx.process_to_thread_name(o.process)
                    if thread is None or not ctx.thread_free(thread):
                        problems.append(f"process {o.process} is not free")
            if problems:
                raise InvalidOp(problems, res, self.gen)
        return (res[0], Validate(g2))

    def update(self, test, ctx, event):
        return Validate(update(self.gen, test, ctx, event))


def validate(gen):
    return Validate(gen)


class GeneratorError(Exception):
    """Wraps exceptions raised inside generators with context
    (friendly-exceptions, generator.clj:701-741)."""


class FriendlyExceptions(Generator):
    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        try:
            res = op(self.gen, test, ctx)
        except (GeneratorError, InvalidOp):
            raise
        except Exception as e:
            raise GeneratorError(
                f"Generator threw {e!r} when asked for an operation; "
                f"generator: {self.gen!r}") from e
        if res is None:
            return None
        return res[0], FriendlyExceptions(res[1])

    def update(self, test, ctx, event):
        try:
            return FriendlyExceptions(update(self.gen, test, ctx, event))
        except (GeneratorError, InvalidOp):
            raise
        except Exception as e:
            raise GeneratorError(
                f"Generator threw {e!r} when updated with {event!r}; "
                f"generator: {self.gen!r}") from e


def friendly_exceptions(gen):
    return FriendlyExceptions(gen)


class Trace(Generator):
    """Logs op/update calls through this layer (generator.clj:743-787)."""

    __slots__ = ("k", "gen")

    def __init__(self, k, gen):
        self.k = k
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        logger.info("%s op -> %r", self.k, None if res is None else res[0])
        if res is None:
            return None
        return res[0], Trace(self.k, res[1])

    def update(self, test, ctx, event):
        logger.info("%s update <- %r", self.k, event)
        return Trace(self.k, update(self.gen, test, ctx, event))


def trace(k, gen):
    return Trace(k, gen)


# ---------------------------------------------------------------------------
# map / filter
# ---------------------------------------------------------------------------

class GMap(Generator):
    """Transforms emitted ops with f (generator.clj Map, 788-806)."""

    __slots__ = ("f", "gen")

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is not PENDING:
            o = self.f(o)
            if isinstance(o, dict):
                from ..history import op as _mkop
                o = _mkop(**o)
        return o, GMap(self.f, g2)

    def update(self, test, ctx, event):
        return GMap(self.f, update(self.gen, test, ctx, event))


def gmap(f, gen):
    """`map` for generators (renamed to avoid shadowing builtins)."""
    return GMap(f, gen)


def f_map(fmap: dict, gen):
    """Replaces op :f values via the given mapping; useful with composed
    nemeses (generator.clj:816-824)."""
    return GMap(lambda o: o.copy(f=fmap.get(o.f, o.f)), gen)


class GFilter(Generator):
    """Passes only ops matching pred; PENDING/None bypass
    (generator.clj Filter, 826-848)."""

    __slots__ = ("pred", "gen")

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = gen

    def op(self, test, ctx):
        gen = self.gen
        while True:
            res = op(gen, test, ctx)
            if res is None:
                return None
            o, g2 = res
            if o is PENDING or self.pred(o):
                return o, GFilter(self.pred, g2)
            gen = g2

    def update(self, test, ctx, event):
        return GFilter(self.pred, update(self.gen, test, ctx, event))


def gfilter(pred, gen):
    return GFilter(pred, gen)


class IgnoreUpdates(Generator):
    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        return op(self.gen, test, ctx)

    def update(self, test, ctx, event):
        return self


class OnUpdate(Generator):
    """Calls (f this test ctx event) on updates (generator.clj:850-865)."""

    __slots__ = ("f", "gen")

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return res[0], OnUpdate(self.f, res[1])

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


def on_update(f, gen):
    return OnUpdate(f, gen)


# ---------------------------------------------------------------------------
# Thread restriction
# ---------------------------------------------------------------------------

class OnThreads(Generator):
    """Restricts a generator to threads satisfying pred
    (generator.clj:873-891)."""

    __slots__ = ("pred", "ctx_filter", "gen")

    def __init__(self, pred, ctx_filter, gen):
        self.pred = pred
        self.ctx_filter = ctx_filter
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, self.ctx_filter(ctx))
        if res is None:
            return None
        return res[0], OnThreads(self.pred, self.ctx_filter, res[1])

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread_name(event.process)
        if truthy(self.pred(thread)):
            return OnThreads(self.pred, self.ctx_filter,
                             update(self.gen, test, self.ctx_filter(ctx),
                                    event))
        return self


def on_threads(pred, gen):
    if isinstance(pred, (set, frozenset)):
        s = pred
        pred = lambda t: t in s  # noqa: E731
    return OnThreads(pred, make_thread_filter(pred), gen)


on = on_threads


def clients(client_gen, nemesis_gen=None):
    """Restricts to client threads; with two args, routes clients/nemesis
    (generator.clj:1125-1136)."""
    only_clients = on_threads(all_but(NEMESIS), client_gen)
    if nemesis_gen is None:
        return only_clients
    return any_gen(only_clients, nemesis(nemesis_gen))


def nemesis(nemesis_gen, client_gen=None):
    only_nem = on_threads({NEMESIS}, nemesis_gen)
    if client_gen is None:
        return only_nem
    return any_gen(only_nem, clients(client_gen))


# ---------------------------------------------------------------------------
# soonest-op-map + any
# ---------------------------------------------------------------------------

def soonest_op_map(m1, m2, rng=None):
    """Of two {'op','gen','weight',...} maps, the one whose op occurs
    sooner; ties broken randomly proportional to weight
    (generator.clj:894-938)."""
    rng = rng or _rng
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    op1, op2 = m1["op"], m2["op"]
    if op1 is PENDING:
        return m2
    if op2 is PENDING:
        return m1
    t1, t2 = op1.time, op2.time
    if t1 == t2:
        w1 = m1.get("weight", 1)
        w2 = m2.get("weight", 1)
        chosen = m1 if rng.randrange(w1 + w2) < w1 else m2
        chosen = dict(chosen)
        chosen["weight"] = w1 + w2
        return chosen
    return m1 if t1 < t2 else m2


class Any(Generator):
    """Takes ops from whichever sub-generator is soonest; updates go to all
    (generator.clj:940-964)."""

    __slots__ = ("gens",)

    def __init__(self, gens):
        self.gens = list(gens)

    def op(self, test, ctx):
        soonest = None
        for i, g in enumerate(self.gens):
            res = op(g, test, ctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "i": i},
                    rng=_ctx_rng(ctx))
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return soonest["op"], Any(gens)

    def update(self, test, ctx, event):
        return Any([update(g, test, ctx, event) for g in self.gens])


def any_gen(*gens):
    if len(gens) == 0:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(gens)


# ---------------------------------------------------------------------------
# each-thread
# ---------------------------------------------------------------------------

class EachThread(Generator):
    """Independent copy of the generator per thread
    (generator.clj:966-1028)."""

    __slots__ = ("fresh_gen", "filters", "gens")

    def __init__(self, fresh_gen, filters, gens):
        self.fresh_gen = fresh_gen
        self.filters = filters  # shared mutable cache: thread -> ctx filter
        self.gens = gens        # thread -> evolved gen

    def _filter_for(self, thread, ctx):
        f = self.filters.get(thread)
        if f is None:
            f = make_thread_filter(lambda t, th=thread: t == th, ctx)
            self.filters[thread] = f
        return f

    def op(self, test, ctx):
        soonest = None
        for thread in ctx.free_thread_names():
            g = self.gens.get(thread, self.fresh_gen)
            tctx = self._filter_for(thread, ctx)(ctx)
            res = op(g, test, tctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1],
                              "thread": thread}, rng=_ctx_rng(ctx))
        if soonest is not None:
            gens = dict(self.gens)
            gens[soonest["thread"]] = soonest["gen"]
            return soonest["op"], EachThread(self.fresh_gen, self.filters,
                                             gens)
        if ctx.free_thread_count() != ctx.all_thread_count():
            return PENDING, self
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread_name(event.process)
        if thread is None:
            return self
        g = self.gens.get(thread, self.fresh_gen)
        tctx = self._filter_for(thread, ctx)(ctx)
        gens = dict(self.gens)
        gens[thread] = update(g, test, tctx, event)
        return EachThread(self.fresh_gen, self.filters, gens)


def each_thread(gen):
    return EachThread(gen, {}, {})


# ---------------------------------------------------------------------------
# reserve
# ---------------------------------------------------------------------------

class Reserve(Generator):
    """Dedicates thread ranges to generators, remaining threads to a
    default (generator.clj:1029-1124)."""

    __slots__ = ("ranges", "ctx_filters", "gens")

    def __init__(self, ranges, ctx_filters, gens):
        self.ranges = ranges          # list of frozenset of thread names
        self.ctx_filters = ctx_filters  # one per range + default last
        self.gens = gens              # one per range + default last

    def op(self, test, ctx):
        soonest = None
        for i, threads in enumerate(self.ranges):
            tctx = self.ctx_filters[i](ctx)
            res = op(self.gens[i], test, tctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1],
                              "weight": len(threads), "i": i},
                    rng=_ctx_rng(ctx))
        dctx = self.ctx_filters[-1](ctx)
        res = op(self.gens[-1], test, dctx)
        if res is not None:
            soonest = soonest_op_map(
                soonest, {"op": res[0], "gen": res[1],
                          "weight": dctx.all_thread_count(),
                          "i": len(self.ranges)}, rng=_ctx_rng(ctx))
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return soonest["op"], Reserve(self.ranges, self.ctx_filters, gens)

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread_name(event.process)
        i = len(self.ranges)
        for j, threads in enumerate(self.ranges):
            if thread in threads:
                i = j
                break
        gens = list(self.gens)
        gens[i] = update(gens[i], test, ctx, event)
        return Reserve(self.ranges, self.ctx_filters, gens)


def reserve(*args):
    """reserve(5, writes, 10, cas, reads): first 5 threads run writes, next
    10 run cas, the rest run reads."""
    assert len(args) % 2 == 1, "reserve takes count,gen pairs + default gen"
    pairs = list(zip(args[:-1:2], args[1:-1:2]))
    default = args[-1]
    ranges = []
    n = 0
    for count, _g in pairs:
        ranges.append(frozenset(range(n, n + count)))
        n += count
    all_reserved = frozenset().union(*ranges) if ranges else frozenset()
    filters = [make_thread_filter(lambda t, s=s: t in s) for s in ranges]
    filters.append(make_thread_filter(lambda t: t not in all_reserved))
    gens = [g for _c, g in pairs] + [default]
    return Reserve(ranges, filters, gens)


# ---------------------------------------------------------------------------
# mix / limit / repeat / cycle
# ---------------------------------------------------------------------------

class Mix(Generator):
    """Uniform random mixture; ignores updates (generator.clj:1156-1188)."""

    __slots__ = ("i", "gens")

    def __init__(self, i, gens):
        self.i = i
        self.gens = gens

    def op(self, test, ctx):
        rng = _ctx_rng(ctx)
        i, gens = self.i, self.gens
        if i is None:
            i = rng.randrange(len(gens)) if gens else 0
        while gens:
            res = op(gens[i], test, ctx)
            if res is not None:
                new_gens = list(gens)
                new_gens[i] = res[1]
                return res[0], Mix(rng.randrange(len(new_gens)), new_gens)
            gens = gens[:i] + gens[i + 1:]
            i = rng.randrange(len(gens)) if gens else 0
        return None

    def update(self, test, ctx, event):
        return self


def mix(gens):
    gens = list(gens)
    if not gens:
        return None
    return Mix(None, gens)  # first index drawn from the ctx RNG


class Limit(Generator):
    """At most `remaining` ops (generator.clj:1189-1204)."""

    __slots__ = ("remaining", "gen")

    def __init__(self, remaining, gen):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        if res[0] is PENDING:  # pending probes don't spend the budget
            return res[0], Limit(self.remaining, res[1])
        return res[0], Limit(self.remaining - 1, res[1])

    def update(self, test, ctx, event):
        return Limit(self.remaining, update(self.gen, test, ctx, event))


def limit(n, gen):
    return Limit(n, gen)


def once(gen):
    return Limit(1, gen)


def log(msg):
    """One-shot op that logs a message (generator.clj:1210)."""
    return {"type": "log", "value": msg}


class Repeat(Generator):
    """Emits ops forever (or `remaining` times) without consuming the
    underlying generator's state (generator.clj:1216-1242)."""

    __slots__ = ("remaining", "gen")

    def __init__(self, remaining, gen):
        self.remaining = remaining  # -1 = infinite
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return res[0], Repeat(max(-1, self.remaining - 1), self.gen)

    def update(self, test, ctx, event):
        return Repeat(self.remaining, update(self.gen, test, ctx, event))


def repeat(a, b=None):
    """repeat(gen) = infinite; repeat(n, gen) = n times."""
    if b is None:
        return Repeat(-1, a)
    assert a >= 0
    return Repeat(a, b)


class Cycle(Generator):
    """Restarts a finite generator when it exhausts
    (generator.clj:1243-1270)."""

    __slots__ = ("remaining", "original", "gen")

    def __init__(self, remaining, original, gen):
        self.remaining = remaining
        self.original = original
        self.gen = gen

    def op(self, test, ctx):
        remaining, gen = self.remaining, self.gen
        while remaining != 0:
            res = op(gen, test, ctx)
            if res is not None:
                return res[0], Cycle(remaining, self.original, res[1])
            remaining -= 1
            gen = self.original
        return None

    def update(self, test, ctx, event):
        return Cycle(self.remaining, self.original,
                     update(self.gen, test, ctx, event))


def cycle(gen, times=-1):
    return Cycle(times, gen, gen)


# ---------------------------------------------------------------------------
# process/time limits
# ---------------------------------------------------------------------------

class ProcessLimit(Generator):
    """Emits ops for up to n distinct processes (generator.clj:1271-1297)."""

    __slots__ = ("n", "procs", "gen")

    def __init__(self, n, procs, gen):
        self.n = n
        self.procs = procs
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return o, ProcessLimit(self.n, self.procs, g2)
        procs = self.procs | frozenset(ctx.all_processes())
        if len(procs) <= self.n:
            return o, ProcessLimit(self.n, procs, g2)
        return None

    def update(self, test, ctx, event):
        return ProcessLimit(self.n, self.procs,
                            update(self.gen, test, ctx, event))


def process_limit(n, gen):
    return ProcessLimit(n, frozenset(), gen)


class TimeLimit(Generator):
    """Emits ops for dt seconds after its first op
    (generator.clj:1298-1323)."""

    __slots__ = ("limit", "cutoff", "gen")

    def __init__(self, limit, cutoff, gen):
        self.limit = limit
        self.cutoff = cutoff
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return o, TimeLimit(self.limit, self.cutoff, g2)
        cutoff = self.cutoff if self.cutoff is not None else o.time + self.limit
        if o.time < cutoff:
            return o, TimeLimit(self.limit, cutoff, g2)
        return None

    def update(self, test, ctx, event):
        return TimeLimit(self.limit, self.cutoff,
                         update(self.gen, test, ctx, event))


def time_limit(dt_secs, gen):
    return TimeLimit(util.secs_to_nanos(dt_secs), None, gen)


# ---------------------------------------------------------------------------
# timing: stagger / delay / sleep
# ---------------------------------------------------------------------------

class Stagger(Generator):
    """Schedules ops at uniformly random intervals in [0, 2*dt), a *total*
    rate across all threads (generator.clj:1324-1399)."""

    __slots__ = ("dt", "next_time", "gen")

    def __init__(self, dt, next_time, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return o, self
        rng = _ctx_rng(ctx)
        next_time = self.next_time if self.next_time is not None else ctx.time
        if next_time <= o.time:
            return o, Stagger(self.dt, o.time + int(rng.random() * self.dt),
                              g2)
        return (o.copy(time=next_time),
                Stagger(self.dt, next_time + int(rng.random() * self.dt),
                        g2))

    def update(self, test, ctx, event):
        return Stagger(self.dt, self.next_time,
                       update(self.gen, test, ctx, event))


def stagger(dt_secs, gen):
    return Stagger(util.secs_to_nanos(2 * dt_secs), None, gen)


class GDelay(Generator):
    """Emits ops exactly dt apart (catching up if behind)
    (generator.clj:1400-1427)."""

    __slots__ = ("dt", "next_time", "gen")

    def __init__(self, dt, next_time, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return o, GDelay(self.dt, self.next_time, g2)
        next_time = self.next_time if self.next_time is not None else o.time
        o = o.copy(time=max(o.time, next_time))
        return o, GDelay(self.dt, o.time + self.dt, g2)

    def update(self, test, ctx, event):
        return GDelay(self.dt, self.next_time,
                      update(self.gen, test, ctx, event))


def delay(dt_secs, gen):
    return GDelay(util.secs_to_nanos(dt_secs), None, gen)


def sleep(dt_secs):
    """One special op: the receiving process does nothing for dt seconds
    (generator.clj:1428-1433)."""
    return {"type": "sleep", "value": dt_secs}


# ---------------------------------------------------------------------------
# synchronization
# ---------------------------------------------------------------------------

class Synchronize(Generator):
    """Waits for all threads to be free before starting
    (generator.clj:1434-1450)."""

    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        if ctx.free_thread_count() == ctx.all_thread_count():
            return op(self.gen, test, ctx)
        return PENDING, self

    def update(self, test, ctx, event):
        return Synchronize(update(self.gen, test, ctx, event))


def synchronize(gen):
    return Synchronize(gen)


def phases(*gens):
    """Runs each generator to completion in turn, with a barrier between
    (generator.clj:1452-1457)."""
    return [Synchronize(g) for g in gens]


def then(a, b):
    """b, then (synchronized) a. Note the reversed arg order, matching the
    reference's ->>-friendly `then` (generator.clj:1459-1469)."""
    return [b, Synchronize(a)]


class UntilOk(Generator):
    """Emits ops until one completes :ok (generator.clj:1470-1501)."""

    __slots__ = ("gen", "done", "active")

    def __init__(self, gen, done, active):
        self.gen = gen
        self.done = done
        self.active = active  # frozenset of processes running our ops

    def op(self, test, ctx):
        if self.done:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return o, UntilOk(g2, self.done, self.active)
        return o, UntilOk(g2, self.done, self.active | {o.process})

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        p = event.process
        if p in self.active:
            if event.type == "ok":
                return UntilOk(g2, True, self.active - {p})
            if event.type in ("info", "fail"):
                return UntilOk(g2, self.done, self.active - {p})
        return UntilOk(g2, self.done, self.active)


def until_ok(gen):
    return UntilOk(gen, False, frozenset())


class FlipFlop(Generator):
    """Alternates between generators; stops when any is exhausted
    (generator.clj:1502-1517)."""

    __slots__ = ("gens", "i")

    def __init__(self, gens, i):
        self.gens = gens
        self.i = i

    def op(self, test, ctx):
        res = op(self.gens[self.i], test, ctx)
        if res is None:
            return None
        gens = list(self.gens)
        gens[self.i] = res[1]
        return res[0], FlipFlop(gens, (self.i + 1) % len(gens))

    def update(self, test, ctx, event):
        return self


def flip_flop(a, b):
    return FlipFlop([a, b], 0)


class CycleTimes(Generator):
    """Rotates between generators on a time schedule
    (generator.clj:1518-1608)."""

    __slots__ = ("period", "t0", "intervals", "cutoffs", "gens")

    def __init__(self, period, t0, intervals, cutoffs, gens):
        self.period = period
        self.t0 = t0
        self.intervals = intervals
        self.cutoffs = cutoffs
        self.gens = gens

    def op(self, test, ctx):
        now = ctx.time
        t0 = self.t0 if self.t0 is not None else now
        in_period = (now - t0) % self.period
        cycle_start = now - in_period
        i = 0
        while i < len(self.cutoffs) and in_period >= self.cutoffs[i]:
            i += 1
        t = cycle_start + sum(self.intervals[:i])
        for _ in range(2 * len(self.gens) + 2):
            interval = self.intervals[i]
            t_end = t + interval
            res = op(self.gens[i], test, ctx.with_time(max(now, t)))
            if res is None:
                return None
            o, g2 = res
            if o is PENDING:
                gens = list(self.gens)
                gens[i] = g2
                return PENDING, CycleTimes(self.period, t0, self.intervals,
                                           self.cutoffs, gens)
            if o.time < t_end:
                gens = list(self.gens)
                gens[i] = g2
                return o, CycleTimes(self.period, t0, self.intervals,
                                     self.cutoffs, gens)
            i = (i + 1) % len(self.gens)
            t = t_end
        return PENDING, self

    def update(self, test, ctx, event):
        return CycleTimes(self.period, self.t0, self.intervals, self.cutoffs,
                          [update(g, test, ctx, event) for g in self.gens])


def cycle_times(*specs):
    """cycle_times(5, writes, 10, reads): writes for 5s, reads for 10s,
    repeating. Generator state persists across rotations."""
    assert specs and len(specs) % 2 == 0
    intervals = [util.secs_to_nanos(s) for s in specs[::2]]
    gens = list(specs[1::2])
    period = sum(intervals)
    cutoffs = []
    acc = 0
    for iv in intervals[:-1]:
        acc += iv
        cutoffs.append(acc)
    return CycleTimes(period, None, intervals, cutoffs, gens)
