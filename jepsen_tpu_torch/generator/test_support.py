"""Deterministic, single-threaded generator simulation for tests (the
port's copy of jepsen_tpu/generator/test_support.py).

Runs a generator against a synthetic completion function with no cluster
and no threads, producing the history the generator *would* create.

Capability reference: jepsen/src/jepsen/generator/test.clj (simulate
test.clj:35-112, quick/perfect/perfect-info/imperfect 115-187). The
reference rebinds rand-int around a seeded stream; here simulate seeds
the generator module's fallback RNG (its contexts carry no per-test
RNG, so every scheduling draw goes through that fallback).
"""

from __future__ import annotations

from typing import Callable

from . import (PENDING, Validate, context as make_context, op as gen_op,
               set_seed, update as gen_update)
from .context import Context, NEMESIS
from ..history import Op

RAND_SEED = 45100

DEFAULT_TEST: dict = {}


def n_plus_nemesis_context(n: int) -> Context:
    """A context with n worker threads plus a nemesis."""
    return make_context({"concurrency": n})


def default_context() -> Context:
    return n_plus_nemesis_context(2)


def simulate(gen, complete_fn: Callable, ctx: Context | None = None,
             test: dict | None = None, seed=RAND_SEED) -> list[Op]:
    """Simulates a generator against complete_fn(ctx, invoke) -> completion.

    Completions are held in a time-sorted in-flight set; an invocation is
    applied when its time precedes every in-flight completion, otherwise
    the earliest completion lands first. Crashed (:info) client ops get a
    fresh process. Mirrors test.clj:56-112.
    """
    if ctx is None:
        ctx = default_context()
    if test is None:
        test = DEFAULT_TEST
    set_seed(seed)
    ops: list[Op] = []
    in_flight: list[Op] = []  # sorted by time
    gen = Validate(gen)
    while True:
        res = gen_op(gen, test, ctx)
        if res is None:
            ops.extend(in_flight)
            return ops
        invoke, gen2 = res
        if invoke is not PENDING and (
                not in_flight or invoke.time <= in_flight[0].time):
            thread = ctx.process_to_thread_name(invoke.process)
            ctx = ctx.busy_thread(max(ctx.time, invoke.time), thread)
            gen = gen_update(gen2, test, ctx, invoke)
            complete = complete_fn(ctx, invoke)
            in_flight.append(complete)
            in_flight.sort(key=lambda o: o.time)
            ops.append(invoke)
        else:
            if not in_flight:
                raise AssertionError(
                    "generator pending but nothing in flight: stuck")
            done = in_flight.pop(0)
            thread = ctx.process_to_thread_name(done.process)
            ctx = ctx.free_thread(done.time, thread)
            gen = gen_update(gen, test, ctx, done)
            if thread != NEMESIS and done.type == "info":
                ctx = ctx.with_next_process(thread)
            ops.append(done)


def invocations(ops) -> list[Op]:
    return [o for o in ops if o.type == "invoke"]


def quick_ops(gen, ctx=None) -> list[Op]:
    """Every op completes :ok instantly with zero latency."""
    return simulate(gen, lambda c, inv: inv.copy(type="ok"), ctx=ctx)


def quick(gen, ctx=None) -> list[Op]:
    return invocations(quick_ops(gen, ctx=ctx))


PERFECT_LATENCY = 10


def perfect_all(gen, ctx=None) -> list[Op]:
    """Every op completes :ok in 10ns; returns the full history."""
    return simulate(
        gen,
        lambda c, inv: inv.copy(type="ok", time=inv.time + PERFECT_LATENCY),
        ctx=ctx)


def perfect(gen, ctx=None) -> list[Op]:
    return invocations(perfect_all(gen, ctx=ctx))


def perfect_info(gen, ctx=None) -> list[Op]:
    """Every op crashes :info in 10ns; returns only invocations."""
    return invocations(simulate(
        gen,
        lambda c, inv: inv.copy(type="info", time=inv.time + PERFECT_LATENCY),
        ctx=ctx))


def imperfect(gen, ctx=None) -> list[Op]:
    """Threads rotate fail -> info -> ok; returns the full history."""
    state: dict = {}
    rotation = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(c, inv):
        t = c.process_to_thread_name(inv.process)
        state[t] = rotation[state.get(t)]
        return inv.copy(type=state[t], time=inv.time + PERFECT_LATENCY)

    return simulate(gen, complete, ctx=ctx)
