"""Independent key spaces (the port's copy of jepsen_tpu/independent.py).

Capability reference: jepsen/src/jepsen/independent.clj — linearizability
checking is exponential in history length, so histories are sharded by
key: sequential-generator (37-53), ConcurrentGenerator thread groups
(109-257), subhistories (271-326), and a checker that runs a sub-checker
per key (328-377).

A sub-checker that supports batching (checker.linearizable) gets every
key's history in ONE device launch: per-key histories become the batch
dimension of the WGL kernel (the ensemble path, BASELINE config 5). An
exception from that batch raises out of check(): there is no per-key
retry that would hide a failing device. Sub-checkers without check_batch
run per key through check_safe, as the reference does.

Ops carry (key, value) tuples as their value; `ktuple`/`key_`/`value_`
mirror independent/tuple.
"""

from __future__ import annotations

from . import checker as chk
from . import generator as gen
from . import telemetry, util
from .generator.context import make_thread_filter
from .history import History


def ktuple(k, v) -> tuple:
    """A key-value pair riding an op's :value (independent/tuple)."""
    return (k, v)


def key_(pair):
    return pair[0] if isinstance(pair, (tuple, list)) and len(pair) == 2 \
        else None


def value_(pair):
    return pair[1] if isinstance(pair, (tuple, list)) and len(pair) == 2 \
        else pair


def _wrap_op(k, o):
    return o.copy(value=(k, o.value))


def _unwrap_event(k, event):
    v = event.value
    if isinstance(v, (tuple, list)) and len(v) == 2 and v[0] == k:
        return event.copy(value=v[1])
    return event


class SequentialGenerator(gen.Generator):
    """Works through keys one at a time; every thread works the current
    key until its generator is exhausted (independent.clj:37-53).

    `cur` uses a distinct _FRESH sentinel for "key not started": a
    generator's continuation can legitimately BE None (an exhausted
    one-element Seq flattens to its element's continuation), and
    treating that as "fresh" would restart the key's generator
    forever."""

    _FRESH = object()

    __slots__ = ("keys", "fgen", "i", "cur")

    def __init__(self, keys, fgen, i=0, cur=_FRESH):
        self.keys = tuple(keys)
        self.fgen = fgen
        self.i = i
        self.cur = cur

    def op(self, test, ctx):
        i, cur = self.i, self.cur
        while i < len(self.keys) or cur is not SequentialGenerator._FRESH:
            if cur is SequentialGenerator._FRESH:
                cur = self.fgen(self.keys[i])
            res = gen.op(cur, test, ctx)
            if res is None:
                i, cur = i + 1, SequentialGenerator._FRESH
                if i >= len(self.keys):
                    return None
                continue
            o, g = res
            if o is gen.PENDING:
                return gen.PENDING, SequentialGenerator(
                    self.keys, self.fgen, i, g)
            return (_wrap_op(self.keys[i], o),
                    SequentialGenerator(self.keys, self.fgen, i, g))
        return None

    def update(self, test, ctx, event):
        cur = self.cur
        if cur is SequentialGenerator._FRESH or cur is None:
            return self
        return SequentialGenerator(
            self.keys, self.fgen, self.i,
            gen.update(cur, test, ctx, _unwrap_event(
                self.keys[self.i] if self.i < len(self.keys) else None,
                event)))


def sequential_generator(keys, fgen) -> SequentialGenerator:
    return SequentialGenerator(keys, fgen)


class ConcurrentGenerator(gen.Generator):
    """Splits client threads into fixed groups of n; each group works
    its own key concurrently, taking fresh keys from the shared sequence
    as sub-generators exhaust (independent.clj:109-257)."""

    __slots__ = ("n", "keys", "fgen", "groups", "filters", "state",
                 "next_key")

    def __init__(self, n, keys, fgen, groups=None, filters=None,
                 state=None, next_key=0):
        self.n = n
        self.keys = tuple(keys)
        self.fgen = fgen
        self.groups = groups
        self.filters = filters
        self.state = state      # per group: (key, gen) | None (done)
        self.next_key = next_key

    def _init(self, ctx):
        if self.groups is not None:
            return self
        threads = sorted(t for t in ctx.all_thread_names()
                         if t != gen.NEMESIS)
        assert len(threads) % self.n == 0, (
            f"concurrency ({len(threads)}) must be divisible by group "
            f"size ({self.n})")
        groups = [frozenset(threads[i:i + self.n])
                  for i in range(0, len(threads), self.n)]
        filters = [make_thread_filter(lambda t, s=s: t in s)
                   for s in groups]
        state: list = []
        nk = 0
        for _g in groups:
            if nk < len(self.keys):
                state.append((self.keys[nk], self.fgen(self.keys[nk])))
                nk += 1
            else:
                state.append(None)
        return ConcurrentGenerator(self.n, self.keys, self.fgen, groups,
                                   filters, state, nk)

    def op(self, test, ctx):
        self_ = self._init(ctx)
        soonest = None
        state = list(self_.state)
        nk = self_.next_key
        for i, st in enumerate(state):
            # refill exhausted groups with fresh keys
            while st is not None and st[1] is None:
                if nk < len(self_.keys):
                    st = (self_.keys[nk], self_.fgen(self_.keys[nk]))
                    nk += 1
                else:
                    st = None
            state[i] = st
            if st is None:
                continue
            k, g = st
            tctx = self_.filters[i](ctx)
            res = gen.op(g, test, tctx)
            if res is None:
                # exhausted now: try again with a fresh key next round
                state[i] = (k, None)
                if nk < len(self_.keys):
                    state[i] = (self_.keys[nk],
                                self_.fgen(self_.keys[nk]))
                    nk += 1
                    k, g = state[i]
                    res = gen.op(g, test, tctx)
                else:
                    state[i] = None
                    continue
                if res is None:
                    continue
            o, g2 = res
            if o is gen.PENDING:
                state[i] = (k, g2)
                continue
            soonest = gen.soonest_op_map(
                soonest, {"op": o, "gen": g2, "i": i, "key": k,
                          "weight": self_.n})
        nxt = ConcurrentGenerator(self_.n, self_.keys, self_.fgen,
                                  self_.groups, self_.filters, state, nk)
        if soonest is not None:
            state2 = list(state)
            state2[soonest["i"]] = (soonest["key"], soonest["gen"])
            return (_wrap_op(soonest["key"], soonest["op"]),
                    ConcurrentGenerator(self_.n, self_.keys, self_.fgen,
                                        self_.groups, self_.filters,
                                        state2, nk))
        if any(st is not None for st in state):
            return gen.PENDING, nxt
        return None

    def update(self, test, ctx, event):
        self_ = self._init(ctx)
        thread = ctx.process_to_thread_name(event.process)
        for i, threads in enumerate(self_.groups):
            st = self_.state[i]
            if thread in threads and st is not None and st[1] is not None:
                k, g = st
                tctx = self_.filters[i](ctx)
                state = list(self_.state)
                state[i] = (k, gen.update(g, test, tctx,
                                          _unwrap_event(k, event)))
                return ConcurrentGenerator(
                    self_.n, self_.keys, self_.fgen, self_.groups,
                    self_.filters, state, self_.next_key)
        return self_


def concurrent_generator(n, keys, fgen) -> ConcurrentGenerator:
    return ConcurrentGenerator(n, keys, fgen)


def subhistories(hist: History) -> dict:
    """Splits a history of (key, value) ops into per-key histories with
    unwrapped values (independent.clj:271-326). Ops keep the whole
    history's indices."""
    out: dict = {}
    for o in hist:
        v = o.value
        if isinstance(v, (tuple, list)) and len(v) == 2:
            k, val = v[0], v[1]
            out.setdefault(k, []).append(o.copy(value=val))
    return {k: History(ops, assign_indices=False)
            for k, ops in out.items()}


class IndependentChecker:
    """Applies a sub-checker to each key's history. If the sub-checker
    supports check_batch (the linearizable checker does), every key is
    checked in one device launch."""

    def __init__(self, inner):
        self.inner = inner

    def check(self, test, hist, opts=None):
        from .gpu import certify

        opts = opts or {}
        with telemetry.span("independent:subhistories"):
            subs = subhistories(hist)
        keys = sorted(subs.keys(), key=str)
        if hasattr(self.inner, "check_batch"):
            results = self.inner.check_batch(
                test, [subs[k] for k in keys], opts)
        else:
            results = util.bounded_pmap(
                lambda k: chk.check_safe(self.inner, test, subs[k], opts),
                keys, limit=8)
        by_key = dict(zip(keys, results))
        # per-key verdict certificates reference the WHOLE history's op
        # indices (subhistories keep them), but their values are wrapped
        # (key, v) tuples there and their digest covers only the
        # subhistory: stamp each certificate with its key (so the
        # validator filters and unwraps during replay) and re-anchor the
        # digest to the whole history the validator will be handed
        full_digest = None
        for k, r in by_key.items():
            cert = r.get("certificate") if isinstance(r, dict) else None
            if isinstance(cert, dict) and "absent" not in cert:
                if not certify._jsonable(k):
                    r["certificate"] = {"v": cert.get("v", 1),
                                        "absent": "independent key "
                                        "is not JSON-serializable"}
                    continue
                if full_digest is None:
                    full_digest = certify.history_digest(hist)
                cert["key"] = certify._jv(k)
                cert["history"] = full_digest
        failures = [k for k, r in by_key.items()
                    if (r or {}).get("valid?") is False]
        valid = chk.merge_valid((r or {}).get("valid?")
                                for r in by_key.values())
        return {"valid?": valid,
                "results": by_key,
                "failures": failures}


def checker(inner) -> IndependentChecker:
    return IndependentChecker(inner)
