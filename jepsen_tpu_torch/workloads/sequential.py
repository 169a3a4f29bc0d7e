"""Sequential-consistency workload: a writer inserts a key's subkeys
in client order across separate transactions; a reader then reads the
subkeys in REVERSE order. Seeing a later subkey but missing an
earlier one violates sequential consistency.

Capability reference: cockroachdb/src/jepsen/cockroach/sequential.clj
— subkeys per key (46-49), writer inserts each subkey in its own txn
in order / reader queries them reversed (70-95), writes generator with
a recently-written buffer the readers sample (107-133), checker
flagging any read with a nil AFTER a non-nil (trailing-nil?, 136-162).

Client contract: "write" with value k inserts every subkey of k in
order; "read" with value k completes with (k, observations) where
observations lists each subkey (reversed order) or None if missing.

The port's copy of jepsen_tpu/workloads/sequential.py; a host checker.
No kernel runs.
"""

from __future__ import annotations

import collections
import random

from .. import checker as chk
from .. import generator as gen


def default_writers(concurrency: int) -> int:
    """Half the threads write, but never ALL of them (a reader pool
    must exist for the checker to have coverage); at concurrency 1
    the single thread writes and the checker reports unknown."""
    return min(max(1, concurrency // 2), max(concurrency - 1, 1))


def subkeys(key_count: int, k) -> list:
    """The subkeys of k, in write order (sequential.clj:46-49)."""
    return [f"{k}_{i}" for i in range(key_count)]


def _trailing_none(obs) -> bool:
    """A None after a non-None: a later write visible while an earlier
    one is missing (sequential.clj trailing-nil?)."""
    started = False
    for x in obs:
        if x is not None:
            started = True
        elif started:
            return True
    return False


def check_sequential(hist) -> dict:
    """sequential.clj checker (140-162). Read observations arrive
    reversed, so trailing Nones are the violations. Zero reads can't
    vacuously pass — that's no coverage, not correctness."""
    # (k, observations) pairs arrive as tuples in-memory but as LISTS
    # from a store round trip (the history log is JSON) — accept both
    reads = [(op.value[0], list(op.value[1])) for op in hist
             if op.type == "ok" and op.f == "read"
             and isinstance(op.value, (tuple, list))
             and len(op.value) == 2
             and isinstance(op.value[1], (tuple, list))]
    if not reads:
        return {"valid?": "unknown", "error": "No reads ever ran"}
    none = [r for r in reads if all(x is None for x in r[1])]
    some = [r for r in reads if any(x is None for x in r[1])]
    bad = [r for r in reads if _trailing_none(r[1])]
    all_ = [r for r in reads if all(x is not None for x in r[1])]
    return {
        "valid?": not bad,
        "all-count": len(all_),
        "some-count": len(some),
        "none-count": len(none),
        "bad-count": len(bad),
        "bad": bad[:8],
    }


class _Writes(gen.Generator):
    """Sequential write keys, FUNCTIONALLY: emitting returns a new
    generator holding k+1, so a probed-and-discarded branch (reserve
    races its sub-generators) can never burn a key the way a stateful
    counter closure would — readers must only ever see keys a write
    op was really dispatched for."""

    __slots__ = ("k",)

    def __init__(self, k: int = 0):
        self.k = k

    def op(self, test, ctx):
        o = gen.fill_in_op({"f": "write", "value": self.k}, ctx)
        if o is gen.PENDING:
            return gen.PENDING, self
        return o, _Writes(self.k + 1)

    def update(self, test, ctx, event):
        return self


def workload(opts: dict | None = None) -> dict:
    """n writers emitting sequential keys; readers sample a buffer of
    the 2n most recently *dispatched* writes (sequential.clj gen,
    107-133). The buffer fills from write INVOKE events via on_update,
    never from generator probing."""
    o = dict(opts or {})
    n_writers = o.get("writers", 5)
    rng = random.Random(o.get("seed"))
    last_written: collections.deque = collections.deque(
        maxlen=2 * n_writers)

    class _Reads(gen.Generator):
        """PENDING until some write has actually been dispatched,
        then reads a recently-written key."""

        __slots__ = ()

        def op(self, test, ctx):
            if not last_written:
                return gen.PENDING, self
            o = gen.fill_in_op(
                {"f": "read",
                 "value": rng.choice(list(last_written))}, ctx)
            if o is gen.PENDING:
                return gen.PENDING, self
            return o, self

        def update(self, test, ctx, event):
            return self

    def hook(this, test, ctx, event):
        if getattr(event, "type", None) == "invoke" \
                and getattr(event, "f", None) == "write":
            last_written.append(event.value)
        inner = gen.update(this.gen, test, ctx, event)
        return gen.OnUpdate(this.f, inner)

    g = gen.reserve(n_writers, _Writes(), _Reads())
    g = gen.on_update(hook, g)
    if o.get("ops"):
        g = gen.limit(o["ops"], g)
    return {
        "generator": g,
        "checker": chk.checker(
            lambda test, hist, _o: check_sequential(hist)),
        "key_count": o.get("key-count", 5),
    }
