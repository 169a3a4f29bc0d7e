"""Dirty-read workload: writers keep a value in flight on each node
while readers race to observe it; after healing, every client takes a
refreshed "strong read" of the full committed set. A value any read
observed that NO strong read contains was a dirty read (it came from
a write that never committed); an acknowledged write missing from the
strong reads was lost.

Capability reference:
elasticsearch/src/jepsen/elasticsearch/dirty_read.clj — rw-gen
(writers advertise their in-flight write per node, readers probe it,
161-189), final refresh + per-client strong reads (203-223), checker
(106-156: dirty = reads - union(strong), lost = writes - union,
nodes-agree = union == intersection).

Client contract: "write" v indexes v (ok when acknowledged); "read" v
is ok iff v is currently visible, fail otherwise; "refresh" forces
visibility convergence; "strong-read" completes with the full set of
visible values.

The port's copy of jepsen_tpu/workloads/dirty_read.py; a host checker.
No kernel runs.
"""

from __future__ import annotations

from .. import checker as chk
from .. import generator as gen


def check_dirty_read(hist) -> dict:
    """dirty_read.clj checker (106-156)."""
    writes, reads, strong = set(), set(), []
    for op in hist:
        if op.type != "ok":
            continue
        if op.f == "write":
            writes.add(op.value)
        elif op.f == "read":
            reads.add(op.value)
        elif op.f == "strong-read":
            strong.append(set(op.value or ()))
    if not strong:
        return {"valid?": "unknown",
                "error": "no strong reads completed"}
    on_all = set.intersection(*strong)
    on_some = set.union(*strong)
    dirty = reads - on_some
    lost = writes - on_some
    some_lost = writes - on_all
    nodes_agree = on_all == on_some
    return {
        "valid?": nodes_agree and not dirty and not lost,
        "nodes-agree?": nodes_agree,
        "read-count": len(reads),
        "on-all-count": len(on_all),
        "on-some-count": len(on_some),
        "not-on-all": sorted(on_some - on_all)[:16],
        "dirty-count": len(dirty),
        "dirty": sorted(dirty)[:16],
        "lost-count": len(lost),
        "lost": sorted(lost)[:16],
        "some-lost-count": len(some_lost),
        "strong-read-count": len(strong),
    }


class _Writes(gen.Generator):
    """Functional monotonic write values (see sequential._Writes for
    why emission must not mutate shared state: reserve probes and
    discards sub-generators)."""

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
    """1/3 of the threads write, the rest read whatever write is in
    flight on a random node (dirty_read.clj rw-gen); refresh + strong
    reads arrive as final_generator, to run after healing."""
    o = dict(opts or {})
    in_flight: dict[int, int] = {}  # node index -> latest write value

    class _Reads(gen.Generator):
        """Round-robins the probed node FUNCTIONALLY (emission returns
        a successor generator): reserve probes-and-discards, so a
        shared rng here would advance on discarded probes and void
        seeded reproducibility."""

        __slots__ = ("i",)

        def __init__(self, i: int = 0):
            self.i = i

        def op(self, test, ctx):
            if not in_flight:
                return gen.PENDING, self
            keys = sorted(in_flight)
            v = in_flight[keys[self.i % len(keys)]]
            op_ = gen.fill_in_op({"f": "read", "value": v}, ctx)
            if op_ is gen.PENDING:
                return gen.PENDING, self
            return op_, _Reads(self.i + 1)

        def update(self, test, ctx, event):
            return self

    def hook(this, test, ctx, event):
        if getattr(event, "type", None) == "invoke" \
                and getattr(event, "f", None) == "write":
            n = len(test.get("nodes", ())) or 1
            # the client is bound to the WORKER (thread), not the
            # process: crashed processes get fresh ids, so process %
            # nodes would misfile in-flight writes after a crash
            thread = ctx.process_to_thread_name(event.process)
            tid = int(thread) if isinstance(thread, int) \
                else int(event.process)
            in_flight[tid % n] = event.value
        inner = gen.update(this.gen, test, ctx, event)
        return gen.OnUpdate(this.f, inner)

    writers = o.get("writers")
    if writers is None:
        writers = max(1, o.get("concurrency", 6) // 3)
    g = gen.on_update(hook, gen.reserve(writers, _Writes(), _Reads()))
    if o.get("ops"):
        g = gen.limit(o["ops"], g)
    return {
        "generator": g,
        # heal first, then refresh everywhere, then one strong read
        # per client (dirty_read.clj final phases)
        "final_generator": gen.phases(
            gen.each_thread(gen.once(
                lambda: {"f": "refresh", "value": None})),
            gen.each_thread(gen.once(
                lambda: {"f": "strong-read", "value": None}))),
        "checker": chk.checker(
            lambda test, hist, _o: check_dirty_read(hist)),
    }
