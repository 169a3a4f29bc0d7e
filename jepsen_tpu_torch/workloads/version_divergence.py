"""Version-divergence probe: upsert unique integers into a row while
partitioning the cluster; every observed row _version must identify a
SINGLE value — two values under one version means divergent replicas
both claimed the same version.

Capability reference: crate/src/jepsen/crate/version_divergence.clj —
client (29-91: read returns {value, _version}; write upserts a unique
integer), multiversion-checker (93-107: group ok reads by _version,
each group must hold exactly one distinct value), test (109-137:
independent keys, reserve 5 readers vs writers, partition nemesis).

Client contract (per key, via independent tuples):
  {"f": "write", "value": (k, v)} -> ok when the upsert landed
  {"f": "read", "value": (k, None)} -> ok with value
      (k, {"value": v, "version": n}) or (k, None) for a missing row

The port's copy of jepsen_tpu/workloads/version_divergence.py;
independent host checkers. No kernel runs.
"""

from __future__ import annotations

from .. import checker as chk
from .. import generator as gen
from .. import independent


def check_multiversion(hist) -> dict:
    """version_divergence.clj multiversion-checker (93-107)."""
    by_version: dict = {}
    for op in hist:
        if op.type != "ok" or op.f != "read":
            continue
        v = op.value
        if not isinstance(v, dict) or v.get("version") is None:
            continue
        by_version.setdefault(v["version"], set()).add(v.get("value"))
    multis = {ver: sorted(vals, key=repr)
              for ver, vals in by_version.items() if len(vals) > 1}
    return {
        "valid?": not multis,
        "versions-observed": len(by_version),
        "multis": multis,
    }


def multiversion_checker() -> chk.Checker:
    return chk.checker(
        lambda test, hist, opts: check_multiversion(hist))


class _UniqueWrites(gen.Generator):
    """0,1,2,... as write values; functional successor so probing
    wrappers can't skip integers."""

    def __init__(self, n: int = 0):
        self.n = n

    def op(self, test, ctx):
        m = gen.fill_in_op({"f": "write", "value": self.n}, ctx)
        if m is gen.PENDING:
            return gen.PENDING, self
        return m, _UniqueWrites(self.n + 1)

    def update(self, test, ctx, event):
        return self


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    keys = o.get("keys", list(range(o.get("key_count", 4))))
    n_group = o.get("group-size", o.get("group_size", 6))
    # at least one thread must remain outside the reader reservation
    # or no writes ever run and the checker passes vacuously
    readers = min(o.get("readers", 3), max(n_group - 1, 1))
    ops_per_key = o.get("ops_per_key", 120)

    def key_gen(k):
        reads = gen.repeat({"f": "read", "value": None})
        return gen.limit(ops_per_key, gen.stagger(
            o.get("stagger", 0.001),
            gen.reserve(readers, reads, _UniqueWrites())))

    return {
        "generator": independent.concurrent_generator(
            n_group, keys, key_gen),
        "checker": independent.checker(multiversion_checker()),
    }
