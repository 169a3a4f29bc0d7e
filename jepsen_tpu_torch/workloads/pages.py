"""Pagination-isolation workload: groups of elements are inserted in
one transaction; concurrent full reads (which the database serves as
paginated scans) must see each group atomically — every read must be
expressible as a union of complete groups.

Capability reference: faunadb/src/jepsen/faunadb/pages.clj — client
(45-61: add inserts a whole group in one query, read pages through the
index), read-errs (67-92: peel one element, its whole group must be
present, recurse on the rest), checker (94-143: candidate adds =
invoked - failed, elements must be globally unique, duplicate items in
a read are their own error), workload (145-169: independent keys,
groups of 4 drawn without replacement, 4:1 add:read mix).

Client contract (per key, via independent tuples):
  {"f": "add", "value": (k, [e1..eG])} -> ok iff the whole group was
      inserted atomically
  {"f": "read", "value": (k, None)} -> ok with value (k, [elements...])
      in scan order (duplicates preserved — they are evidence).

The port's copy of jepsen_tpu/workloads/pages.py; a host checker. No
kernel runs.
"""

from __future__ import annotations

from .. import util

from .. import checker as chk
from .. import generator as gen
from .. import independent


def read_errs(idx: dict, read: set) -> list:
    """pages.clj read-errs: the read set must be a union of complete
    groups. Peel any element, check its full group is present, cross
    the group off, recurse."""
    errs = []
    read = set(read)
    while read:
        e = next(iter(read))
        group = idx.get(e, frozenset((e,)))
        missing = group - read
        if missing:
            errs.append({"expected": sorted(group),
                         "found": sorted(group & read)})
        read -= group
    return errs


def check_pages(hist) -> dict:
    """pages.clj checker (94-143)."""
    invoked, failed = set(), set()
    ok_reads = []
    for op in hist:
        if op.f == "add":
            group = tuple(op.value or ())
            if op.type == "invoke":
                invoked.add(group)
            elif op.type == "fail":
                failed.add(group)
        elif op.f == "read" and op.type == "ok":
            ok_reads.append(op)
    # adds that may have taken effect
    candidates = invoked - failed
    idx: dict = {}
    for group in candidates:
        gset = frozenset(group)
        for e in group:
            assert e not in idx, f"elements must be unique: {e}"
            idx[e] = gset
    errors = []
    for op in ok_reads:
        v = list(op.value or ())
        if len(v) != len(set(v)):
            errors.append({"op-index": op.index,
                           "errors": ["duplicate-items"]})
            continue
        errs = read_errs(idx, set(v))
        if errs:
            errors.append({"op-index": op.index, "errors": errs})
    worst = max(errors, key=lambda e: len(e["errors"]), default=None)
    return {
        "valid?": not errors,
        "ok-read-count": len(ok_reads),
        "error-count": len(errors),
        "first-error": errors[0] if errors else None,
        "worst-error": worst,
    }


def checker() -> chk.Checker:
    return chk.checker(lambda test, hist, opts: check_pages(hist))


def key_gen(k, opts: dict):
    """Groups drawn without replacement from a shuffled range, 4:1
    add:read, limited (pages.clj workload). `elements_per_add` sizes
    the atomic insert groups — deliberately NOT `group_size`, which
    names the independent thread-group like every other workload."""
    o = opts
    group_size = o.get("elements_per_add", 4)
    n = o.get("elements", 10_000)
    rng = util.seeded_rng(o.get("seed"), k)
    pool = list(range(-n, n))
    rng.shuffle(pool)
    groups = [pool[i:i + group_size]
              for i in range(0, len(pool) - group_size + 1, group_size)]
    adds = iter(groups)

    def add():
        g = next(adds, None)
        if g is None:
            return None  # pool exhausted ends the generator
        return {"f": "add", "value": g}

    def read():
        return {"f": "read", "value": None}

    return gen.limit(o.get("ops_per_key", 256),
                     gen.stagger(o.get("stagger", 0.001),
                                 gen.mix([add, add, add, add, read])))


def workload(opts: dict | None = None) -> dict:
    o = dict(opts or {})
    keys = o.get("keys", list(range(o.get("key_count", 8))))
    n_group = o.get("group-size", o.get("group_size", 4))
    return {
        "generator": independent.concurrent_generator(
            n_group, keys, lambda k: key_gen(k, o)),
        "checker": independent.checker(checker()),
    }
