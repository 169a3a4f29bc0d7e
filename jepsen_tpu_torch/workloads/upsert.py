"""Upsert-uniqueness workload: many clients concurrently upsert the
same key; at most ONE upsert may succeed per key, and every read must
see at most one record id.

Capability reference: dgraph/src/jepsen/dgraph/upsert.clj — client
(upsert by indexed key -> ok iff inserted, value carries the created
uid; read -> sorted uids for the key), checker (54-69: at most one ok
upsert, no read returns more than one uid), workload (71-81:
independent keys, phases of each-thread upsert then each-thread read).

Client contract (per key, via independent tuples):
  {"f": "upsert", "value": (k, None)} -> ok with value (k, uid) iff
      this client created the record; fail if it already existed
      (or the transaction conflicted).
  {"f": "read", "value": (k, None)} -> ok with value (k, [uids...]),
      sorted.

The port's copy of jepsen_tpu/workloads/upsert.py; independent host
checkers. No kernel runs.
"""

from __future__ import annotations

from .. import checker as chk
from .. import generator as gen
from .. import independent


def check_upsert(hist) -> dict:
    """upsert.clj checker (54-69): at most one ok upsert per key; no
    ok read observes >1 record."""
    ok_upserts = []
    bad_reads = []
    for op in hist:
        if op.type != "ok":
            continue
        if op.f == "upsert":
            ok_upserts.append(op)
        elif op.f == "read":
            v = op.value
            if isinstance(v, (list, tuple)) and len(v) > 1:
                bad_reads.append(op)
    return {
        "valid?": not bad_reads and len(ok_upserts) <= 1,
        "ok-upsert-count": len(ok_upserts),
        "ok-upserts": [{"process": o.process, "value": o.value}
                       for o in ok_upserts[:8]],
        "bad-reads": [{"process": o.process, "value": o.value}
                      for o in bad_reads[:8]],
    }


def checker() -> chk.Checker:
    return chk.checker(lambda test, hist, opts: check_upsert(hist))


def workload(opts: dict | None = None) -> dict:
    """Per-key: every thread upserts the key once, then every thread
    reads it back (upsert.clj workload, 71-81)."""
    o = dict(opts or {})
    keys = o.get("keys", list(range(o.get("key_count", 16))))
    n_group = o.get("group-size", o.get("group_size", 4))

    def key_gen(k):
        return gen.phases(
            gen.each_thread(gen.once(
                lambda: {"f": "upsert", "value": None})),
            gen.each_thread(gen.once(
                lambda: {"f": "read", "value": None})))

    return {
        "generator": independent.concurrent_generator(
            n_group, keys, key_gen),
        "checker": independent.checker(checker()),
    }
