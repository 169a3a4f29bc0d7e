"""Monotonic-inserts workload: each add reads the current max value
and inserts max+1 with a database timestamp; in the final read,
sorted by timestamp, timestamps must never run backwards (ties are
legal — non-strict <=) and values must strictly increase (a duplicate
value IS a reorder) — monotonic.clj comparator semantics.

Capability reference: cockroachdb/src/jepsen/cockroach/monotonic.clj —
client (81-140: add = query max, insert max+1 with system timestamp,
node, process, table id; read = all rows ordered by timestamp),
checker (180-248: lost / duplicate / revived / recovered values, plus
off-order detection globally and per process / node / table).

Client contract: "add" completes with a row dict
{"val", "sts", "node", "process", "tb"}; "read" completes with the
list of row dicts sorted by sts.

The port's copy of jepsen_tpu/workloads/monotonic.py; a host checker. No
kernel runs.
"""

from __future__ import annotations

import numpy as np

from .. import checker as chk
from .. import generator as gen


def _non_monotonic(rows, field, strict: bool) -> list:
    """Adjacent pairs where the field fails to increase. Per
    monotonic.clj check-monotonic: timestamps use non-strict <=
    (ties are legal — two txns may share a commit timestamp), while
    values use strict < (a duplicate value IS a reorder)."""
    vals = np.asarray([r[field] for r in rows])
    if len(vals) < 2:
        return []
    ok = (vals[:-1] < vals[1:]) if strict else (vals[:-1] <= vals[1:])
    return [(rows[i], rows[i + 1]) for i in np.flatnonzero(~ok)]


def _non_monotonic_by(rows, group_field, field) -> dict:
    groups: dict = {}
    for r in rows:
        groups.setdefault(r[group_field], []).append(r)
    return {g: _non_monotonic(rs, field, strict=True)
            for g, rs in sorted(groups.items())}


def check_monotonic(hist, global_: bool = True) -> dict:
    """monotonic.clj check-monotonic (180-248)."""
    adds, fails, infos = [], set(), set()
    final_read = None
    for op in hist:
        if op.f == "add":
            if op.type == "ok" and isinstance(op.value, dict):
                adds.append(op.value["val"])
            elif op.type == "fail" and isinstance(op.value, dict):
                fails.add(op.value["val"])
            elif op.type == "info" and isinstance(op.value, dict):
                infos.add(op.value["val"])
        elif op.f == "read" and op.type == "ok":
            final_read = op.value
    if final_read is None:
        return {"valid?": "unknown", "error": "Set was never read"}
    rows = list(final_read)
    vals = [r["val"] for r in rows]
    counts: dict = {}
    for v in vals:
        counts[v] = counts.get(v, 0) + 1
    dups = {v for v, c in counts.items() if c > 1}
    read_set = set(vals)
    adds_set = set(adds)
    lost = adds_set - read_set
    revived = read_set & fails
    recovered = read_set & infos
    off_sts = _non_monotonic(rows, "sts", strict=False)
    off_vals = _non_monotonic(rows, "val", strict=True)
    by_process = _non_monotonic_by(rows, "process", "val")
    by_node = _non_monotonic_by(rows, "node", "val")
    by_table = _non_monotonic_by(rows, "tb", "val")
    valid = (not lost and not dups and not revived and not off_sts
             and (not global_ or not off_vals)
             and all(not v for v in by_process.values()))
    return {
        "valid?": valid,
        "lost": sorted(lost),
        "duplicates": sorted(dups),
        "revived": sorted(revived),
        "recovered": sorted(recovered),
        "order-by-errors": off_sts[:8],
        "value-reorders": off_vals[:8],
        "value-reorders-per-process": {
            g: v[:4] for g, v in by_process.items() if v},
        "value-reorders-per-node": {
            g: v[:4] for g, v in by_node.items() if v},
        "value-reorders-per-table": {
            g: v[:4] for g, v in by_table.items() if v},
        "add-count": len(adds),
        "read-count": len(rows),
    }


def workload(opts: dict | None = None) -> dict:
    """Adds under faults, then final reads after recovery
    (monotonic.clj test, 251-282)."""
    o = dict(opts or {})
    n = o.get("ops", 300)
    return {
        "generator": gen.limit(n, lambda: {"f": "add", "value": None}),
        "final_generator": gen.each_thread(gen.once(
            lambda: {"f": "read", "value": None})),
        "checker": chk.checker(
            lambda test, hist, _o:
            check_monotonic(hist, global_=o.get("global", True))),
    }
