"""The reader half of jepsen_tpu/tracing.py: the per-op causal trace a
traced run leaves in its store directory (optrace.jsonl), read back for
the anomaly trace excerpts (reports/explain.py) and the timeline's hover
titles (reports/timeline.py).

The recorder that writes optrace.jsonl while a test runs belongs to the
test runner and is not part of the port.
"""

from __future__ import annotations

from typing import Iterator

from . import telemetry

TRACE_FILE = "optrace.jsonl"


def read_records(path) -> Iterator[dict]:
    """Records from an optrace.jsonl; a torn trailing line is dropped
    (telemetry.read_jsonl, the shared parser)."""
    return telemetry.read_jsonl(path)


def describe(rec: dict) -> str:
    """A compact one-line description of a trace record: the shared
    formatter behind the timeline hover titles and the anomaly trace
    excerpts (reports/explain)."""
    attrs = rec.get("attrs") or {}
    parts = [f"{rec.get('kind')} {rec.get('name')}"]
    if (rec.get("kind") != "event" and isinstance(rec.get("t0"), int)
            and isinstance(rec.get("t1"), int)):
        parts.append(f"{(rec['t1'] - rec['t0']) / 1e6:.2f}ms")
    if rec.get("status"):
        parts.append(f"status={rec['status']}")
    for k in ("node", "exit", "retries", "type", "error"):
        if k in attrs:
            parts.append(f"{k}={attrs[k]}")
    if "cmd" in attrs:
        parts.append(str(attrs["cmd"])[:48])
    return " ".join(parts)


def by_op(records) -> dict[int, list[dict]]:
    """Indexes records by op (invocation) index: the join key of the
    reports and the anomaly trace excerpts. Context-free events (op
    None) are left out."""
    out: dict[int, list[dict]] = {}
    for rec in records:
        op = rec.get("op")
        if isinstance(op, int):
            out.setdefault(op, []).append(rec)
    return out
