"""Helpers for mucking around with stored tests interactively (the
port's copy of jepsen_tpu/repl.py).

Capability reference: jepsen/src/jepsen/repl.clj (latest-test) plus
the store/report access patterns suites use from a REPL
(jepsen/src/jepsen/store.clj:108-134 load, web.clj fast reads).

    >>> from jepsen_tpu_torch import repl
    >>> t = repl.latest_test()
    >>> repl.summary(t)
    >>> [op for op in t["history"] if op.type == "fail"][:3]
"""

from __future__ import annotations

from . import store


def latest_test(name: str | None = None) -> dict | None:
    """The most recently run test, with history and results loaded
    (repl.clj latest-test). With a name, the latest run of that test
    only."""
    runs = list(store.tests(name))
    if not runs:
        return None
    latest = max(runs, key=lambda d: d.name)
    return store.load(latest)


def summary(test: dict | None) -> dict:
    """A terse, print-friendly view of a loaded test."""
    if test is None:
        return {}
    hist = test.get("history") or []
    results = test.get("results") or {}
    by_type: dict = {}
    for op in hist:
        by_type[op.type] = by_type.get(op.type, 0) + 1
    return {
        "name": test.get("name"),
        "start_time": str(test.get("start_time", "")),
        "valid?": results.get("valid?"),
        "ops": len(hist),
        "by-type": by_type,
        "checkers": sorted(k for k in results
                           if not k.endswith("?")),
    }
