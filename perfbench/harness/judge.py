"""The comparison that decides `correct`: every answer of the run, the
check still in flight when the window closed included, held against the
plain reference that the configuration names (`"reference": <name>`,
reference/<name>.py), each number beside its limit.

A reference module gives `LIMITS` (its numbers and their limits) and
`judge(config, history, answer, counts)`, which adds to `counts`
what it finds wrong in one answer. Beside its numbers the harness counts
`checks_failed`, checks that raised instead of answering (limit 0).
"""

from __future__ import annotations

import importlib
import pickle
import re


def reference(config: dict):
    """The module reference/<config["reference"]>.py."""
    name = config["reference"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"bad reference name {name!r}")
    return importlib.import_module("reference." + name)


def judge(config: dict, checks: list, history_of) -> tuple[dict, int]:
    """({name: (count, limit)}, answers judged) over `checks`, each with
    its `label` and its `answer` pickled (None where the check raised);
    `history_of(label)` gives the history a check was handed, with the
    generator's witness ({"events", "witness"})."""
    ref = reference(config)
    limits = {**ref.LIMITS, "checks_failed": 0}
    counts = dict.fromkeys(limits, 0)
    judged = 0
    for c in checks:
        if c["answer"] is None:
            counts["checks_failed"] += 1
            continue
        judged += 1
        ref.judge(config, history_of(c["label"]),
                  pickle.loads(c["answer"]), counts)
    return {k: (v, limits[k]) for k, v in counts.items()}, judged
