"""Test result storage: the parts of jepsen_tpu/store that the port's
checkers use.

  - the run directory's paths (`base_dir`, `dir_name`, `test_dir`,
    `path`): store/<name>/<timestamp>/, or test["store_dir"] when the
    test has one; the checkers write their reports there;
  - the readers of a run's per-op trace (`load_optrace`, optrace.jsonl)
    and node-plane records (`load_nodes`, nodes.jsonl), which the
    anomaly trace excerpts join to a verdict's op indices;
  - the CRC-framed record format (format.py) of the checkpoints.

Creating run directories, saving test maps and results, and the history
log writer belong to the test runner and are not ported.

Capability reference: jepsen/src/jepsen/store.clj (per-test directories,
40-76).
"""

from __future__ import annotations

import datetime
from pathlib import Path

BASE = Path("store")


def base_dir(test: dict | None = None) -> Path:
    if test and test.get("store_base"):
        return Path(test["store_base"])
    return BASE


def dir_name(test: dict) -> str:
    t = test.get("start_time") or datetime.datetime.now()
    if isinstance(t, str):
        return t
    return t.strftime("%Y%m%dT%H%M%S.%f")[:-2]


def test_dir(test: dict) -> Path:
    return base_dir(test) / str(test.get("name", "noname")) / dir_name(test)


def path(test: dict, *parts) -> Path:
    """A path inside the test's store directory (creating parents is the
    caller's business)."""
    d = test.get("store_dir") or test_dir(test)
    return Path(d).joinpath(*[str(p) for p in parts])


def load_optrace(d) -> list[dict]:
    """Per-op trace records from a stored test dir's optrace.jsonl
    (tracing.py); [] when the run was not traced."""
    from .. import tracing

    return list(tracing.read_records(Path(d) / tracing.TRACE_FILE))


def load_nodes(d) -> list[dict]:
    """Node-plane records (samples, gaps, log events, breaker
    transitions) from a stored test dir's nodes.jsonl (nodeprobe.py);
    [] when the run was not probed."""
    from .. import nodeprobe

    return nodeprobe.load_records(d)
