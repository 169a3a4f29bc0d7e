"""The reader half of jepsen_tpu/nodeprobe.py: the node observability
plane's records a probed run leaves in its store directory (nodes.jsonl:
per-node samples, probe gaps, tagged DB-log events, breaker
transitions), read back for the node context of the anomaly trace
excerpts (reports/explain.py).

The probe that samples the nodes while a test runs belongs to the test
runner and is not part of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

from . import telemetry

NODES_FILE = "nodes.jsonl"


def read_records(path) -> Iterable[dict]:
    """Records from a nodes.jsonl; a torn trailing line is dropped (the
    shared jsonl crash-tolerance contract)."""
    return telemetry.read_jsonl(path)


def load_records(store_dir) -> list[dict]:
    """All node-plane records of a stored run ([] when the run was not
    probed)."""
    if not store_dir:
        return []
    return list(read_records(Path(store_dir) / NODES_FILE))
