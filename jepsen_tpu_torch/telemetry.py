"""Counters, gauges and spans for the port's checking path.

The subset of jepsen_tpu/telemetry.py that encode, wgl and certify
report through, under the same metric names (`wgl.kernel.launches`,
`wgl.search.states`, ...), so a run of the port reads like a run of the
JAX package. Thread-safe; get() returns the process-wide recorder and
reset() clears it between runs.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator


class Telemetry:
    """A counter/gauge/span recorder. Every write takes one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, Any] = {}
        self._spans: list[dict] = []

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value) -> None:
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    @contextmanager
    def span(self, name: str, **attrs):
        """Records a named interval (monotonic ns) once the block ends."""
        rec: dict = {"name": name, "t0": time.monotonic_ns()}
        if attrs:
            rec["attrs"] = attrs
        try:
            yield rec
        finally:
            rec["t1"] = time.monotonic_ns()
            with self._lock:
                self._spans.append(rec)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict:
        with self._lock:
            return dict(self._gauges)

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._spans.clear()


_global = Telemetry()


def get() -> Telemetry:
    return _global


def count(name: str, n: int = 1) -> None:
    _global.count(name, n)


def gauge(name: str, value) -> None:
    _global.gauge(name, value)


def gauge_max(name: str, value) -> None:
    _global.gauge_max(name, value)


def span(name: str, **attrs):
    return _global.span(name, **attrs)


def reset() -> None:
    _global.reset()


def read_jsonl(path) -> Iterator[dict]:
    """Records from a JSONL artifact; a torn or corrupt trailing line
    (the writer died, or is still writing) is dropped rather than
    raised. The crash-tolerance contract of optrace.jsonl and
    nodes.jsonl (tracing.read_records, nodeprobe.read_records)."""
    p = Path(path)
    if not p.exists():
        return
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                return
