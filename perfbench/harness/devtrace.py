"""The device's timeline in a traced run: torch.profiler over the window
(CUDA activity from CUPTI, and the harness's own markers around each
check on the host), reduced to the device's busy seconds over the
window, the device operations that took most time, and the idle time by
what the host was doing, named by the program's telemetry spans.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "perfbench.check"
TOP = 10


def union_length(intervals: list) -> float:
    """Total length covered by (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list, w0: float, w1: float) -> list:
    """The parts of [w0, w1] that no interval covers."""
    out = []
    t = w0
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, w1)))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(s, e) for s, e in out if e > s]


def attribute(idle: list, spans: list) -> dict:
    """Time of the `idle` intervals by the innermost (shortest) of the
    host `spans` (name, start, end) open at the time, and "outside the
    program's spans" where none is. All times in one unit."""
    bounds = []
    for i, (s, e) in enumerate(idle):
        bounds += [(s, 0, "gap", i), (e, 1, "gap", i)]
    for i, (name, s, e) in enumerate(spans):
        bounds += [(s, 0, "span", i), (e, 1, "span", i)]
    bounds.sort(key=lambda b: (b[0], -b[1]))
    out: dict = {}
    open_spans: dict = {}
    in_gap = 0
    last = None
    for t, kind_end, what, i in bounds:
        if last is not None and t > last and in_gap:
            name = (min(open_spans.values())[1] if open_spans
                    else "outside the program's spans")
            out[name] = out.get(name, 0.0) + (t - last)
        last = t
        step = -1 if kind_end else 1
        if what == "gap":
            in_gap += step
        elif kind_end:
            open_spans.pop(i, None)
        else:
            name, s, e = spans[i]
            open_spans[i] = (e - s, name)
    return out


class Tracer:
    """torch.profiler over the window, with a marker around each check
    so the host's clock can be matched to the trace's."""

    def __init__(self):
        self._prof = None
        self.trace_bytes = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()

    def marker(self):
        from torch.profiler import record_function

        return record_function(MARKER)

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    def _events(self) -> list:
        """The trace's events, through a Chrome trace written to a
        temporary directory under TMPDIR and removed at once."""
        tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
        path = os.path.join(tmp, "trace.json")
        try:
            self._prof.export_chrome_trace(path)
            self.trace_bytes = os.path.getsize(path)
            with open(path) as f:
                return json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def reduce(self, windows: list, host_spans: list) -> dict | None:
        """The device summary over `windows`, the (t0, t1) intervals of
        the checks done inside the window on the program's relative
        clock (ns; in order, each with a marker in the trace), given the
        telemetry spans (name, t0, t1) on that clock; None where the
        trace holds no marker."""
        if self._prof is None or not windows:
            return None
        events = self._events()
        marks = sorted(e["ts"] for e in events
                       if e.get("name") == MARKER and e.get("ph") == "X")
        if not marks:
            return None
        # trace us = host ns / 1000 + offset, from the first check's
        # marker, opened just after its host stamp
        offset = marks[0] - windows[0][0] / 1e3
        win = [(a / 1e3 + offset, b / 1e3 + offset) for a, b in windows]
        dev = []
        by_name: dict = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            s0 = float(e["ts"])
            s1 = s0 + float(e.get("dur", 0))
            for w0, w1 in win:
                s, t = max(s0, w0), min(s1, w1)
                if t > s:
                    dev.append((s, t))
                    by_name[e["name"]] = (by_name.get(e["name"], 0.0)
                                          + (t - s))
        busy_us = union_length(dev)
        idle = [g for w0, w1 in win for g in gaps(dev, w0, w1)]
        spans = [(n, a / 1e3 + offset, b / 1e3 + offset)
                 for n, a, b in host_spans]
        by_host = attribute(idle, spans)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"busy_s": busy_us / 1e6,
                "window_s": sum(w1 - w0 for w0, w1 in win) / 1e6,
                "device_ops": [[n, us / 1e6] for n, us in top],
                "idle_gaps": [[n, us / 1e6] for n, us in idle_top]}
