"""Shared arithmetic of the metric readers under metrics/. A reader is
`read(run) -> float | None`, where `run` holds the cell's name, the
window's length, set-up seconds, the checks done inside the window
(`checks`: each with its events, the window's clock when it was done,
the program's answer and, in a traced run, its telemetry) and, in a
traced run, the device summary (`device`). None means nothing to read:
the harness leaves the metric out of the line."""

from __future__ import annotations

from . import roofline


def answered(run: dict) -> list:
    """The checks done inside the window that returned an answer."""
    return [c for c in run["checks"] if c["answer"] is not None]


def traced(run: dict) -> list:
    return [c["telemetry"] for c in run["checks"] if "telemetry" in c]


def span_ms_per_check(run: dict, name: str) -> float | None:
    """Milliseconds a check spent in the program's spans `name`, mean
    over the window's checks."""
    tel = traced(run)
    if not any(n == name for t in tel for n, _a, _b in t["spans"]):
        return None
    total = sum(b - a for t in tel for n, a, b in t["spans"] if n == name)
    return total / len(tel) / 1e6


def counter_per_check(run: dict, name: str, scale: float = 1.0
                      ) -> float | None:
    """The program's counter `name` a check, times `scale`, mean over the
    window's checks."""
    tel = traced(run)
    if not any(name in t["counters"] for t in tel):
        return None
    return sum(t["counters"].get(name, 0) for t in tel) / len(tel) * scale


def kernel_ms_per_check(run: dict) -> float | None:
    """Milliseconds of wgl_search a check, between the CUDA events the
    launcher records around each kernel (the profiler's compute_ns)."""
    tel = traced(run)
    ns = [x for t in tel for x in t["kernel_ns"] if x is not None]
    if not ns:
        return None
    return sum(ns) / len(tel) / 1e6


def wgl_search_roofline(run: dict) -> float | None:
    """Percent of the bytes bound: the least seconds the card needs to
    move every launch's bytes (frozen arithmetic, harness/roofline.py)
    over the kernels' seconds, summed over the window's launches."""
    tel = traced(run)
    nbytes = 0
    kernel_ns = 0
    for t in tel:
        ns = [x for x in t["kernel_ns"] if x is not None]
        if len(ns) != len(t["launches"]) or not ns:
            return None
        kernel_ns += sum(ns)
        nbytes += sum(roofline.wgl_search_bytes(**x)
                      for x in t["launches"])
    if not kernel_ns:
        return None
    return 100.0 * roofline.least_seconds(nbytes) / (kernel_ns / 1e9)


def idle_pct(run: dict) -> float | None:
    """Percent of the traced window in which no operation ran on the
    device."""
    dev = run.get("device")
    if not dev or not dev["window_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def events_per_s(run: dict) -> float | None:
    """Events of every history whose verdict was returned inside the
    window, over the time from the window's start to the last of them."""
    done = answered(run)
    if not done:
        return None
    return sum(c["events"] for c in done) / done[-1]["done"]

