"""Milliseconds of host encode a check: the program's counter
profiler.encode.wall_ns (gpu/encode.py)."""

from harness import readers


def read(run):
    return readers.counter_per_check(run, "profiler.encode.wall_ns", 1e-6)
