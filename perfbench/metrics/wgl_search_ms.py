"""Milliseconds of the wgl_search kernel a check, between the CUDA events
around each launch (gpu/profiler.py records' compute_ns)."""

from harness import readers


def read(run):
    return readers.kernel_ms_per_check(run)
