"""wgl_search launches a check: the program's counter wgl.kernel.launches
(gpu/wgl.py)."""

from harness import readers


def read(run):
    return readers.counter_per_check(run, "wgl.kernel.launches")
