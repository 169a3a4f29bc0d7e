"""Seconds from the process's start to the window's: the program's import,
the inputs from the seed, the warm-up check (and, in a checkout's first
run, the kernels' build)."""


def read(run):
    return run["setup_s"]
