"""Milliseconds of the independent checker's split into per-key histories a
check: the program's spans independent:subhistories (independent.py)."""

from harness import readers


def read(run):
    return readers.span_ms_per_check(run, "independent:subhistories")
