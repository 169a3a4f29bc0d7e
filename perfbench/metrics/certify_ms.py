"""Milliseconds of certificate extraction a check: the program's spans
certify.attach (gpu/certify.py)."""

from harness import readers


def read(run):
    return readers.span_ms_per_check(run, "certify.attach")
