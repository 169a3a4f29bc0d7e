"""Percent of the traced window in which no operation ran on the device
(torch.profiler's CUDA activity)."""

from harness import readers


def read(run):
    return readers.idle_pct(run)
