"""Percent of wgl_search's bytes bound: the least time to move each
launch's bytes at the card's peak (harness/roofline.py) over the
kernel's time."""

from harness import readers


def read(run):
    return readers.wgl_search_roofline(run)
