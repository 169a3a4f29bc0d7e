"""Events checked a second: the events of every history whose verdict came
inside the window, over the time to the last of them."""

from harness import readers


def read(run):
    return readers.events_per_s(run)
