"""The benchmark's frozen roofline arithmetic for the `wgl_search` launch
(a copy of the bytes term of chip_smoke.py's `_launch_bound`), and the
card's published peak. Kept here so that the share reads the same work
whatever kernel implements the launch and whatever the program's own
cost formulas say.

The operations term of `_launch_bound` counts configurations from the
kernel's own level series, that is from the kernel's outputs, so it is
left out: the share is of the bytes bound alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12


def wgl_search_bytes(entries: int, states: int, rows: int,
                     max_iters: int) -> int:
    """Bytes one launch must move, from its input shapes: each packed
    entry of the rows' segments read once (invocation, completion and
    suffix-minimum positions and a transition row of `states` int32),
    each row's segment and start state read once (8 bytes), each row's
    outputs written once (result or mask, unknown flag: 6 bytes), and
    the three level series of `max_iters` int32 written once."""
    return (entries * 4 * (3 + states) + rows * 8 + rows * 6
            + 3 * 4 * max_iters)


def least_seconds(nbytes: int) -> float:
    """The least time the card could take to move `nbytes`."""
    return nbytes / PEAK_BYTES_PER_S
