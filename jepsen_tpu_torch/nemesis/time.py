"""Clock manipulation: stepping, strobing, and resetting node clocks
(the port's copy of jepsen_tpu/nemesis/time.py).

Capability reference: jepsen/src/jepsen/nemesis/time.clj — on-node C
helper compilation (21-67), reset/bump/strobe (86-102), clock-nemesis
ops :reset/:strobe/:bump/:check-offsets recording :clock-offsets
(104-167), randomized generators bumping +-2^2..2^18 ms (182-217).
The C sources live in the package's resources/ (our own implementations
of resources/bump-time.c and strobe-time.c).
"""

from __future__ import annotations

import logging
import os
import time as _time
from decimal import Decimal

from .. import control
from .. import generator as gen
from .. import util
from ..control import util as cu
from ..control.core import RemoteError
from .core import Nemesis

logger = logging.getLogger(__name__)

DIR = "/opt/jepsen"

_RESOURCES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "resources")


def compile_c(source_path: str, bin_name: str) -> str:
    """Uploads a local C source to /opt/jepsen/<bin>.c and gcc-compiles
    it, unless the binary already exists (time.clj:21-48)."""
    with control.su():
        if not cu.exists_p(f"{DIR}/{bin_name}"):
            logger.info("Compiling %s", bin_name)
            control.exec_("mkdir", "-p", DIR)
            control.exec_("chmod", "a+rwx", DIR)
            with open(source_path) as f:
                cu.write_file(f.read(), f"{DIR}/{bin_name}.c")
            with control.cd(DIR):
                control.exec_("gcc", "-O2", "-o", bin_name,
                              f"{bin_name}.c")
    return bin_name


def compile_tools() -> None:
    compile_c(os.path.join(_RESOURCES, "bump_time.c"), "bump-time")
    compile_c(os.path.join(_RESOURCES, "strobe_time.c"), "strobe-time")


def install() -> None:
    """Compiles the clock tools on the current node, installing gcc
    first if missing (time.clj:50-67)."""
    try:
        compile_tools()
    except RemoteError as e:
        if e.exit == 127 and "command not found" in (e.err or ""):
            from ..os_setup import debian
            debian.install(["build-essential"])
            compile_tools()
        else:
            raise


def parse_time(s: str) -> Decimal:
    return Decimal(s.strip())


def clock_offset(remote_time: Decimal) -> float:
    """Offset of a node clock reading against control wall time, in
    seconds (time.clj:73-84)."""
    return float(remote_time - Decimal(_time.time()))


def current_offset() -> float:
    return clock_offset(parse_time(control.exec_("date", "+%s.%N")))


def reset_time() -> None:
    """Resets the current node's clock via NTP (time.clj:86-90)."""
    with control.su():
        control.exec_("ntpdate", "-b", "time.google.com")


def bump_time(delta_ms) -> float:
    """Steps the clock by delta ms; returns the resulting offset in
    seconds (time.clj:92-96)."""
    with control.su():
        return clock_offset(parse_time(
            control.exec_(f"{DIR}/bump-time", delta_ms)))


def strobe_time(delta_ms, period_ms, duration_s) -> None:
    """Oscillates the clock by delta ms every period ms for duration s
    (time.clj:98-102)."""
    with control.su():
        control.exec_(f"{DIR}/strobe-time", delta_ms, period_ms,
                      duration_s)


def _meh_reset() -> None:
    """reset-time! tolerant of containers where stepping time is
    impossible (time.clj:118-131 commentary)."""
    try:
        reset_time()
    except RemoteError as e:
        if e.exit == 1:
            return
        raise


class ClockNemesis(Nemesis):
    """Manipulates node clocks (time.clj:104-167). Ops:

        {'f': 'reset',  'value': [node, ...]}
        {'f': 'strobe', 'value': {node: {'delta': ms, 'period': ms,
                                         'duration': s}, ...}}
        {'f': 'bump',   'value': {node: delta_ms, ...}}
        {'f': 'check-offsets'}

    Completions carry 'clock-offsets' {node: seconds}. The node
    observability plane merges these observations with its own
    per-tick offset readings (same clock_offset math) into the skew
    series that clock plots, Perfetto node tracks, and the
    `clock-skew-bound` on realtime verdicts are built from
    (nodeprobe.clock_series)."""

    def setup(self, test):
        def body(t, n):
            install()
            # the daemon is 'ntpd' on RHEL-likes, 'ntp' on Debian
            for svc in ("ntpd", "ntp"):
                try:
                    with control.su():
                        control.exec_("service", svc, "stop")
                except RemoteError:
                    pass
            _meh_reset()
        control.on_nodes(test, body)
        return self

    def invoke(self, test, op):
        if op.f == "reset":
            res = control.on_nodes(
                test, lambda t, n: (_meh_reset(), current_offset())[1],
                op.value)
        elif op.f == "check-offsets":
            res = control.on_nodes(test,
                                   lambda t, n: current_offset())
        elif op.f == "strobe":
            m = op.value

            def strobe(t, n):
                s = m[n]
                strobe_time(s["delta"], s["period"], s["duration"])
                return current_offset()

            res = control.on_nodes(test, strobe, list(m.keys()))
        elif op.f == "bump":
            m = op.value
            res = control.on_nodes(test, lambda t, n: bump_time(m[n]),
                                   list(m.keys()))
        else:
            raise ValueError(f"clock nemesis: unknown f {op.f!r}")
        return op.copy(**{"clock-offsets": res})

    def teardown(self, test):
        control.on_nodes(test, lambda t, n: _meh_reset())

    def fs(self):
        return {"reset", "strobe", "bump", "check-offsets"}

    def fault_kinds(self):
        # check-offsets is observational, not a fault: no kind, so the
        # coverage layer never records it as an injected disruption
        return {"bump": ("clock-bump", "pulse"),
                "strobe": ("clock-strobe", "pulse"),
                "reset": ("clock-reset", "pulse")}


def clock_nemesis() -> ClockNemesis:
    return ClockNemesis()


def _default_select(test):
    return util.random_nonempty_subset(test["nodes"])


def reset_gen_select(select):
    """Generator of reset ops over (select test) nodes
    (time.clj:169-180)."""
    def g(test, ctx):
        return {"type": "info", "f": "reset", "value": select(test)}
    return g


def bump_gen_select(select):
    """Clock bumps from -262s to +262s, exponentially distributed
    (time.clj:182-195)."""
    import random

    def g(test, ctx):
        return {"type": "info", "f": "bump",
                "value": {n: int(random.choice([-1, 1])
                                 * 2 ** (2 + random.random() * 16))
                          for n in (select(test) or [])}}
    return g


def strobe_gen_select(select):
    """Clock strobes: delta 4ms..262s, period 1ms..1s, duration 0-32s
    (time.clj:197-211)."""
    import random

    def g(test, ctx):
        return {"type": "info", "f": "strobe",
                "value": {n: {"delta": int(2 ** (2 + random.random()
                                                 * 16)),
                              "period": int(2 ** (random.random() * 10)),
                              "duration": random.random() * 32}
                          for n in (select(test) or [])}}
    return g


reset_gen = reset_gen_select(_default_select)
bump_gen = bump_gen_select(_default_select)
strobe_gen = strobe_gen_select(_default_select)


def clock_gen():
    """Random schedule of clock skew ops, starting with a
    check-offsets to establish a baseline (time.clj:213-220)."""
    return gen.phases({"type": "info", "f": "check-offsets"},
                      gen.mix([reset_gen, bump_gen, strobe_gen]))
