"""libfaketime wrappers: per-process clock-rate skew (the port's copy
of jepsen_tpu/faketime.py).

Capability reference: jepsen/src/jepsen/faketime.clj — build the
pinned libfaketime fork (8-23), generate a wrapper script running a
binary under `faketime -m -f "+OFFSETs xRATE"` (25-36), atomically
swap a binary for its wrapper / restore it (38-56), and `rand-factor`
for choosing clock rates spread around 1 (58-65).
"""

from __future__ import annotations

import random

from . import control
from .control import util as cu

REPO_URL = "https://github.com/jepsen-io/libfaketime.git"
BRANCH = "0.9.6-jepsen1"
BUILD_DIR = "/tmp/jepsen/libfaketime-jepsen"


def install() -> None:
    """Builds + installs the patched libfaketime (faketime.clj:8-23)."""
    with control.su():
        control.exec_("mkdir", "-p", "/tmp/jepsen")
        if not cu.exists_p(BUILD_DIR):
            control.exec_("git", "clone", REPO_URL, BUILD_DIR)
        with control.cd(BUILD_DIR):
            control.exec_("git", "checkout", BRANCH)
            control.exec_("make")
            control.exec_("make", "install")


def script(cmd: str, init_offset: float, rate: float) -> str:
    """A wrapper script body invoking cmd under faketime
    (faketime.clj:25-36)."""
    off = int(init_offset)
    sign = "-" if off < 0 else "+"
    return ("#!/bin/bash\n"
            f'faketime -m -f "{sign}{abs(off)}s x{float(rate)}" '
            f'{cmd} "$@"\n')


def wrap(cmd: str, init_offset: float, rate: float) -> None:
    """Replaces the executable at cmd with a faketime wrapper calling
    the original (moved to cmd.no-faketime). Idempotent
    (faketime.clj:38-48)."""
    orig = f"{cmd}.no-faketime"
    body = script(orig, init_offset, rate)
    if not cu.exists_p(orig):
        control.exec_("mv", cmd, orig)
    cu.write_file(body, cmd)
    control.exec_("chmod", "a+x", cmd)


def unwrap(cmd: str) -> None:
    """Restores the original binary if a wrapper is installed
    (faketime.clj:50-56)."""
    orig = f"{cmd}.no-faketime"
    if cu.exists_p(orig):
        control.exec_("mv", orig, cmd)


def rand_factor(factor: float, rng=None) -> float:
    """A clock rate near 1 such that across calls, max_rate <= factor
    * min_rate (faketime.clj:58-65)."""
    rng = rng or random
    hi = 2.0 / (1.0 + 1.0 / factor)
    lo = hi / factor
    return lo + rng.random() * (hi - lo)
