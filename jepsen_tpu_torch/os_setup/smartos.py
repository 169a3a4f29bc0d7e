"""SmartOS node preparation (the port's copy of
jepsen_tpu/os_setup/smartos.py): pkgin-flavored analog of the Debian
layer.

Capability reference: jepsen/src/jepsen/os/smartos.clj — hostfile
setup (12-25), pkgin update with a rate limit (27-45), installed
queries via `pkgin -p list` (46-86), install via `pkgin -y install`
(87-107), and enabling ipfilter through svcadm so partitions work
(120-132).
"""

from __future__ import annotations

import logging

from .. import control, util
from . import OS, debian

logger = logging.getLogger(__name__)

PACKAGES = ["curl", "wget", "unzip", "rsyslog", "gcc10"]


def installed(pkgs) -> set:
    """Subset of pkgs already installed. `pkgin -p list` prints
    `name-version;comment` — strip the comment BEFORE splitting off
    the version, or the last hyphen lands inside the comment
    (smartos.clj:46-58)."""
    out = control.exec_("pkgin", "-p", "list", check=False) or ""
    have = {line.split(";", 1)[0].rsplit("-", 1)[0]
            for line in out.splitlines() if line}
    return {p for p in pkgs if p in have}


def install(pkgs) -> None:
    """pkgin -y install any missing packages (smartos.clj:87-107)."""
    missing = sorted(set(pkgs) - installed(pkgs))
    if missing:
        logger.info("Installing %s", missing)
        with control.su():
            control.exec_("pkgin", "-y", "install", *missing)


def uninstall(pkgs) -> None:
    pkgs = sorted(set(pkgs) & installed(pkgs))
    if pkgs:
        with control.su():
            control.exec_("pkgin", "-y", "remove", *pkgs)


def update() -> None:
    """pkgin update (smartos.clj:33-36)."""
    with control.su():
        control.exec_("pkgin", "update")


def maybe_update() -> None:
    """Updates at most once a day, keyed off the pkgin db mtime
    (smartos.clj:27-45); a fresh node with no db updates
    unconditionally (the first install fails otherwise)."""
    now = control.exec_("date", "+%s", check=False)
    mtime = control.exec_("stat", "-c", "%Y", "/var/db/pkgin/sql.log",
                          check=False)
    try:
        if int(now) - int(mtime) < 86400:
            return
    except (TypeError, ValueError):
        pass  # no db yet: definitely update
    update()


def enable_ipfilter() -> None:
    """Partitions on SmartOS go through ipfilter; enable its service
    (smartos.clj:120-132)."""
    with control.su():
        control.exec_("svcadm", "enable", "-r", "ipfilter")


class SmartOS(OS):
    """OS protocol impl (os.clj:4-9) for SmartOS nodes."""

    packages = PACKAGES

    def setup(self, test, node):
        logger.info("%s setting up smartos", node)
        debian.setup_hostfile()
        maybe_update()
        install(self.packages)
        enable_ipfilter()
        net = test.get("net")
        if net is not None:  # heal leftover partitions, like Debian
            util.meh(lambda: net.heal(test))

    def teardown(self, test, node):
        pass


os = SmartOS()
