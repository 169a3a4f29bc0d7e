"""Debian node preparation (the port's copy of
jepsen_tpu/os_setup/debian.py).

Capability reference: jepsen/src/jepsen/os/debian.clj — hostfile setup
(17-31), apt update throttling (33-48), installed/install with per-node
locks (50-127), add-key!/add-repo! (129-150), the Debian OS impl
(160-190).
"""

from __future__ import annotations

import logging
import re

from .. import control, util
from ..control import util as cu
from ..control.core import Lit
from . import OS

logger = logging.getLogger(__name__)

# Prevents concurrent apt operations on the same node (debian.clj:13-15).
node_locks = util.named_locks()


def setup_hostfile() -> None:
    """Ensures /etc/hosts has a plain loopback entry
    (debian.clj:17-31)."""
    hosts = control.exec_("cat", "/etc/hosts")
    lines = [("127.0.0.1\tlocalhost"
              if re.match(r"^127\.0\.0\.1\t", line) else line)
             for line in hosts.split("\n")]
    hosts2 = "\n".join(lines)
    if hosts != hosts2:
        with control.su():
            control.exec_("echo", hosts2, Lit(">"), "/etc/hosts")


def time_since_last_update() -> int:
    """Seconds since the last apt-get update (debian.clj:33-38).
    Unparseable output (e.g. the dummy remote's empty replies) reads
    as stale, so the harmless apt-get update runs."""
    try:
        now = int(control.exec_("date", "+%s"))
        then = control.exec_("stat", "-c", "%Y",
                             "/var/cache/apt/pkgcache.bin", Lit("||"),
                             "echo", 0)
        return now - int(then or 0)
    except ValueError:
        return 10**9


def update() -> None:
    """apt-get update, serialized per node (debian.clj:40-44)."""
    with node_locks.hold(control.current_node()):
        with control.su():
            control.exec_("apt-get", "--allow-releaseinfo-change",
                          "update")


def maybe_update() -> None:
    """apt-get update if stale by more than a day (debian.clj:46-48)."""
    if time_since_last_update() > 86400:
        update()


def installed(pkgs) -> set:
    """The subset of pkgs currently installed (debian.clj:50-62).
    Lists all selections and filters host-side: dpkg exits 1 when a
    named pattern matches nothing (i.e. on any fresh node)."""
    pkgs = {str(p) for p in pkgs}
    out = control.exec_("dpkg", "--get-selections")
    got = set()
    for line in out.split("\n"):
        parts = line.split()
        if len(parts) >= 2 and parts[1] == "install":
            got.add(re.sub(r":amd64|:i386", "", parts[0]))
    return got & pkgs


def installed_p(pkg_or_pkgs) -> bool:
    pkgs = (pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set))
            else [pkg_or_pkgs])
    return set(map(str, pkgs)) <= installed(pkgs)


def installed_version(pkg) -> str | None:
    """Installed version of a package, or None (debian.clj:73-79)."""
    out = control.exec_("apt-cache", "policy", str(pkg))
    m = re.search(r"Installed: ([^\s]+)", out)
    v = m.group(1) if m else None
    return None if v in (None, "(none)") else v


def uninstall(pkg_or_pkgs) -> None:
    """Removes packages (debian.clj:64-71)."""
    pkgs = (pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set))
            else [pkg_or_pkgs])
    pkgs = installed(pkgs)
    if not pkgs:
        return
    with node_locks.hold(control.current_node()):
        with control.su():
            control.exec_("apt-get", "remove", "--purge", "-y",
                          *sorted(pkgs))


def install(pkgs, apt_opts=()) -> None:
    """Ensures packages are installed; a dict pins versions
    (debian.clj:81-127)."""
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if version != installed_version(pkg):
                with node_locks.hold(control.current_node()):
                    logger.info("Installing %s %s", pkg, version)
                    with control.su():
                        control.exec_(
                            "env", "DEBIAN_FRONTEND=noninteractive",
                            "apt-get", "install", "-y",
                            "--allow-downgrades",
                            "--allow-change-held-packages", *apt_opts,
                            f"{pkg}={version}")
        return
    pkgs = {str(p) for p in pkgs}
    missing = pkgs - installed(pkgs)
    if not missing:
        return
    with node_locks.hold(control.current_node()):
        logger.info("Installing %s", sorted(missing))
        with control.su():
            control.exec_("env", "DEBIAN_FRONTEND=noninteractive",
                          "apt-get", "install", "-y",
                          "--allow-downgrades",
                          "--allow-change-held-packages", *apt_opts,
                          *sorted(missing))


def add_key(keyserver, key) -> None:
    """Receives an apt key (debian.clj:129-135)."""
    with control.su():
        control.exec_("apt-key", "adv", "--keyserver", keyserver,
                      "--recv", key)


def add_repo(repo_name, apt_line, keyserver=None, key=None) -> None:
    """Adds an apt repo and optional key (debian.clj:137-150)."""
    list_file = f"/etc/apt/sources.list.d/{repo_name}.list"
    if cu.exists_p(list_file):
        return
    logger.info("setting up %s apt repo", repo_name)
    if keyserver or key:
        add_key(keyserver, key)
    control.exec_("echo", apt_line, Lit(">"), list_file)
    update()


DEFAULT_PACKAGES = [
    "apt-transport-https", "libzip4", "wget", "curl", "vim", "man-db",
    "faketime", "netcat-openbsd", "ntpdate", "unzip", "iptables",
    "psmisc", "tar", "bzip2", "iputils-ping", "iproute2", "rsyslog",
    "logrotate", "dirmngr", "tcpdump",
]


class Debian(OS):
    """Debian box preparation (debian.clj:160-190)."""

    packages = DEFAULT_PACKAGES

    def setup(self, test, node) -> None:
        logger.info("%s setting up debian", node)
        setup_hostfile()
        maybe_update()
        install(self.packages)
        net = test.get("net")
        if net is not None:
            util.meh(lambda: net.heal(test))

    def teardown(self, test, node) -> None:
        pass


os = Debian()
