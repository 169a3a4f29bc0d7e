"""CentOS node preparation: yum-flavored analog of the Debian layer
(the port's copy of jepsen_tpu/os_setup/centos.py).

Capability reference: jepsen/src/jepsen/os/centos.clj — hostfile setup
(12-26), yum update with a rate limit (27-45), installed/version
queries via rpm -qa (46-87), install via yum -y (88-109), building
start-stop-daemon from the dpkg source tarball because CentOS doesn't
ship it (110-156), and the OS record wiring (158).
"""

from __future__ import annotations

import logging

from .. import control
from ..control import util as cu
from . import OS, debian

logger = logging.getLogger(__name__)

PACKAGES = [
    "wget", "gcc", "gcc-c++", "curl", "vim-common", "unzip", "rsyslog",
    "iptables", "ncurses-devel", "iproute", "logrotate",
]

DPKG_TARBALL = ("http://ftp.de.debian.org/debian/pool/main/d/dpkg/"
                "dpkg_1.17.27.tar.xz")


def installed(pkgs) -> set:
    """Subset of pkgs already installed (rpm query)."""
    out = control.exec_("rpm", "-qa", "--qf", "%{NAME}\\n", check=False)
    have = set((out or "").split())
    return {p for p in pkgs if p in have}


def install(pkgs) -> None:
    """yum -y install any missing packages (centos.clj:88-109)."""
    missing = sorted(set(pkgs) - installed(pkgs))
    if missing:
        logger.info("Installing %s", missing)
        control.exec_("yum", "-y", "install", *missing)


def installed_start_stop_daemon_p() -> bool:
    return cu.exists_p("/usr/bin/start-stop-daemon")


def install_start_stop_daemon() -> None:
    """Builds start-stop-daemon from the dpkg source tarball — CentOS
    has no native package for it (centos.clj:110-156; the reference's
    absolute /dpkg-1.17.27 cp only works when run from /, so this
    version anchors the whole build in a workdir instead)."""
    logger.info("Installing start-stop-daemon")
    workdir = "/tmp/jepsen/dpkg-build"
    with control.su():
        control.exec_("mkdir", "-p", workdir)
        with control.cd(workdir):
            control.exec_("wget", DPKG_TARBALL)
            control.exec_("tar", "-xf", "dpkg_1.17.27.tar.xz")
            with control.cd("dpkg-1.17.27"):
                control.exec_("./configure")
                control.exec_("make")
                control.exec_("cp", "utils/start-stop-daemon",
                              "/usr/bin/start-stop-daemon")
        control.exec_("rm", "-rf", workdir)


class CentOS(OS):
    """OS protocol impl (os.clj:4-9) for CentOS nodes."""

    packages = PACKAGES

    def setup(self, test, node):
        logger.info("%s setting up centos", node)
        debian.setup_hostfile()
        with control.su():
            install(self.packages)
        if not installed_start_stop_daemon_p():
            install_start_stop_daemon()

    def teardown(self, test, node):
        pass


os = CentOS()
