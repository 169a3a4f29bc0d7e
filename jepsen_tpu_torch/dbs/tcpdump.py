"""A DB wrapper that captures packets from setup to teardown (the
port's copy of jepsen_tpu/dbs/tcpdump.py).

Capability reference: jepsen/src/jepsen/db.clj tcpdump (88-156): runs a
tcpdump daemon per node, filters by ports/clients/custom expression,
and exposes the capture + log via log_files.
"""

from __future__ import annotations

import logging
import time

from .. import control, net, util
from ..control import util as cu
from ..control.core import RemoteError
from ..db import DB

logger = logging.getLogger(__name__)

DIR = "/tmp/jepsen/tcpdump"
LOG_FILE = f"{DIR}/log"
CAP_FILE = f"{DIR}/tcpdump"
PID_FILE = f"{DIR}/pid"


class Tcpdump(DB):
    """Options: ports (list), clients_only (bool), filter (str)."""

    def __init__(self, ports=(), clients_only: bool = False,
                 filter: str | None = None):
        self.ports = list(ports)
        self.clients_only = clients_only
        self.filter = filter

    def _filter_str(self) -> str:
        filters = []
        if self.ports:
            filters.append(" or ".join(f"port {p}" for p in self.ports))
        if self.clients_only:
            filters.append(f"host {net.control_ip()}")
        if self.filter:
            filters.append(self.filter)
        return " and ".join(filters)

    def setup(self, test, node):
        with control.su():
            control.exec_("mkdir", "-p", DIR)
            cu.start_daemon(
                {"logfile": LOG_FILE, "pidfile": PID_FILE, "chdir": DIR},
                "/usr/bin/tcpdump", "-w", CAP_FILE, "-s", 65535,
                "-B", 16384, "-U", self._filter_str())

    def teardown(self, test, node):
        with control.su():
            try:
                pid = control.exec_("cat", PID_FILE)
            except RemoteError:
                pid = None
            if pid:
                # SIGINT first so tcpdump flushes its capture
                util.meh(lambda: control.exec_("kill", "-s", "INT", pid))
                while True:
                    try:
                        control.exec_("ps", "-p", pid)
                    except RemoteError:
                        break
                    logger.info("Waiting for tcpdump %s to exit", pid)
                    time.sleep(0.05)
            cu.stop_daemon("tcpdump", PID_FILE)
            control.exec_("rm", "-rf", DIR)

    def log_files(self, test, node):
        return {LOG_FILE: "tcpdump.log", CAP_FILE: "tcpdump.pcap"}


def tcpdump(ports=(), clients_only: bool = False,
            filter: str | None = None) -> Tcpdump:
    return Tcpdump(ports, clients_only, filter)
