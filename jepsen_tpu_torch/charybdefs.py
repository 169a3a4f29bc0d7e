"""CharybdeFS: syscall-level fault injection (EIO and friends) through
a FUSE passthrough filesystem (the port's copy of
jepsen_tpu/charybdefs.py).

Capability reference: charybdefs/src/jepsen/charybdefs.clj — build
thrift + charybdefs from source (7-65), mount /faulty over /real
(55-65), and cookbook faults: every operation fails with EIO
(break-all, 72-75), 1% of operations fail (break-one-percent, 77-80),
clear (82-85). Plus a nemesis wiring those as ops.
"""

from __future__ import annotations

from . import control
from . import nemesis as jnemesis
from .control import util as cu
from .os_setup import debian

DIR = "/opt/charybdefs"
BIN = f"{DIR}/charybdefs"
FAULTY = "/faulty"
REAL = "/real"
THRIFT_URL = ("http://www-eu.apache.org/dist/thrift/0.10.0/"
              "thrift-0.10.0.tar.gz")
THRIFT_DIR = "/opt/thrift"


def install_thrift() -> None:
    """Builds thrift from source (charybdefs.clj:30-43); needs the
    build toolchain already installed."""
    cu.install_archive(THRIFT_URL, THRIFT_DIR)
    with control.cd(THRIFT_DIR):
        control.exec_("./configure", "--prefix=/usr")
        control.exec_("make", "-j4")
        with control.su():
            control.exec_("make", "install")
    with control.cd(f"{THRIFT_DIR}/lib/py"):
        with control.su():
            control.exec_("python", "setup.py", "install")


def install() -> None:
    """Builds charybdefs and mounts FAULTY over REAL
    (charybdefs.clj:45-65). Toolchain first: thrift's configure/make
    need a compiler on a fresh node."""
    if not cu.exists_p(BIN):
        with control.su():
            debian.install(["build-essential", "cmake", "libfuse-dev",
                            "fuse"])
            control.exec_("mkdir", "-p", DIR)
            control.exec_("chmod", "777", DIR)
        install_thrift()
        control.exec_("git", "clone", "--depth", "1",
                      "https://github.com/scylladb/charybdefs.git", DIR)
        with control.cd(DIR):
            control.exec_("thrift", "-r", "--gen", "cpp",
                          "server.thrift")
            control.exec_("cmake", "CMakeLists.txt")
            control.exec_("make")
    with control.su():
        control.exec_("modprobe", "fuse")
        control.exec_("sh", "-c", f"umount {FAULTY} || /bin/true")
        control.exec_("mkdir", "-p", REAL, FAULTY)
        control.exec_(BIN, FAULTY,
                      f"-oallow_other,modules=subdir,subdir={REAL}")
        control.exec_("chmod", "777", REAL, FAULTY)


def _cookbook(flag: str) -> None:
    with control.cd(f"{DIR}/cookbook"):
        control.exec_("./recipes", flag)


def break_all() -> None:
    """Every filesystem operation fails with EIO
    (charybdefs.clj:72-75)."""
    _cookbook("--io-error")


def break_one_percent() -> None:
    """1% of operations fail (charybdefs.clj:77-80)."""
    _cookbook("--probability")


def clear() -> None:
    """Removes the active fault injection (charybdefs.clj:82-85)."""
    _cookbook("--clear")


class CharybdeFSNemesis(jnemesis.Nemesis):
    """Ops: f='break-all'|'break-one-percent'|'clear-faults', value a
    node list (default: all)."""

    _FS = {"break-all": break_all,
           "break-one-percent": break_one_percent,
           "clear-faults": clear}

    def invoke(self, test, op):
        f = self._FS.get(op.f)
        if f is None:
            raise ValueError(f"unknown f {op.f!r}")
        nodes = op.value or test["nodes"]
        got = control.on_nodes(test, lambda t, n: f() or "done", nodes)
        return op.copy(value=got)

    def teardown(self, test):
        try:
            control.on_nodes(test, lambda t, n: clear() or None,
                             test.get("nodes"))
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass

    def fs(self):
        return set(self._FS)


def nemesis() -> CharybdeFSNemesis:
    return CharybdeFSNemesis()
