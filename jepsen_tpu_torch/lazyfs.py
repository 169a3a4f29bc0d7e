"""lazyfs: filesystem-level durability faults — losing writes that were
never fsynced (the port's copy of jepsen_tpu/lazyfs.py).

Capability reference: jepsen/src/jepsen/lazyfs.clj — clone + build the
lazyfs FUSE filesystem at a pinned commit (22-108), mount a directory
through it with a TOML config + control FIFO (110-225), a DB wrapper
that mounts on setup / unmounts on teardown and exposes the lazyfs log
(227-244), `lose-unfsynced-writes!` via the FIFO command
`lazyfs::clear-cache` (246-263), `checkpoint!` via
`lazyfs::cache-checkpoint` (265-271), and a nemesis whose
:lose-unfsynced-writes op drops un-fsynced pages on chosen nodes
(273-295).
"""

from __future__ import annotations

from typing import Any

from . import control, db as jdb
from . import nemesis as jnemesis
from .control import util as cu

REPO_URL = "https://github.com/dsrhaslab/lazyfs.git"
COMMIT = "0.2.0"
DIR = "/opt/jepsen/lazyfs"
BIN = f"{DIR}/lazyfs/build/lazyfs"


def lazyfs(dir_or_map) -> dict:
    """Normalizes a directory (or partial map) into a full lazyfs map:
    the mount dir, its backing data dir, config/fifo/log paths, and the
    user to run as (lazyfs.clj `lazyfs`, 110-135)."""
    m = ({"dir": dir_or_map} if isinstance(dir_or_map, str)
         else dict(dir_or_map))
    d = m["dir"].rstrip("/")
    m.setdefault("user", "root")
    m.setdefault("chown", f"{m['user']}:{m['user']}")
    m.setdefault("data-dir", f"{d}.data")
    m.setdefault("lazyfs-dir", f"{d}.lazyfs")
    m.setdefault("config-file", f"{m['lazyfs-dir']}/lazyfs.conf")
    m.setdefault("fifo", f"{m['lazyfs-dir']}/fifo")
    m.setdefault("fifo-completed", f"{m['lazyfs-dir']}/fifo-completed")
    m.setdefault("log-file", f"{m['lazyfs-dir']}/lazyfs.log")
    return m


def config(lz: dict) -> str:
    """The lazyfs TOML config (lazyfs.clj `config`, 42-60)."""
    return f"""[faults]
fifo_path="{lz['fifo']}"

[cache]
apply_eviction=false

[cache.simple]
custom_size="{lz.get('cache-size', '0.5GB')}"
blocks_per_page=1

[filesystem]
logfile="{lz['log-file']}"
log_all_operations=false
"""


def install() -> None:
    """Clones, pins, and builds lazyfs on the node (lazyfs.clj
    `install!`, 62-108)."""
    with control.su():
        control.exec_("mkdir", "-p", DIR)
        if not cu.exists_p(f"{DIR}/.git"):
            control.exec_("git", "clone", REPO_URL, DIR)
        with control.cd(DIR):
            control.exec_("git", "fetch", "--tags")
            control.exec_("git", "checkout", COMMIT)
            with control.cd("libs/libpcache"):
                control.exec_("./build.sh")
            with control.cd("lazyfs"):
                control.exec_("./build.sh")


def mount(lz: dict) -> None:
    """Creates dirs + config and mounts dir through lazyfs backed by
    data-dir (lazyfs.clj `mount!`, 150-185)."""
    with control.su():
        control.exec_("mkdir", "-p", lz["dir"], lz["data-dir"],
                      lz["lazyfs-dir"])
        cu.write_file(config(lz), lz["config-file"])
        control.exec_(
            BIN, lz["dir"],
            "--config-path", lz["config-file"],
            "-o", "allow_other",
            "-o", "modules=subdir",
            "-o", f"subdir={lz['data-dir']}")
        control.exec_("chown", lz["chown"], lz["dir"])


def umount(lz: dict) -> None:
    """Unmounts; ignores failures (already unmounted / node died)."""
    try:
        with control.su():
            control.exec_("fusermount", "-u", lz["dir"])
    except Exception:  # noqa: BLE001
        pass


def fifo(lz: dict, command: str) -> None:
    """Writes a command to the lazyfs control FIFO (lazyfs.clj
    `fifo!`, 187-200)."""
    with control.su():
        control.exec_("sh", "-c",
                      f"echo {command} > {lz['fifo']}",
                      timeout=10.0)


def lose_unfsynced_writes(lz: dict) -> str:
    """Drops every write not yet fsynced (lazyfs.clj:246-263)."""
    fifo(lz, "lazyfs::clear-cache")
    return "done"


def checkpoint(lz: dict) -> str:
    """Flushes all cached writes to disk (lazyfs.clj:265-271)."""
    fifo(lz, "lazyfs::cache-checkpoint")
    return "done"


class LazyFSDB(jdb.DB):
    """Mount-wrapping DB: composes around (or stands alone beside) a
    database whose data lives in the lazyfs dir (lazyfs.clj DB record,
    227-244)."""

    def __init__(self, dir_or_map, inner: jdb.DB | None = None):
        self.lazyfs = lazyfs(dir_or_map)
        self.inner = inner

    def setup(self, test, node):
        install()
        mount(self.lazyfs)
        if self.inner is not None:
            self.inner.setup(test, node)

    def teardown(self, test, node):
        if self.inner is not None:
            self.inner.teardown(test, node)
        umount(self.lazyfs)

    def log_files(self, test, node):
        files = [self.lazyfs["log-file"]]
        if self.inner is not None:
            files += (self.inner.log_files(test, node) or [])
        return files

    # pass through Kill/Pause capability to the wrapped db
    @property
    def supports_kill(self):
        return self.inner is not None and self.inner.supports_kill

    @property
    def supports_pause(self):
        return self.inner is not None and self.inner.supports_pause

    def kill(self, test, node):
        out = (self.inner.kill(test, node)
               if self.inner is not None else None)
        # the interesting moment: process dead, page cache dropped
        lose_unfsynced_writes(self.lazyfs)
        return out

    def start(self, test, node):
        if self.inner is not None:
            return self.inner.start(test, node)

    def pause(self, test, node):
        if self.inner is not None:
            return self.inner.pause(test, node)

    def resume(self, test, node):
        if self.inner is not None:
            return self.inner.resume(test, node)


class LazyFSNemesis(jnemesis.Nemesis):
    """f=lose-unfsynced-writes over value=[node...] (lazyfs.clj
    `nemesis`, 273-295)."""

    def __init__(self, lz: dict):
        self.lazyfs = lazyfs(lz)

    def invoke(self, test, op):
        if op.f != "lose-unfsynced-writes":
            raise ValueError(f"unknown f {op.f!r}")
        nodes = op.value or test["nodes"]

        def one(t, node):
            return lose_unfsynced_writes(self.lazyfs)

        got = control.on_nodes(test, one, nodes)
        return op.copy(value=got)

    def fs(self):
        return {"lose-unfsynced-writes"}


def nemesis(lz) -> LazyFSNemesis:
    return LazyFSNemesis(lz)
