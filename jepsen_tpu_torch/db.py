"""Database automation protocols: install, start, stop, kill, pause (the
port's copy of jepsen_tpu/db.py).

Capability reference: jepsen/src/jepsen/db.clj (DB/Kill/Pause/Primary/
LogFiles protocols 12-48, log-files-map 50-80, cycle! 158-199). The
tcpdump DB (88-156) is dbs/tcpdump.py; the databases of the suites are
not ported.
"""

from __future__ import annotations

from . import util


class DB:
    """Sets up and tears down a database on a node."""

    def setup(self, test, node) -> None:
        pass

    def teardown(self, test, node) -> None:
        pass

    # -- optional protocols (db.clj:20-48). Implement by overriding and
    # setting the matching `supports_*` flag.
    supports_kill = False
    supports_pause = False
    supports_primaries = False

    def kill(self, test, node) -> None:
        """Forcibly terminates DB processes (Kill protocol)."""
        raise NotImplementedError

    def start(self, test, node) -> None:
        """Starts DB processes (Kill protocol)."""
        raise NotImplementedError

    def pause(self, test, node) -> None:
        """SIGSTOPs DB processes (Pause protocol)."""
        raise NotImplementedError

    def resume(self, test, node) -> None:
        """SIGCONTs DB processes (Pause protocol)."""
        raise NotImplementedError

    def primaries(self, test) -> list:
        """Nodes the DB currently considers primaries (Primary protocol)."""
        raise NotImplementedError

    def setup_primary(self, test, node) -> None:
        """One-time primary-node setup (Primary protocol)."""
        pass

    def log_files(self, test, node):
        """Log file paths (or {path: local-name} map) to download from the
        node (LogFiles protocol)."""
        return []


class NoopDB(DB):
    pass


noop = NoopDB()


def log_files_map(db: DB, test, node) -> dict:
    """Normalizes log_files output to {remote-path: local-filename}
    (db.clj:50-80)."""
    lf = db.log_files(test, node) or []
    if isinstance(lf, dict):
        return dict(lf)
    out = {}
    seen: dict[str, int] = {}
    for path in lf:
        name = str(path).rstrip("/").split("/")[-1]
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        else:
            seen[name] = 0
        out[path] = name
    return out


def cycle(db: DB, test, node, retries: int = 3) -> None:
    """teardown! then setup!, retrying on failure (db.clj:158-199)."""
    def once():
        db.teardown(test, node)
        db.setup(test, node)

    util.with_retry(once, retries=retries, backoff=1.0)
