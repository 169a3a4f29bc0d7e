"""Stateful wrappers for automatically reconnecting network clients
(the port's copy of jepsen_tpu/reconnect.py).

Capability reference: jepsen/src/jepsen/reconnect.clj:17-94 — a wrapper
holds an open/close function pair plus the current connection;
`with_conn` hands the live connection to a body and, when the body
throws, closes and reopens the connection before re-raising so the next
caller gets a fresh one. Open/close/reopen serialize on a lock while
many threads may use the current connection concurrently.
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)


class Wrapper:
    """See module docstring. Options mirror reconnect.clj `wrapper`:
    open() -> conn, close(conn), name (for logs), log ('minimal',
    True, or False)."""

    def __init__(self, open: Callable[[], Any],
                 close: Callable[[Any], None],
                 name: Any = None, log: Any = "minimal"):
        self._open = open
        self._close = close
        self.name = name
        self.log = log
        self._lock = threading.RLock()
        self._conn: Optional[Any] = None

    def conn(self):
        """The active connection, if one exists."""
        return self._conn

    def open(self) -> "Wrapper":
        """Opens a connection; no-op if already open."""
        with self._lock:
            if self._conn is None:
                c = self._open()
                if c is None:
                    raise RuntimeError(
                        f"reconnect wrapper {self.name!r}'s open "
                        "returned None instead of a connection")
                self._conn = c
        return self

    def close(self) -> "Wrapper":
        with self._lock:
            if self._conn is not None:
                try:
                    self._close(self._conn)
                finally:
                    self._conn = None
        return self

    def reopen(self) -> "Wrapper":
        """Closes (ignoring errors) and opens a fresh connection."""
        with self._lock:
            if self._conn is not None:
                try:
                    self._close(self._conn)
                except Exception:  # noqa: BLE001 — old conn may be dead
                    pass
                self._conn = None
            return self.open()

    def _handle_failure(self, conn, exc) -> None:
        """After a body failure: if the failing connection is still
        current, replace it (another thread may have already done
        so)."""
        if self.log == "minimal":
            logger.info("reconnect %r: error %r; reopening",
                        self.name, exc)
        elif self.log:
            logger.exception("reconnect %r: error; reopening",
                             self.name)
        # reconnects are span events on the op whose failure forced
        # them (or context-free during setup) — an op that limped
        # through a connection cycle carries the evidence
        from . import tracing

        tracing.event("reconnect", wrapper=str(self.name),
                      error=repr(exc)[:160])
        with self._lock:
            if self._conn is conn:
                try:
                    self.reopen()
                except Exception:  # noqa: BLE001 — reopen may also fail;
                    pass           # the next with_conn will retry it

    @contextmanager
    def with_conn(self, cycle_on: type | tuple = Exception):
        """Yields the current connection (opening if needed); when the
        body raises an exception matching cycle_on, cycles the
        connection before re-raising (other exceptions pass through
        with the connection intact)."""
        with self._lock:
            if self._conn is None:
                self.open()
            c = self._conn
        try:
            yield c
        except Exception as e:
            if isinstance(e, cycle_on):
                self._handle_failure(c, e)
            raise

    def call(self, f: Callable[[Any], Any]):
        with self.with_conn() as c:
            return f(c)
