"""Node control DSL: ambient per-thread sessions + parallel node maps
(the port's copy of jepsen_tpu/control/__init__.py).

Where the reference uses Clojure dynamic vars (*session*, *host*, ...)
rebound around node operations (jepsen/src/jepsen/control.clj:43-57,
130-150, on-nodes), we use contextvars carried into worker threads.

Usage:

    with control.with_session(test, node):
        control.exec_("echo", "hi")

    control.on_nodes(test, lambda test, node: control.exec_("date"))

The port drives nodes through the dummy remote only: test["remote"], or
test["ssh"]["dummy"]. The SSH transport, its scp and retry wrappers and
the quarantine breakers (GuardedRemote) are ROADMAP A3c; a test that
needs them raises NotImplementedError.
"""

from __future__ import annotations

import contextvars
import logging
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, Callable

from .core import (Action, Remote, RemoteError, Result, Session, escape,
                   join_cmd, throw_on_nonzero_exit, traced_execute,
                   traced_transfer, wrap_sudo)
from .dummy import DummyRemote, dummy

logger = logging.getLogger(__name__)

_session: contextvars.ContextVar = contextvars.ContextVar(
    "control_session", default=None)
_node: contextvars.ContextVar = contextvars.ContextVar(
    "control_node", default=None)
_sudo: contextvars.ContextVar = contextvars.ContextVar(
    "control_sudo", default=None)
_dir: contextvars.ContextVar = contextvars.ContextVar(
    "control_dir", default=None)


def conn_spec(test: dict, node) -> dict:
    """SSH connection options for a node (control.clj session opts)."""
    ssh = dict(test.get("ssh") or {})
    return {
        "host": node,
        "username": ssh.get("username", "root"),
        "password": ssh.get("password"),
        "port": ssh.get("port", 22),
        "private_key_path": ssh.get("private_key_path"),
        "strict_host_key_checking": ssh.get("strict_host_key_checking", False),
        "sudo_password": ssh.get("sudo_password"),
    }


def remote_for(test: dict) -> Remote:
    r = test.get("remote")
    if r is None:
        if not (test.get("ssh") or {}).get("dummy"):
            raise NotImplementedError(
                "the SSH remote (control/ssh.py, scp.py, retry.py) is "
                "not ported (ROADMAP A3c): pass test['remote'] or "
                "test['ssh'] = {'dummy': True}")
        r = dummy
    return r


def session(test: dict, node) -> Session:
    return remote_for(test).connect(conn_spec(test, node))


def disconnect(sess: Session) -> None:
    sess.disconnect()


@contextmanager
def with_session(test: dict, node, sess: Session | None = None):
    """Binds the ambient session/node for the current thread."""
    own = sess is None
    if sess is None:
        sessions = test.get("sessions") or {}
        sess = sessions.get(node)
        own = sess is None
        if sess is None:
            sess = session(test, node)
    t_s = _session.set(sess)
    t_n = _node.set(node)
    try:
        yield sess
    finally:
        _session.reset(t_s)
        _node.reset(t_n)
        if own:
            sess.disconnect()


def current_session() -> Session:
    s = _session.get()
    if s is None:
        raise RuntimeError("no ambient control session; use with_session "
                           "or on_nodes")
    return s


def current_node():
    return _node.get()


@contextmanager
def su(user: str = "root"):
    """Evaluates body with all commands run as user (control.clj su)."""
    tok = _sudo.set(user)
    try:
        yield
    finally:
        _sudo.reset(tok)


@contextmanager
def cd(directory: str):
    cur = _dir.get()
    if cur and not str(directory).startswith("/"):
        # nested relative cd joins, like a shell: cd(a) inside cd(b)
        # means b/a, not a-relative-to-the-login-dir
        directory = f"{cur}/{directory}"
    tok = _dir.set(directory)
    try:
        yield
    finally:
        _dir.reset(tok)


def exec_(*args, stdin: str | None = None, check: bool = True,
          timeout: float = 600.0) -> str:
    """Runs a shell command on the current node, returning trimmed stdout
    (control.clj exec)."""
    cmd = join_cmd(*args)
    action = Action(cmd=cmd, stdin=stdin, sudo=_sudo.get(), dir=_dir.get(),
                    timeout=timeout)
    res = traced_execute(current_session(), action, node=current_node())
    if check:
        throw_on_nonzero_exit(current_node(), res)
    return res.out.strip()


def exec_result(*args, stdin: str | None = None,
                timeout: float = 600.0) -> Result:
    """Like exec_ but returns the full Result without raising."""
    cmd = join_cmd(*args)
    action = Action(cmd=cmd, stdin=stdin, sudo=_sudo.get(), dir=_dir.get(),
                    timeout=timeout)
    return traced_execute(current_session(), action, node=current_node())


def upload(local_paths, remote_path) -> None:
    traced_transfer(current_session(), "upload", local_paths,
                    remote_path, node=current_node())


def download(remote_paths, local_path) -> None:
    traced_transfer(current_session(), "download", remote_paths,
                    local_path, node=current_node())


def on_nodes(test: dict, f: Callable[[dict, Any], Any],
             nodes=None) -> dict:
    """Runs (f test node) in parallel on each node with an ambient session
    bound; returns {node: result} (control.clj on-nodes)."""
    if nodes is None:
        nodes = test.get("nodes") or []
    nodes = list(nodes)
    if not nodes:
        return {}

    from .. import tracing

    # capture the calling thread's trace context so the pooled
    # per-node commands record under the op that issued them
    trace_parent = tracing.get().current()

    def run_one(node):
        ctx = contextvars.copy_context()

        def body():
            with tracing.get().attach(trace_parent):
                with with_session(test, node):
                    return f(test, node)

        return ctx.run(body)

    with ThreadPoolExecutor(max_workers=len(nodes)) as pool:
        results = list(pool.map(run_one, nodes))
    return dict(zip(nodes, results))


def open_sessions(test: dict) -> dict:
    """Opens one session per node in parallel; returns test with
    :sessions {node: session} (core.clj with-sessions, 266-286)."""
    from .. import util as _util

    nodes = list(test.get("nodes") or [])
    sessions = _util.real_pmap(lambda n: session(test, n), nodes)
    test = dict(test)
    test["sessions"] = dict(zip(nodes, sessions))
    return test


def close_sessions(test: dict) -> None:
    for sess in (test.get("sessions") or {}).values():
        try:
            sess.disconnect()
        except Exception:  # noqa: BLE001
            logger.exception("error disconnecting session")
