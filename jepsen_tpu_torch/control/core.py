"""Remote-execution protocol and shell command construction (the
port's copy of jepsen_tpu/control/core.py).

Capability reference: jepsen/src/jepsen/control/core.clj (Remote protocol
7-62, shell escaping/env 64-144, sudo wrapping 146-175).
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass
from typing import Any, Optional


class RemoteError(Exception):
    """Command failed on a remote node."""

    def __init__(self, message, exit=None, out=None, err=None, cmd=None,
                 node=None):
        self.exit = exit
        self.out = out
        self.err = err
        self.cmd = cmd
        self.node = node
        super().__init__(
            f"{message} (node={node}, cmd={cmd!r}, exit={exit}, "
            f"out={out!r}, err={err!r})")


class TransportError(RemoteError):
    """The transport itself failed (connection refused/dropped, ssh
    exit 255, timeout) — the command may never have run. Safe to retry
    at the remote layer (the reference's ::ssh-failed class,
    control/retry.clj:1-14); a command's own non-zero exit is NOT a
    TransportError."""


@dataclass
class Action:
    """A command to run remotely: argv string, optional stdin, sudo user,
    working dir, and a wall-clock timeout in seconds."""

    cmd: str
    stdin: Optional[str] = None
    sudo: Optional[str] = None
    sudo_password: Optional[str] = None
    dir: Optional[str] = None
    timeout: float = 600.0


@dataclass
class Result:
    exit: int
    out: str
    err: str
    cmd: str


class Remote:
    """Transport for running commands and moving files on nodes
    (control/core.clj:7-62)."""

    def connect(self, conn_spec: dict) -> "Session":
        raise NotImplementedError


class Session:
    def disconnect(self) -> None:
        pass

    def execute(self, action: Action) -> Result:
        raise NotImplementedError

    def upload(self, local_paths, remote_path) -> None:
        raise NotImplementedError

    def download(self, remote_paths, local_path) -> None:
        raise NotImplementedError


class Lit(str):
    """A literal shell fragment that escape() passes through untouched —
    for pipes, redirects, and globs (the reference passes these as bare
    Clojure symbols, which its escaping also leaves alone)."""


def escape(arg: Any) -> str:
    """Shell-escapes a single argument. Keywords/numbers pass through as
    their string form (control/core.clj:64-101)."""
    if isinstance(arg, Lit):
        return str(arg)
    s = str(arg)
    if s and all(c.isalnum() or c in "-_.,/=:+@%^" for c in s):
        return s
    return shlex.quote(s)


def join_cmd(*args) -> str:
    """Builds a shell command string from args, escaping each. Lists are
    flattened; None skipped."""
    parts = []
    for a in args:
        if a is None:
            continue
        if isinstance(a, (list, tuple)):
            parts.extend(escape(x) for x in a)
        else:
            parts.append(escape(a))
    return " ".join(parts)


def env_string(env: dict | None) -> str:
    """FOO=bar A=b prefix string (control/core.clj env, 103-126)."""
    if not env:
        return ""
    return " ".join(f"{k}={escape(v)}" for k, v in env.items()) + " "


def wrap_sudo(action: Action) -> str:
    """Wraps an action's command in sudo -S -u USER sh -c '...'
    (control/core.clj:146-175)."""
    if not action.sudo:
        cmd = action.cmd
    else:
        cmd = (f"sudo -S -u {escape(action.sudo)} bash -c "
               f"{shlex.quote(action.cmd)}")
    if action.dir:
        cmd = f"cd {escape(action.dir)} && {cmd}"
    return cmd


def throw_on_nonzero_exit(node, res: Result) -> Result:
    if res.exit != 0:
        raise RemoteError("command returned non-zero exit status",
                          exit=res.exit, out=res.out, err=res.err,
                          cmd=res.cmd, node=node)
    return res


# Attribute budget for traced commands: enough to identify the command
# in a trace viewer without shipping multi-KB stdin/scripts along.
_TRACE_CMD_CHARS = 200


def traced_execute(session: "Session", action: Action,
                   node=None) -> Result:
    """Runs `action` through `session.execute` inside a 'remote' trace
    span carrying cmd, node, duration, and exit code — one child span
    per remote command under the op that issued it (the tracing layer
    no-ops unless the run opted in and an op context is open on this
    thread). Transport/remote errors close the span with the error
    class; the retry layer stamps its attempt count on the same span
    via tracing.annotate."""
    from .. import tracing

    tr = tracing.get()
    if not tr.enabled:
        return session.execute(action)
    cmd = action.cmd or ""
    name = cmd.split(None, 1)[0] if cmd.split() else "(empty)"
    with tr.span("remote", f"remote.{name}",
                 cmd=cmd[:_TRACE_CMD_CHARS],
                 node=str(node) if node is not None else None,
                 sudo=action.sudo) as rec:
        try:
            res = session.execute(action)
        except RemoteError as e:
            if rec is not None:
                rec.setdefault("attrs", {}).update(
                    error=type(e).__name__, exit=e.exit)
            raise
        if rec is not None:
            rec.setdefault("attrs", {})["exit"] = res.exit
        return res


def traced_transfer(session: "Session", direction: str, paths,
                    dest, node=None):
    """upload/download under a 'remote' trace span (scp commands are
    remote work too — a snarf or data-file push shows up in the op
    trace like any command)."""
    from .. import tracing

    tr = tracing.get()
    fn = getattr(session, direction)
    if not tr.enabled:
        return fn(paths, dest)
    with tr.span("remote", f"remote.scp.{direction}",
                 node=str(node) if node is not None else None) as rec:
        try:
            return fn(paths, dest)
        except RemoteError as e:
            if rec is not None:
                rec.setdefault("attrs", {}).update(
                    error=type(e).__name__, exit=e.exit)
            raise
