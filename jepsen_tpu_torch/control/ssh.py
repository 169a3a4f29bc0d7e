"""SSH remote via the system OpenSSH binaries (the port's copy of
jepsen_tpu/control/ssh.py).

Capability reference: jepsen/src/jepsen/control/sshj.clj (default SSHJ
remote, 111-207). The reference links an SSH library into the JVM; here
we drive the `ssh`/`scp` binaries with a ControlMaster multiplexed
connection per node, which gives the same persistent-session semantics
without bundling a crypto stack.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

from .. import tracing
from .core import (Action, Remote, RemoteError, Result, Session,
                   TransportError, wrap_sudo)


_SSH_FAILURE_MARKERS = (
    "ssh:", "connection closed", "connection refused",
    "connection reset", "connection timed out", "broken pipe",
    "lost connection", "kex_exchange", "permission denied",
    "host key verification", "no route to host", "operation timed out",
    "mux_client", "control socket")


def _looks_like_ssh_failure(stderr: str) -> bool:
    s = (stderr or "").lower()
    return any(m in s for m in _SSH_FAILURE_MARKERS)


class SshSession(Session):
    def __init__(self, spec: dict, concurrency_limit: int = 6):
        self.spec = spec
        self.host = spec["host"]
        self.user = spec.get("username", "root")
        self.port = spec.get("port", 22)
        self.key = spec.get("private_key_path")
        self.strict = spec.get("strict_host_key_checking", False)
        self._sem = threading.Semaphore(concurrency_limit)
        self._ctl_dir = tempfile.mkdtemp(prefix="jt-ssh-")
        self._ctl_path = os.path.join(self._ctl_dir, "ctl")

    def _base_args(self) -> list:
        args = ["-o", "BatchMode=yes",
                "-o", f"ControlPath={self._ctl_path}",
                "-o", "ControlMaster=auto",
                "-o", "ControlPersist=60",
                "-p", str(self.port)]
        if not self.strict:
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if self.key:
            args += ["-i", self.key]
        return args

    def _dest(self) -> str:
        return f"{self.user}@{self.host}"

    def execute(self, action: Action) -> Result:
        cmd = wrap_sudo(action)
        argv = ["ssh", *self._base_args(), self._dest(), cmd]
        try:
            with self._sem:
                proc = subprocess.run(
                    argv, input=action.stdin, capture_output=True,
                    text=True, timeout=action.timeout)
        except subprocess.TimeoutExpired as e:
            # NOT a TransportError: the command started and may still
            # be running remotely — retrying would double-execute it
            tracing.event("ssh-timeout", node=self.host,
                          timeout_s=action.timeout)
            raise RemoteError("ssh command timed out", cmd=cmd,
                              node=self.host) from e
        except OSError as e:  # spawn failure (e.g. no ssh binary)
            raise TransportError(f"ssh spawn failed: {e}", cmd=cmd,
                                 node=self.host) from e
        if proc.returncode == 255 and _looks_like_ssh_failure(
                proc.stderr):
            # 255 with a client-side error message is ssh's own failure
            # (connect/auth/channel): retryable. A remote command that
            # itself exits 255 without such a message passes through as
            # a Result, preserving exec_result's no-raise contract.
            tracing.event("ssh-transport-failed", node=self.host,
                          stderr=(proc.stderr or "")[:160])
            raise TransportError("ssh transport failed", exit=255,
                                 out=proc.stdout, err=proc.stderr,
                                 cmd=cmd, node=self.host)
        return Result(exit=proc.returncode, out=proc.stdout,
                      err=proc.stderr, cmd=cmd)

    def upload(self, local_paths, remote_path) -> None:
        if isinstance(local_paths, (str, os.PathLike)):
            local_paths = [local_paths]
        argv = self._scp_args(local_paths, f"{self._dest()}:{remote_path}")
        self._run_scp(argv)

    def download(self, remote_paths, local_path) -> None:
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        srcs = [f"{self._dest()}:{p}" for p in remote_paths]
        argv = self._scp_args(srcs, str(local_path))
        self._run_scp(argv)

    def _scp_args(self, srcs, dst) -> list:
        args = ["scp", "-P", str(self.port),
                "-o", "BatchMode=yes",
                "-o", f"ControlPath={self._ctl_path}",
                "-o", "ControlMaster=auto",
                "-o", "ControlPersist=60"]
        if not self.strict:
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if self.key:
            args += ["-i", self.key]
        return args + [*map(str, srcs), dst]

    def _run_scp(self, argv, timeout: float = 600.0) -> None:
        try:
            with self._sem:
                proc = subprocess.run(argv, capture_output=True,
                                      text=True, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            raise RemoteError("scp timed out", cmd=" ".join(argv),
                              node=self.host) from e
        except OSError as e:
            raise TransportError(f"scp spawn failed: {e}",
                                 cmd=" ".join(argv),
                                 node=self.host) from e
        # Only exit 255 is the ssh client's own failure; marker
        # matching on other exits would misread remote-file errors
        # ("scp: /x: Permission denied", exit 1) as transport trouble
        # and pointlessly retry-cycle the shared ControlMaster.
        if proc.returncode == 255:
            raise TransportError("scp transport failed",
                                 exit=proc.returncode, out=proc.stdout,
                                 err=proc.stderr, cmd=" ".join(argv),
                                 node=self.host)
        if proc.returncode != 0:
            raise RemoteError("scp failed", exit=proc.returncode,
                              out=proc.stdout, err=proc.stderr,
                              cmd=" ".join(argv), node=self.host)

    def disconnect(self) -> None:
        try:
            subprocess.run(["ssh", "-o", f"ControlPath={self._ctl_path}",
                            "-O", "exit", self._dest()],
                           capture_output=True, timeout=10)
        except Exception:  # noqa: BLE001
            pass
        shutil.rmtree(self._ctl_dir, ignore_errors=True)


class SshRemote(Remote):
    def __init__(self, concurrency_limit: int = 6):
        self.concurrency_limit = concurrency_limit

    def connect(self, conn_spec: dict) -> SshSession:
        return SshSession(conn_spec, self.concurrency_limit)
