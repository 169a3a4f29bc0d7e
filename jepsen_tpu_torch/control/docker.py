"""Remote that runs node commands via `docker exec` / `docker cp` (the
port's copy of jepsen_tpu/control/docker.py).

Capability reference: jepsen/src/jepsen/control/docker.clj — resolve a
container from the conn-spec host (docker.clj:14-28: a host:port maps
to the container publishing that port, a bare name is used directly),
execute with `docker exec ... sh -c cmd` (30-38), transfer files with
`docker cp` (57-75), the Remote record (77-88).

Local subprocess invocation is injectable (`runner`) so suites can run
clusterless against a scripted docker CLI.
"""

from __future__ import annotations

import re
import subprocess
from typing import Callable

from .core import (Action, Remote, RemoteError, Result, Session,
                   wrap_sudo)


def _default_runner(argv, stdin=None, timeout=600.0) -> Result:
    from .core import TransportError

    try:
        proc = subprocess.run(argv, input=stdin, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        # same contract as the ssh remote: a timed-out command may
        # still be running — RemoteError, never silently retried
        raise RemoteError(f"{argv[0]} command timed out",
                          cmd=" ".join(argv)) from e
    except OSError as e:  # spawn failure (e.g. no docker/kubectl)
        raise TransportError(f"{argv[0]} spawn failed: {e}",
                             cmd=" ".join(argv)) from e
    return Result(exit=proc.returncode, out=proc.stdout,
                  err=proc.stderr, cmd=" ".join(argv))


def resolve_container_id(host, runner: Callable = _default_runner) -> str:
    """Container id/name for a conn-spec host: 'host:port' finds the
    container publishing that port (docker.clj:14-28); anything else is
    taken as a container name/id directly."""
    host = str(host)
    if ":" in host:
        _addr, port = host.rsplit(":", 1)
        ps = runner(["docker", "ps"]).out
        for line in ps.splitlines()[1:]:
            # PUBLISHED port only (":PORT->"); matching the container-
            # internal side ("->PORT/") would resolve every node to
            # the first container sharing a service port
            if re.search(rf":{re.escape(port)}->", line):
                return line.split()[0]
        raise RemoteError(f"no container publishes port {port}",
                          node=host, cmd="docker ps")
    return host


class DockerSession(Session):
    def __init__(self, container_id: str, runner: Callable):
        self.container_id = container_id
        self.runner = runner

    def execute(self, action: Action) -> Result:
        cmd = wrap_sudo(action)
        argv = ["docker", "exec"]
        if action.stdin is not None:
            argv.append("-i")
        argv += [self.container_id, "sh", "-c", cmd]
        res = self.runner(argv, stdin=action.stdin,
                          timeout=action.timeout)
        return Result(exit=res.exit, out=res.out, err=res.err, cmd=cmd)

    def _cp(self, src: str, dst: str) -> None:
        res = self.runner(["docker", "cp", src, dst])
        if res.exit != 0:
            raise RemoteError("docker cp failed", exit=res.exit,
                              out=res.out, err=res.err, cmd=res.cmd,
                              node=self.container_id)

    def upload(self, local_paths, remote_path) -> None:
        if isinstance(local_paths, str):
            local_paths = [local_paths]
        for p in local_paths:
            self._cp(str(p), f"{self.container_id}:{remote_path}")

    def download(self, remote_paths, local_path) -> None:
        if isinstance(remote_paths, str):
            remote_paths = [remote_paths]
        for p in remote_paths:
            self._cp(f"{self.container_id}:{p}", str(local_path))


class DockerRemote(Remote):
    """docker-exec transport (docker.clj:90-92)."""

    def __init__(self, runner: Callable = _default_runner):
        self.runner = runner

    def connect(self, conn_spec: dict) -> DockerSession:
        cid = resolve_container_id(conn_spec["host"], self.runner)
        return DockerSession(cid, self.runner)
