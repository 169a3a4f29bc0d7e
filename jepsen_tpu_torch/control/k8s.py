"""Remote that runs node commands via `kubectl exec` / `kubectl cp`
(the port's copy of jepsen_tpu/control/k8s.py).

Capability reference: jepsen/src/jepsen/control/k8s.clj — exec into the
pod named by the conn-spec host (k8s.clj:79-92), `kubectl cp` transfers
(30-75), optional --context/--namespace parameters (76-78), and
list_pods (99-111).
"""

from __future__ import annotations

from typing import Callable

from .core import Action, Remote, RemoteError, Result, Session, wrap_sudo
from .docker import _default_runner


class K8sSession(Session):
    def __init__(self, pod: str, flags: list, runner: Callable):
        self.pod = pod
        self.flags = flags
        self.runner = runner

    def execute(self, action: Action) -> Result:
        cmd = wrap_sudo(action)
        argv = ["kubectl", "exec", *self.flags]
        if action.stdin is not None:
            argv.append("-i")
        argv += [self.pod, "--", "sh", "-c", cmd]
        res = self.runner(argv, stdin=action.stdin,
                          timeout=action.timeout)
        return Result(exit=res.exit, out=res.out, err=res.err, cmd=cmd)

    def _cp(self, src: str, dst: str) -> None:
        res = self.runner(["kubectl", "cp", *self.flags, src, dst])
        if res.exit != 0:
            raise RemoteError("kubectl cp failed", exit=res.exit,
                              out=res.out, err=res.err, cmd=res.cmd,
                              node=self.pod)

    def upload(self, local_paths, remote_path) -> None:
        if isinstance(local_paths, str):
            local_paths = [local_paths]
        for p in local_paths:
            self._cp(str(p), f"{self.pod}:{remote_path}")

    def download(self, remote_paths, local_path) -> None:
        if isinstance(remote_paths, str):
            remote_paths = [remote_paths]
        for p in remote_paths:
            self._cp(f"{self.pod}:{p}", str(local_path))


class K8sRemote(Remote):
    """kubectl-exec transport (k8s.clj:79-97)."""

    def __init__(self, context: str | None = None,
                 namespace: str | None = None,
                 runner: Callable = _default_runner):
        self.context = context
        self.namespace = namespace
        self.runner = runner

    def _flags(self) -> list:
        flags = []
        if self.context:
            flags.append(f"--context={self.context}")
        if self.namespace:
            flags.append(f"--namespace={self.namespace}")
        return flags

    def connect(self, conn_spec: dict) -> K8sSession:
        return K8sSession(str(conn_spec["host"]), self._flags(),
                          self.runner)


def list_pods(context: str | None = None, namespace: str | None = None,
              runner: Callable = _default_runner) -> list[str]:
    """Pod names in a context/namespace (k8s.clj:99-111)."""
    flags = K8sRemote(context, namespace)._flags()
    res = runner(["kubectl", "get", "pods", *flags,
                  "-o", "jsonpath={.items[*].metadata.name}"])
    if res.exit != 0:
        raise RemoteError("kubectl get pods failed", exit=res.exit,
                          out=res.out, err=res.err, cmd=res.cmd)
    return [p for p in res.out.split() if p]
