"""A no-op remote: every control action silently succeeds (the port's
copy of jepsen_tpu/control/dummy.py).

Capability reference: the clj-ssh remote's :dummy? mode
(jepsen/src/jepsen/control/clj_ssh.clj:43-85), which is how the reference
runs its entire lifecycle clusterless in tests.

Tests that need command *output* (e.g. `getent ahostsv4` for IP
resolution, `ip -o link show` for device discovery) pass a `responder`:
a callable `(node, action) -> str | Result | None` consulted before the
default empty success.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from .core import Action, Remote, Result, Session

Responder = Callable[[object, Action], Union[str, Result, None]]


class DummySession(Session):
    def __init__(self, node, responder: Optional[Responder] = None):
        self.node = node
        self.responder = responder
        self.log: list = []  # actions recorded for test assertions

    def execute(self, action: Action) -> Result:
        self.log.append(action)
        if self.responder is not None:
            r = self.responder(self.node, action)
            if isinstance(r, Result):
                return r
            if r is not None:
                return Result(exit=0, out=r, err="", cmd=action.cmd)
        return Result(exit=0, out="", err="", cmd=action.cmd)

    def upload(self, local_paths, remote_path) -> None:
        self.log.append(("upload", local_paths, remote_path))

    def download(self, remote_paths, local_path) -> None:
        self.log.append(("download", remote_paths, local_path))


class DummyRemote(Remote):
    def __init__(self, responder: Optional[Responder] = None):
        self.responder = responder

    def connect(self, conn_spec: dict) -> DummySession:
        return DummySession(conn_spec.get("host"), self.responder)


dummy = DummyRemote()
