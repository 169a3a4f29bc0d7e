"""Sudo-aware file-transfer wrapper around any Remote (the port's copy
of jepsen_tpu/control/scp.py).

Capability reference: jepsen/src/jepsen/control/scp.clj:82-146. The
reference wraps a command-capable remote so uploads/downloads work even
when the ambient `su` user differs from the connection user: uploads go
to a world-writable tmpfile, then chown + mv as root; downloads of
files the connection user can't read are hardlinked (or copied) to a
tmpfile, chowned readable, then fetched. Our SSH session already shells
out to scp for the fast path (ssh.py), so this wrapper adds only the
privilege dance, reading the ambient sudo user from control.su().
"""

from __future__ import annotations

import os
import random
from contextlib import contextmanager

from .core import (Action, Remote, RemoteError, Session, join_cmd,
                   throw_on_nonzero_exit)

TMP_DIR = "/tmp/jepsen/scp"


def _coll(paths):
    if isinstance(paths, (str, os.PathLike)):
        return [paths]
    return list(paths)


def _safe_basename(path) -> str:
    """Basename for the remote tmp path. Legacy scp passes the remote
    path through a shell, so anything beyond clearly-safe characters
    falls back to a neutral name (the destination keeps the real name —
    mv takes it from remote_path or the directory form)."""
    name = os.path.basename(str(path))
    if name and all(c.isalnum() or c in "-_.,+@%" for c in name):
        return name
    return "file"


def _ambient_sudo():
    from . import _sudo
    return _sudo.get()


class ScpSession(Session):
    """Delegates commands to the base session; transfers grow a
    become-another-user path (scp.clj upload!/download!, 98-146)."""

    def __init__(self, base: Session, conn_spec: dict):
        self.base = base
        self.user = conn_spec.get("username", "root")
        self.node = conn_spec.get("host")
        self._tmp_dir_ready = False

    def execute(self, action: Action):
        return self.base.execute(action)

    def disconnect(self) -> None:
        self.base.disconnect()

    def _exec(self, *args, sudo="root", check=True):
        res = self.base.execute(Action(cmd=join_cmd(*args), sudo=sudo))
        if check:
            throw_on_nonzero_exit(self.node, res)
        return res

    def _ensure_tmp_dir(self) -> None:
        # One round-trip per session, not per transfer (the reference
        # instead retries the whole body after mkdir on first failure,
        # scp.clj:28-40 — same effect, different bookkeeping)
        if not self._tmp_dir_ready:
            self._exec("install", "-d", "-m", "0777", TMP_DIR)
            self._tmp_dir_ready = True

    @contextmanager
    def _tmp_file(self, basename: str):
        # The tmpfile keeps the source's basename inside a fresh random
        # subdir, so multi-file transfers into a directory destination
        # land under their real names instead of the tmp name
        self._ensure_tmp_dir()
        sub = f"{TMP_DIR}/{random.randrange(2**31)}"
        # World-writable in one round-trip: the dir is created as root
        # but the scp itself runs as the connection user
        self._exec("install", "-d", "-m", "0777", sub)
        try:
            yield f"{sub}/{basename}"
        finally:
            try:
                self._exec("rm", "-rf", sub, check=False)
            except RemoteError:
                # Cleanup is best-effort: a transport drop here must
                # not mask the body's real error (or turn a
                # deterministic failure into a retryable one)
                pass

    def upload(self, local_paths, remote_path) -> None:
        sudo = _ambient_sudo()
        if sudo is None or sudo == self.user:
            return self.base.upload(local_paths, remote_path)
        # Upload as the connection user, then chown + move into place
        # as root (scp.clj:98-111). With several sources the
        # destination is a directory; mv each under its real basename
        # (the exec path escapes properly, unlike scp's remote path).
        srcs = _coll(local_paths)
        for src in srcs:
            name = os.path.basename(str(src))
            with self._tmp_file(_safe_basename(src)) as tmp:
                self.base.upload(src, tmp)
                self._exec("chown", sudo, tmp)
                # A directory destination must receive the REAL
                # basename even when the tmp name was sanitized; the
                # exec path escapes arbitrary names safely. With one
                # source we can't assume dest is a dir — probe only in
                # the rare sanitized case.
                if len(srcs) > 1:
                    dest = f"{remote_path}/{name}"
                elif (name != _safe_basename(src)
                      and self._is_dir(remote_path)):
                    dest = f"{remote_path}/{name}"
                else:
                    dest = remote_path
                self._exec("mv", tmp, dest)

    def download(self, remote_paths, local_path) -> None:
        sudo = _ambient_sudo()
        if sudo is None or sudo == self.user:
            return self.base.download(remote_paths, local_path)
        for src in _coll(remote_paths):
            if self._readable(src):
                self.base.download(src, local_path)
                continue
            # Copy the file somewhere we can chown it readable, then
            # fetch that (scp.clj:113-146). The reference hardlinks
            # first (ln -L) for speed, but chowning a hardlink chowns
            # the shared inode — permanently mutating the source file
            # on the system under test — so we always pay the copy.
            name = os.path.basename(str(src))
            with self._tmp_file(_safe_basename(src)) as tmp:
                self._exec("cp", src, tmp)
                self._exec("chown", self.user, tmp)
                self.base.download(tmp, local_path)
                # Into a local directory, a sanitized tmp name lands
                # as "file": restore the real basename (local rename —
                # no escaping concerns)
                if (name != _safe_basename(src)
                        and os.path.isdir(local_path)):
                    got = os.path.join(str(local_path),
                                       _safe_basename(src))
                    if os.path.exists(got):
                        os.replace(got, os.path.join(str(local_path),
                                                     name))

    def _is_dir(self, path) -> bool:
        res = self.base.execute(
            Action(cmd=join_cmd("test", "-d", path), sudo="root"))
        return res.exit == 0

    def _readable(self, path) -> bool:
        # Ordinary "can't read" comes back as a nonzero-exit Result;
        # exceptions here are transport failures and must propagate to
        # the retry layer, not masquerade as an unreadable file
        res = self.base.execute(
            Action(cmd=join_cmd("head", "-c", 1, path)))
        return res.exit == 0


class ScpRemote(Remote):
    """Wraps a Remote so transfers honor the ambient su() user
    (scp.clj remote, 148-152)."""

    def __init__(self, remote: Remote):
        self.remote = remote

    def connect(self, conn_spec: dict) -> ScpSession:
        return ScpSession(self.remote.connect(conn_spec), conn_spec)
