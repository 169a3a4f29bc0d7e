"""The port's transports against the JAX package's: control/ssh.py,
scp.py, docker.py, k8s.py, the default stack of control/__init__.py, and
the retry and reconnect layers under them.

- Every test of tests/test_remotes.py has a counterpart here, run on
  each package (`[port]` and `[jax]`) with the same assertions. The JAX
  test that drives the etcd suite's DB over the docker remote drives
  LazyFSDB and the tcpdump DB instead (the suites are not ported).
- There is no sshd: the SSH session runs fake `ssh` and `scp`
  executables written into the test's directory and put first on PATH.
  They record their argv and answer what the test sets (exit code,
  stdout, stderr). Both packages must hand them the same argv, and read
  exit 255 the same way: a transport failure only with one of ssh's own
  messages.
- The docker and k8s runners are scripted: the argv each package
  records for the same actions must be equal.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import threading
from pathlib import Path

import pytest

ROOTS = {"port": "jepsen_tpu_torch", "jax": "jepsen_tpu"}


class Pkg:
    """One package's modules by their shared names."""

    def __init__(self, root: str):
        self.root = root

    def m(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    @property
    def core(self):
        return self.m("control.core")

    @property
    def control(self):
        return self.m("control")


@pytest.fixture(params=list(ROOTS))
def pkg(request):
    return Pkg(ROOTS[request.param])


def both(scenario, *args):
    """The scenario's result on each package: (jax, port)."""
    return (scenario(Pkg("jepsen_tpu"), *args),
            scenario(Pkg("jepsen_tpu_torch"), *args))


# The fake reads its stdin only while data comes within 0.2 s: a command
# given no input inherits the test process's stdin, which may be a pipe
# that never closes.
FAKE = """#!{python}
import json, os, select, sys
stdin = None
if not os.isatty(0):
    chunks = []
    while select.select([0], [], [], 0.2)[0]:
        b = os.read(0, 65536)
        if not b:
            stdin = b"".join(chunks).decode()
            break
        chunks.append(b)
with open(os.environ["FAKE_SSH_LOG"], "a") as f:
    f.write(json.dumps(
        [os.path.basename(sys.argv[0])] + sys.argv[1:] + [stdin]) + "\\n")
sys.stdout.write(os.environ.get("FAKE_SSH_OUT", ""))
sys.stderr.write(os.environ.get("FAKE_SSH_ERR", ""))
if os.environ.get("FAKE_SSH_SLEEP"):
    import time
    time.sleep(float(os.environ["FAKE_SSH_SLEEP"]))
sys.exit(int(os.environ.get("FAKE_SSH_EXIT", "0")))
"""


def fake_ssh(tmp_path, monkeypatch, exit=0, out="", err="",
             tools=("ssh", "scp")):
    """Writes fake `ssh` and `scp` (or the named tools) into tmp_path,
    puts them first on PATH and returns a reader of the argv they were
    called with ([tool, *args, stdin])."""
    bindir = tmp_path / "fakebin"
    bindir.mkdir(exist_ok=True)
    for tool in tools:
        f = bindir / tool
        f.write_text(FAKE.format(python=sys.executable))
        f.chmod(0o755)
    log = tmp_path / "fake-argv.jsonl"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_SSH_LOG", str(log))
    monkeypatch.setenv("FAKE_SSH_EXIT", str(exit))
    monkeypatch.setenv("FAKE_SSH_OUT", out)
    monkeypatch.setenv("FAKE_SSH_ERR", err)

    def calls() -> list:
        if not log.exists():
            return []
        return [json.loads(x) for x in log.read_text().splitlines()]

    return calls


def ctl_free(argv: list) -> list:
    """argv with the session's control socket path (a fresh temporary
    directory each session) replaced by a marker."""
    return ["ControlPath=<ctl>" if str(a).startswith("ControlPath=")
            else a for a in argv]


class ScriptedRunner:
    """Records argv calls; replies via a function."""

    def __init__(self, pkg, reply=None):
        self.calls: list = []
        self.reply = reply or (
            lambda argv, stdin: pkg.core.Result(0, "", "", ""))

    def __call__(self, argv, stdin=None, timeout=600.0):
        self.calls.append((list(argv), stdin))
        return self.reply(argv, stdin)


DOCKER_PS = """CONTAINER ID   IMAGE   COMMAND   CREATED   STATUS   PORTS                     NAMES
a1b2c3d4e5f6   etcd    "/etcd"   2d ago    Up 2d    0.0.0.0:30404->2379/tcp   jepsen-n1
ffffffffffff   etcd    "/etcd"   2d ago    Up 2d    0.0.0.0:30405->2379/tcp   jepsen-n2
"""


# ---------------------------------------------------------------------------
# tests/test_remotes.py TestDocker, TestK8s, TestDockerRegressions
# ---------------------------------------------------------------------------

class TestDocker:
    def test_resolve_by_port(self, pkg):
        docker = pkg.m("control.docker")
        r = ScriptedRunner(pkg, lambda argv, stdin: pkg.core.Result(
            0, DOCKER_PS, "", ""))
        assert docker.resolve_container_id("localhost:30404", r) == \
            "a1b2c3d4e5f6"
        assert docker.resolve_container_id("localhost:30405", r) == \
            "ffffffffffff"

    def test_resolve_unknown_port_raises(self, pkg):
        docker = pkg.m("control.docker")
        r = ScriptedRunner(pkg, lambda argv, stdin: pkg.core.Result(
            0, DOCKER_PS, "", ""))
        with pytest.raises(pkg.core.RemoteError):
            docker.resolve_container_id("localhost:9999", r)

    def test_bare_name_passes_through(self, pkg):
        docker = pkg.m("control.docker")
        assert docker.resolve_container_id("jepsen-n1") == "jepsen-n1"

    def test_exec_and_cp(self, pkg):
        Action = pkg.core.Action
        r = ScriptedRunner(pkg, lambda argv, stdin: pkg.core.Result(
            0, "out", "", ""))
        sess = pkg.m("control.docker").DockerRemote(r).connect(
            {"host": "n1"})
        res = sess.execute(Action(cmd="echo hi"))
        assert res.exit == 0 and res.out == "out"
        assert r.calls[-1][0] == ["docker", "exec", "n1", "sh", "-c",
                                  "echo hi"]
        sess.execute(Action(cmd="cat", stdin="data"))
        assert r.calls[-1][0][:3] == ["docker", "exec", "-i"]
        assert r.calls[-1][1] == "data"
        sess.upload("/tmp/f", "/opt/f")
        assert r.calls[-1][0] == ["docker", "cp", "/tmp/f", "n1:/opt/f"]
        sess.download("/var/log/x", "/tmp/out")
        assert r.calls[-1][0] == ["docker", "cp", "n1:/var/log/x",
                                  "/tmp/out"]

    def test_sudo_wrapping(self, pkg):
        r = ScriptedRunner(pkg)
        sess = pkg.m("control.docker").DockerRemote(r).connect(
            {"host": "n1"})
        sess.execute(pkg.core.Action(cmd="whoami", sudo="root"))
        assert "sudo -S -u root" in r.calls[-1][0][-1]

    def test_cp_failure_raises(self, pkg):
        r = ScriptedRunner(pkg, lambda argv, stdin: pkg.core.Result(
            1, "", "no", ""))
        sess = pkg.m("control.docker").DockerRemote(r).connect(
            {"host": "n1"})
        with pytest.raises(pkg.core.RemoteError):
            sess.upload("/tmp/f", "/opt/f")


class TestK8s:
    def test_exec_flags(self, pkg):
        r = ScriptedRunner(pkg)
        sess = pkg.m("control.k8s").K8sRemote(
            context="kind", namespace="jepsen", runner=r).connect(
                {"host": "pod-1"})
        sess.execute(pkg.core.Action(cmd="uptime"))
        assert r.calls[-1][0] == [
            "kubectl", "exec", "--context=kind", "--namespace=jepsen",
            "pod-1", "--", "sh", "-c", "uptime"]
        sess.upload("/tmp/f", "/opt/f")
        assert r.calls[-1][0][:2] == ["kubectl", "cp"]
        assert r.calls[-1][0][-1] == "pod-1:/opt/f"

    def test_list_pods(self, pkg):
        r = ScriptedRunner(pkg, lambda argv, stdin: pkg.core.Result(
            0, "p1 p2 p3", "", ""))
        assert pkg.m("control.k8s").list_pods(runner=r) == \
            ["p1", "p2", "p3"]


class TestDockerRegressions:
    def test_internal_port_not_matched(self, pkg):
        """localhost:2379 (the container-INTERNAL port) must not
        resolve to the first container."""
        r = ScriptedRunner(pkg, lambda argv, stdin: pkg.core.Result(
            0, DOCKER_PS, "", ""))
        with pytest.raises(pkg.core.RemoteError):
            pkg.m("control.docker").resolve_container_id(
                "localhost:2379", r)


# ---------------------------------------------------------------------------
# tests/test_remotes.py TestRetry, TestReconnectWrapper,
# TestRetryRegressions
# ---------------------------------------------------------------------------

def flaky(pkg):
    """FlakySession and FlakyRemote of tests/test_remotes.py over a
    package's TransportError and Result."""
    core = pkg.core

    class FlakySession:
        """Fails with TransportError n times, then succeeds."""

        def __init__(self, failures):
            self.failures = failures
            self.executed: list = []
            self.disconnected = 0

        def execute(self, action):
            if self.failures > 0:
                self.failures -= 1
                raise core.TransportError("flaky", node="n1",
                                          cmd=action.cmd)
            self.executed.append(action.cmd)
            return core.Result(0, "ok", "", action.cmd)

        def disconnect(self):
            self.disconnected += 1

    class FlakyRemote:
        def __init__(self, failures):
            self.failures = failures
            self.sessions: list = []

        def connect(self, conn_spec):
            s = FlakySession(self.failures)
            self.failures = 0  # later sessions are healthy
            self.sessions.append(s)
            return s

    return FlakySession, FlakyRemote


class TestRetry:
    def test_transport_failures_retried(self, pkg, monkeypatch):
        retry_mod = pkg.m("control.retry")
        monkeypatch.setattr(retry_mod, "BACKOFF_S", 0.001)
        _s, FlakyRemote = flaky(pkg)
        remote = FlakyRemote(failures=3)
        sess = retry_mod.RetryingRemote(remote).connect({"host": "n1"})
        res = sess.execute(pkg.core.Action(cmd="echo hi"))
        assert res.out == "ok"
        # each failure cycles the connection
        assert len(remote.sessions) >= 2

    def test_gives_up_after_retries(self, pkg, monkeypatch):
        retry_mod = pkg.m("control.retry")
        monkeypatch.setattr(retry_mod, "BACKOFF_S", 0.001)
        FlakySession, _r = flaky(pkg)

        class AlwaysDown:
            def connect(self, conn_spec):
                return FlakySession(10**9)

        sess = retry_mod.RetryingRemote(AlwaysDown()).connect(
            {"host": "n1"})
        with pytest.raises(pkg.core.TransportError):
            sess.execute(pkg.core.Action(cmd="echo hi"))

    def test_nonzero_exit_not_retried(self, pkg):
        retry_mod = pkg.m("control.retry")
        FlakySession, _r = flaky(pkg)

        class FailingSession(FlakySession):
            def execute(self, action):
                self.executed.append(action.cmd)
                return pkg.core.Result(7, "", "boom", action.cmd)

        class R:
            def connect(self, conn_spec):
                return FailingSession(0)

        sess = retry_mod.RetryingRemote(R()).connect({"host": "n1"})
        res = sess.execute(pkg.core.Action(cmd="false"))
        assert res.exit == 7  # command's own failure passes through once


class TestReconnectWrapper:
    def test_open_close_reopen(self, pkg):
        opened: list = []
        closed: list = []
        w = pkg.m("reconnect").Wrapper(
            open=lambda: opened.append(1) or len(opened),
            close=lambda c: closed.append(c))
        w.open()
        w.open()  # idempotent
        assert w.conn() == 1 and len(opened) == 1
        w.reopen()
        assert closed == [1] and w.conn() == 2
        w.close()
        assert w.conn() is None and closed == [1, 2]

    def test_with_conn_cycles_on_error(self, pkg):
        opened: list = []
        w = pkg.m("reconnect").Wrapper(
            open=lambda: opened.append(1) or len(opened),
            close=lambda c: None)
        with pytest.raises(ValueError):
            with w.with_conn():
                raise ValueError("boom")
        assert w.conn() == 2  # replaced after the failure

    def test_open_returning_none_raises(self, pkg):
        w = pkg.m("reconnect").Wrapper(open=lambda: None,
                                       close=lambda c: None)
        with pytest.raises(RuntimeError):
            w.open()


class TestRetryRegressions:
    def test_non_transport_error_keeps_session(self, pkg, monkeypatch):
        """A command's own failure (e.g. scp of a missing file) must not
        cycle the shared session."""
        retry_mod = pkg.m("control.retry")
        monkeypatch.setattr(retry_mod, "BACKOFF_S", 0.001)
        FlakySession, _r = flaky(pkg)

        class Sess(FlakySession):
            def upload(self, local_paths, remote_path):
                raise pkg.core.RemoteError("no such file", exit=1)

        class R:
            def __init__(self):
                self.connects = 0

            def connect(self, conn_spec):
                self.connects += 1
                return Sess(0)

        r = R()
        sess = retry_mod.RetryingRemote(r).connect({"host": "n1"})
        with pytest.raises(pkg.core.RemoteError):
            sess.upload("/nope", "/tmp/x")
        assert r.connects == 1  # session survived

    def test_ssh_255_heuristic(self, pkg):
        looks = pkg.m("control.ssh")._looks_like_ssh_failure
        assert looks("ssh: connect to host n1 port 22: Connection refused")
        assert looks("kex_exchange_identification: "
                     "Connection closed by remote host")
        assert not looks("myapp: fatal error 42")
        assert not looks("")


# ---------------------------------------------------------------------------
# tests/test_remotes.py TestEtcdOverDocker: a DB driven over the docker
# remote (LazyFSDB and the tcpdump DB; the suites are not ported)
# ---------------------------------------------------------------------------

def docker_db_setup(pkg):
    """LazyFSDB's and the tcpdump DB's setup over a faked docker CLI;
    returns the runner's argv."""
    core = pkg.core

    def reply(argv, stdin):
        return core.Result(0, "", "", "")

    r = ScriptedRunner(pkg, reply)
    remote = pkg.m("control.docker").DockerRemote(r)
    test = {"nodes": ["n1"], "remote": remote, "ssh": {},
            "sessions": {"n1": remote.connect({"host": "n1"})}}
    db = pkg.m("lazyfs").LazyFSDB("/var/lib/db/data")
    td = pkg.m("dbs.tcpdump").tcpdump(ports=[2379])
    with pkg.control.with_session(test, "n1"):
        db.setup(test, "n1")
        td.setup(test, "n1")
    return [c for c, _stdin in r.calls]


class TestDbOverDocker:
    def test_db_setup_via_docker_remote(self, pkg):
        calls = docker_db_setup(pkg)
        joined = [c[-1] for c in calls if c[:2] == ["docker", "exec"]
                  or c[:3] == ["docker", "exec", "-i"]]
        assert any("start-stop-daemon" in c for c in joined)
        assert any("--config-path /var/lib/db/data.lazyfs/lazyfs.conf"
                   in c for c in joined)
        assert any("tcpdump -w /tmp/jepsen/tcpdump/tcpdump" in c
                   for c in joined)

    def test_runner_argv_equal_across_packages(self):
        j, p = both(docker_db_setup)
        assert p == j and len(p) > 10


# ---------------------------------------------------------------------------
# tests/test_remotes.py TestScp
# ---------------------------------------------------------------------------

def scp_session(pkg, responder=None):
    remote = pkg.m("control.scp").ScpRemote(
        pkg.m("control.dummy").DummyRemote(responder))
    sess = remote.connect({"host": "n1", "username": "admin"})
    return sess, sess.base


def actions(pkg, base):
    return [a for a in base.log if isinstance(a, pkg.core.Action)]


class TestScp:
    """Sudo-aware transfer wrapper (control/scp.clj:82-146)."""

    def test_plain_upload_delegates(self, pkg):
        sess, base = scp_session(pkg)
        sess.upload("/local/f", "/remote/f")
        assert base.log == [("upload", "/local/f", "/remote/f")]

    def test_matching_sudo_delegates(self, pkg):
        sess, base = scp_session(pkg)
        with pkg.control.su("admin"):
            sess.upload("/local/f", "/remote/f")
        assert base.log == [("upload", "/local/f", "/remote/f")]

    def test_sudo_upload_does_tmpfile_dance(self, pkg):
        TMP_DIR = pkg.m("control.scp").TMP_DIR
        sess, base = scp_session(pkg)
        with pkg.control.su():
            sess.upload("/local/f", "/etc/secret")
        uploads = [e for e in base.log if isinstance(e, tuple)]
        assert len(uploads) == 1
        (_, src, tmp) = uploads[0]
        assert src == "/local/f" and tmp.startswith(TMP_DIR + "/")
        assert tmp.endswith("/f")  # basename preserved under tmp subdir
        cmds = [a.cmd for a in actions(pkg, base)]
        assert f"install -d -m 0777 {TMP_DIR}" in cmds
        assert f"chown root {tmp}" in cmds
        assert f"mv {tmp} /etc/secret" in cmds
        assert any(c.startswith(f"rm -rf {TMP_DIR}/") for c in cmds)
        chown = next(a for a in actions(pkg, base)
                     if a.cmd.startswith("chown"))
        assert chown.sudo == "root"

    def test_sudo_download_readable_file_fetches_directly(self, pkg):
        sess, base = scp_session(pkg)  # head succeeds by default
        with pkg.control.su():
            sess.download("/var/log/syslog", "/tmp/out")
        assert ("download", "/var/log/syslog", "/tmp/out") in base.log

    def test_sudo_download_unreadable_file_copies_first(self, pkg):
        TMP_DIR = pkg.m("control.scp").TMP_DIR

        def responder(node, action):
            if action.cmd.startswith("head"):
                return pkg.core.Result(exit=1, out="",
                                       err="Permission denied",
                                       cmd=action.cmd)
            return None

        sess, base = scp_session(pkg, responder)
        with pkg.control.su():
            sess.download("/srv/secret", "/tmp/out")
        cmds = [a.cmd for a in actions(pkg, base)]
        assert any(c.startswith(f"cp /srv/secret {TMP_DIR}/")
                   for c in cmds)
        # never ln -L: chowning a hardlink would chown the source inode
        assert not any(c.startswith("ln") for c in cmds)
        assert any(c.startswith(f"chown admin {TMP_DIR}/") for c in cmds)
        dl = next(e for e in base.log if isinstance(e, tuple)
                  and e[0] == "download")
        assert dl[1].startswith(TMP_DIR + "/") and dl[2] == "/tmp/out"

    def test_multi_file_sudo_upload_preserves_basenames(self, pkg):
        sess, base = scp_session(pkg)
        with pkg.control.su():
            sess.upload(["/l/a.conf", "/l/b.conf"], "/etc/app")
        mvs = [a.cmd for a in actions(pkg, base)
               if a.cmd.startswith("mv")]
        assert len(mvs) == 2
        assert mvs[0].split()[1].endswith("/a.conf")
        assert mvs[1].split()[1].endswith("/b.conf")
        assert mvs[0].endswith(" /etc/app/a.conf")
        assert mvs[1].endswith(" /etc/app/b.conf")

    def test_default_stack_includes_scp_wrapper(self, pkg):
        stack = pkg.control._default_ssh()
        assert isinstance(stack, pkg.m("control.retry").RetryingRemote)
        assert isinstance(stack.remote, pkg.m("control.scp").ScpRemote)
        assert isinstance(stack.remote.remote,
                          pkg.m("control.ssh").SshRemote)

    def test_tmp_dir_created_once_per_session(self, pkg):
        TMP_DIR = pkg.m("control.scp").TMP_DIR
        sess, base = scp_session(pkg)
        with pkg.control.su():
            sess.upload("/a", "/x")
            sess.upload("/b", "/y")
        mkdirs = [a for a in actions(pkg, base)
                  if a.cmd == f"install -d -m 0777 {TMP_DIR}"]
        assert len(mkdirs) == 1  # the shared dir; subdirs are per-file

    def test_hostile_basename_upload_restores_real_name_in_dir(self, pkg):
        def responder(node, action):
            if action.cmd.startswith("test -d"):
                return pkg.core.Result(exit=0, out="", err="",
                                       cmd=action.cmd)
            return None

        sess, base = scp_session(pkg, responder)
        with pkg.control.su():
            sess.upload("/l/my config (prod).yaml", "/etc/app")
        up = next(e for e in base.log if isinstance(e, tuple))
        assert up[2].endswith("/file")  # sanitized tmp name for scp
        mv = next(a.cmd for a in actions(pkg, base)
                  if a.cmd.startswith("mv"))
        assert mv.endswith(" '/etc/app/my config (prod).yaml'")

    def test_hostile_basename_download_renames_locally(self, pkg,
                                                       tmp_path):
        def responder(node, action):
            if action.cmd.startswith("head"):
                return pkg.core.Result(exit=1, out="", err="denied",
                                       cmd=action.cmd)
            return None

        DummyRemote = pkg.m("control.dummy").DummyRemote

        class WritingDummy(DummyRemote):
            def connect(self, conn_spec):
                sess = super().connect(conn_spec)
                orig = sess.download

                def download(remote_paths, local_path):
                    orig(remote_paths, local_path)
                    name = os.path.basename(str(remote_paths))
                    (tmp_path / name).write_text("data")
                sess.download = download
                return sess

        remote = pkg.m("control.scp").ScpRemote(WritingDummy(responder))
        sess = remote.connect({"host": "n1", "username": "admin"})
        with pkg.control.su():
            sess.download("/var/log/app log.1", str(tmp_path))
        assert (tmp_path / "app log.1").read_text() == "data"
        assert not (tmp_path / "file").exists()


def scp_stream(pkg):
    """Every transfer path of the scp layer over the dummy remote; the
    session log with the random tmp subdirectories replaced."""
    TMP_DIR = pkg.m("control.scp").TMP_DIR

    def responder(node, action):
        if action.cmd.startswith("head -c 1 /srv/"):
            return pkg.core.Result(exit=1, out="", err="denied",
                                   cmd=action.cmd)
        return None

    sess, base = scp_session(pkg, responder)
    sess.upload("/l/plain", "/r/plain")
    with pkg.control.su():
        sess.upload(["/l/a", "/l/b c"], "/etc/app")
        sess.upload("/l/one", "/etc/one")
        sess.download("/var/log/readable", "/tmp/out")
        sess.download(["/srv/secret", "/srv/other"], "/tmp/out")
    out = []
    for e in base.log:
        if isinstance(e, tuple):
            e = tuple(str(x) for x in e)
        else:
            e = (e.cmd, e.sudo, e.dir, e.stdin)
        out.append(tuple(_untmp(str(x), TMP_DIR) for x in e))
    return out


def _untmp(s: str, tmp_dir: str) -> str:
    """A string with each `TMP_DIR/<random>` replaced by `TMP_DIR/<n>`."""
    import re
    return re.sub(re.escape(tmp_dir) + r"/\d+", tmp_dir + "/<n>", s)


def test_scp_command_stream_equal_across_packages():
    j, p = both(scp_stream)
    assert p == j
    assert sum(1 for e in p if e[0] == "download") == 3


# ---------------------------------------------------------------------------
# The SSH session over fake ssh and scp executables
# ---------------------------------------------------------------------------

SPEC = {"host": "n1", "username": "admin", "port": 2222,
        "private_key_path": "/keys/id", "strict_host_key_checking": False}


def ssh_session(pkg, spec=SPEC):
    return pkg.m("control.ssh").SshRemote().connect(dict(spec))


def test_ssh_execute_argv_equal_across_packages(tmp_path, monkeypatch):
    calls = fake_ssh(tmp_path, monkeypatch, out="hello\n")

    def scen(pkg):
        sess = ssh_session(pkg)
        Action = pkg.core.Action
        got = [sess.execute(Action(cmd="echo hi")),
               sess.execute(Action(cmd="cat", stdin="data", sudo="root",
                                   dir="/opt"))]
        sess.disconnect()
        return [(r.exit, r.out, r.err, r.cmd) for r in got]

    before = len(calls())
    j = scen(Pkg("jepsen_tpu"))
    mid = len(calls())
    p = scen(Pkg("jepsen_tpu_torch"))
    argv = calls()
    assert p == j == [(0, "hello\n", "", "echo hi"),
                      (0, "hello\n", "",
                       "cd /opt && sudo -S -u root bash -c cat")]
    ja, pa = argv[before:mid], argv[mid:]
    assert [ctl_free(a) for a in pa] == [ctl_free(a) for a in ja]
    assert pa[0][:1] == ["ssh"] and "admin@n1" in pa[0]
    assert pa[0][pa[0].index("-p") + 1] == "2222"
    assert pa[0][pa[0].index("-i") + 1] == "/keys/id"
    assert "StrictHostKeyChecking=no" in pa[0]
    assert pa[1][-1] == "data"  # stdin reached ssh
    assert pa[2][:1] == ["ssh"] and "-O" in pa[2] and "exit" in pa[2]


def test_ssh_strict_host_keys_drop_the_no_check_options(tmp_path,
                                                        monkeypatch):
    calls = fake_ssh(tmp_path, monkeypatch)

    def scen(pkg):
        sess = ssh_session(pkg, dict(SPEC, strict_host_key_checking=True,
                                     private_key_path=None))
        sess.execute(pkg.core.Action(cmd="true"))
        sess.upload("/l/f", "/r/f")
        sess.disconnect()

    scen(Pkg("jepsen_tpu"))
    n = len(calls())
    scen(Pkg("jepsen_tpu_torch"))
    argv = calls()
    assert [ctl_free(a) for a in argv[n:]] == \
        [ctl_free(a) for a in argv[:n]]
    for a in argv[n:n + 2]:
        assert "StrictHostKeyChecking=no" not in a and "-i" not in a


@pytest.mark.parametrize("exit,err,raises", [
    (255, "ssh: connect to host n1 port 22: Connection refused\n",
     "TransportError"),
    (255, "mux_client_request_session: read from master failed\n",
     "TransportError"),
    (255, "myapp: fatal error 42\n", None),
    (1, "ssh: this text alone is not a transport failure\n", None),
    (0, "", None)])
def test_ssh_255_read_alike(tmp_path, monkeypatch, exit, err, raises):
    fake_ssh(tmp_path, monkeypatch, exit=exit, err=err)

    def scen(pkg):
        sess = ssh_session(pkg)
        try:
            r = sess.execute(pkg.core.Action(cmd="run-app"))
            return ("result", r.exit, r.err)
        except pkg.core.RemoteError as e:
            return (type(e).__name__, e.exit, e.node)
        finally:
            sess.disconnect()

    j, p = both(scen)
    assert p == j
    if raises:
        assert p == (raises, 255, "n1")
    else:
        assert p == ("result", exit, err)


@pytest.mark.parametrize("exit,raises", [(0, None), (1, "RemoteError"),
                                         (255, "TransportError")])
def test_scp_transfers_alike(tmp_path, monkeypatch, exit, raises):
    calls = fake_ssh(tmp_path, monkeypatch, exit=exit,
                     err="scp: /x: Permission denied\n")

    def scen(pkg):
        sess = ssh_session(pkg)
        out = []
        for f in (lambda: sess.upload(["/l/a", "/l/b"], "/r/dir"),
                  lambda: sess.download("/r/log", "/l/out")):
            try:
                f()
                out.append("ok")
            except pkg.core.RemoteError as e:
                out.append(type(e).__name__)
        sess.disconnect()
        return out

    n0 = len(calls())
    j = scen(Pkg("jepsen_tpu"))
    n1 = len(calls())
    p = scen(Pkg("jepsen_tpu_torch"))
    argv = calls()
    assert p == j == [raises or "ok"] * 2
    assert [ctl_free(a) for a in argv[n1:]] == \
        [ctl_free(a) for a in argv[n0:n1]]
    up, down = argv[n1], argv[n1 + 1]
    assert up[0] == "scp" and up[-3:-1] == ["/l/b", "admin@n1:/r/dir"]
    assert up[up.index("-P") + 1] == "2222"
    assert down[-3:-1] == ["admin@n1:/r/log", "/l/out"]


def test_missing_ssh_binary_is_a_transport_error(tmp_path, monkeypatch,
                                                 pkg):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    sess = ssh_session(pkg)
    with pytest.raises(pkg.core.TransportError, match="spawn failed"):
        sess.execute(pkg.core.Action(cmd="true"))
    with pytest.raises(pkg.core.TransportError, match="spawn failed"):
        sess.upload("/l/f", "/r/f")
    sess.disconnect()


def test_timed_out_command_is_not_retryable(tmp_path, monkeypatch, pkg):
    fake_ssh(tmp_path, monkeypatch)
    monkeypatch.setenv("FAKE_SSH_SLEEP", "5")
    sess = ssh_session(pkg)
    with pytest.raises(pkg.core.RemoteError) as ei:
        sess.execute(pkg.core.Action(cmd="sleep 60", timeout=0.5))
    assert not isinstance(ei.value, pkg.core.TransportError)
    sess.disconnect()


def test_disconnect_removes_the_control_directory(tmp_path, monkeypatch,
                                                  pkg):
    calls = fake_ssh(tmp_path, monkeypatch)
    sess = ssh_session(pkg)
    ctl = Path(sess._ctl_dir)
    assert ctl.is_dir()
    sess.execute(pkg.core.Action(cmd="true"))
    sess.disconnect()
    assert not ctl.exists()
    last = calls()[-1]
    assert last[:1] == ["ssh"] and last[-3:-1] == ["exit", "admin@n1"]


def test_concurrency_limit_bounds_parallel_commands(tmp_path,
                                                    monkeypatch, pkg):
    calls = fake_ssh(tmp_path, monkeypatch)
    monkeypatch.setenv("FAKE_SSH_SLEEP", "0.2")
    sess = pkg.m("control.ssh").SshRemote(concurrency_limit=2).connect(
        dict(SPEC))
    inside = [0]
    peak = [0]
    lock = threading.Lock()
    orig = sess._sem

    class Counting:
        def __enter__(self):
            orig.acquire()
            with lock:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])

        def __exit__(self, *exc):
            with lock:
                inside[0] -= 1
            orig.release()

    sess._sem = Counting()
    ts = [threading.Thread(target=sess.execute,
                           args=(pkg.core.Action(cmd="true"),))
          for _ in range(5)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    sess.disconnect()
    assert 1 <= peak[0] <= 2
    assert sum(1 for a in calls() if a[-2] == "true") == 5


# ---------------------------------------------------------------------------
# The default stack through control.remote_for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test_map", [{}, {"ssh": {}},
                                      {"ssh": {"username": "admin"}},
                                      {"ssh": {"dummy": False}}])
def test_remote_for_builds_the_default_stack(pkg, test_map):
    r = pkg.control.remote_for(test_map)
    assert type(r).__name__ == "RetryingRemote"
    assert type(r.remote).__name__ == "ScpRemote"
    assert type(r.remote.remote).__name__ == "SshRemote"
    g = pkg.control.remote_for(dict(test_map, health=object()))
    assert type(g).__name__ == "GuardedRemote"
    assert type(pkg.control.remote_for(
        {"ssh": {"dummy": True}})).__name__ == "DummyRemote"


def test_default_stack_retries_a_refusing_node(tmp_path, monkeypatch):
    """A node that refuses the connection (ssh exit 255 with ssh's own
    message) costs RETRIES + 1 attempts, each over a fresh session, and
    then a TransportError, in both packages."""
    calls = fake_ssh(tmp_path, monkeypatch, exit=255,
                     err="ssh: connect to host n1 port 22: "
                         "Connection refused\n")

    def scen(pkg):
        retry_mod = pkg.m("control.retry")
        monkeypatch.setattr(retry_mod, "BACKOFF_S", 0.001)
        monkeypatch.setattr(retry_mod, "BACKOFF_CAP_S", 0.002)
        n0 = len(calls())
        sess = pkg.control.session({"ssh": {"username": "admin"}}, "n1")
        with pytest.raises(pkg.core.TransportError):
            sess.execute(pkg.core.Action(cmd="hostname"))
        sess.disconnect()
        got = calls()[n0:]
        execs = [a for a in got if a[-2] == "hostname"]
        return len(execs), retry_mod.RETRIES, len(
            {c for a in execs for c in a if c.startswith("ControlPath=")})

    j, p = both(scen)
    assert p == j
    n, retries, ctl_dirs = p
    assert n == retries + 1 and ctl_dirs == n


def test_default_stack_sudo_upload_over_ssh(tmp_path, monkeypatch):
    """Under su, an upload through the default stack goes to the scp
    layer's tmp directory as the login user, then is chowned and moved
    as root: the same ssh and scp argv in both packages."""
    calls = fake_ssh(tmp_path, monkeypatch)

    def scen(pkg):
        n0 = len(calls())
        sess = pkg.control.session({"ssh": {"username": "admin"}}, "n1")
        with pkg.control.su():
            sess.upload("/l/app.conf", "/etc/app.conf")
        sess.disconnect()
        return [_untmp(" ".join(ctl_free(a[:-1])),
                       pkg.m("control.scp").TMP_DIR)
                for a in calls()[n0:]]

    j, p = both(scen)
    assert p == j
    assert any(a.startswith("scp ") and a.endswith(
        "/l/app.conf admin@n1:/tmp/jepsen/scp/<n>/app.conf") for a in p)
    assert any("chown root /tmp/jepsen/scp/<n>/app.conf" in a for a in p)
    assert any("mv /tmp/jepsen/scp/<n>/app.conf /etc/app.conf" in a
               for a in p)


# ---------------------------------------------------------------------------
# The docker and k8s runners' own process handling
# ---------------------------------------------------------------------------

def test_default_runner_over_a_fake_cli(tmp_path, monkeypatch, pkg):
    calls = fake_ssh(tmp_path, monkeypatch, exit=3, out="o", err="e",
                     tools=("docker", "kubectl"))
    run = pkg.m("control.docker")._default_runner
    r = run(["docker", "exec", "c1", "sh", "-c", "true"], stdin="in")
    assert (r.exit, r.out, r.err) == (3, "o", "e")
    assert r.cmd == "docker exec c1 sh -c true"
    assert calls()[-1] == ["docker", "exec", "c1", "sh", "-c", "true",
                           "in"]
    monkeypatch.setenv("FAKE_SSH_SLEEP", "5")
    with pytest.raises(pkg.core.RemoteError) as ei:
        run(["kubectl", "get", "pods"], timeout=0.5)
    assert not isinstance(ei.value, pkg.core.TransportError)
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(pkg.core.TransportError, match="spawn failed"):
        run(["docker", "ps"])


def remotes_stream(pkg):
    """The same actions through DockerRemote (a host:port node) and
    K8sRemote (context and namespace): every recorded argv."""
    core = pkg.core

    def reply(argv, stdin):
        if argv[:2] == ["docker", "ps"]:
            return core.Result(0, DOCKER_PS, "", "docker ps")
        return core.Result(0, "ok", "", " ".join(argv))

    out = []
    for remote_of in (
            lambda r: pkg.m("control.docker").DockerRemote(r),
            lambda r: pkg.m("control.k8s").K8sRemote(
                context="kind", namespace="jepsen", runner=r)):
        r = ScriptedRunner(pkg, reply)
        remote = remote_of(r)
        node = "localhost:30405" if "Docker" in type(
            remote).__name__ else "pod-2"
        test = {"nodes": [node], "remote": remote, "ssh": {}}
        with pkg.control.with_session(test, node):
            with pkg.control.su():
                with pkg.control.cd("/opt/db"):
                    pkg.control.exec_("ls", "-la")
                pkg.m("control.util").write_file("k=v\n", "/etc/db.conf")
            pkg.control.upload(["/l/a", "/l/b"], "/opt/db")
            pkg.control.download("/var/log/db.log", "/tmp/out")
        out.append(r.calls)
    out.append(pkg.m("control.k8s").list_pods(
        "kind", "jepsen", runner=ScriptedRunner(
            pkg, lambda argv, stdin: core.Result(0, "a b", "", ""))))
    return out


def test_runner_streams_equal_across_packages():
    j, p = both(remotes_stream)
    assert p == j
    docker, k8s, pods = p
    assert docker[0][0] == ["docker", "ps"]
    assert docker[1][0][:2] == ["docker", "exec"] and \
        docker[1][0][2] == "ffffffffffff"
    assert any(c[0][:3] == ["docker", "exec", "-i"] and c[1] == "k=v\n"
               for c in docker)
    assert k8s[0][0][:4] == ["kubectl", "exec", "--context=kind",
                             "--namespace=jepsen"]
    assert pods == ["a", "b"]
