"""The port's filesystem-fault layer against the JAX package's: lazyfs.py
(and its branch of nemesis/combined.py), charybdefs.py, faketime.py,
fs_cache.py and dbs/tcpdump.py.

- Every test of tests/test_fs_faults.py and tests/test_fs_cache.py has a
  counterpart here, run on each package (`[port]` and `[jax]`) with the
  same assertions.
- The ordered command stream that each node's dummy session records for
  lazyfs's install, mount, fifo and umount, faketime's wrap and unwrap,
  charybdefs's install, faults and clear, and tcpdump's setup and
  teardown is equal across the packages (the global random module
  seeded alike first: temporary directory names are drawn from it).
- A cache either package saved is read by the other.
- tcpdump's teardown waits until its process is gone, and ends.
- One small core.run in each package, at concurrency 1 with the
  nemesis ops between phases of client ops, under lazyfs's
  lose-unfsynced-writes, kill (through LazyFSDB) and membership, over
  ScpRemote(DummyRemote): equal histories, command logs, results and
  fault activations.
- The independent checker reads a nemesis op whose value is a pair as a
  keyed op, in both packages (ROADMAP C11).
"""

from __future__ import annotations

import importlib
import random
import threading
import time
from pathlib import Path

import pytest

import chip_smoke

ROOTS = {"port": "jepsen_tpu_torch", "jax": "jepsen_tpu"}
NODES = ["n1", "n2", "n3", "n4", "n5"]


class Pkg:
    def __init__(self, root: str):
        self.root = root

    def m(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    def __getattr__(self, name):
        if name in ("lazyfs", "faketime", "charybdefs", "fs_cache",
                    "control", "testing"):
            return self.m(name)
        raise AttributeError(name)

    @property
    def Action(self):
        return self.m("control.core").Action

    @property
    def Result(self):
        return self.m("control.core").Result

    def op(self, **kw):
        return self.m("history").op(**kw)


@pytest.fixture(params=list(ROOTS))
def pkg(request):
    return Pkg(ROOTS[request.param])


def both(scenario, *args):
    """(jax, port) results of one scenario, the global random module
    seeded alike before each."""
    out = []
    for root in ("jepsen_tpu", "jepsen_tpu_torch"):
        random.seed(1234)
        out.append(scenario(Pkg(root), *args))
    return tuple(out)


@pytest.fixture(autouse=True)
def clear_ip_caches():
    for root in ROOTS.values():
        importlib.import_module(f"{root}.net").clear_ip_cache()
    yield
    for root in ROOTS.values():
        importlib.import_module(f"{root}.net").clear_ip_cache()


def make_test(pkg, responder=None, nodes=("n1", "n2")):
    remote = pkg.m("control.dummy").DummyRemote(responder)
    t = pkg.testing.noop_test()
    t.update(nodes=list(nodes), remote=remote,
             sessions={n: remote.connect({"host": n}) for n in nodes})
    return t


def cmds(pkg, test, node):
    return [a.cmd for a in test["sessions"][node].log
            if isinstance(a, pkg.Action)]


def stream(pkg, test, node):
    """A node's whole session log: commands with their sudo user,
    directory, stdin and timeout, and transfers."""
    return [(a.cmd, a.sudo, a.dir, a.stdin, a.timeout)
            if isinstance(a, pkg.Action) else tuple(map(str, a))
            for a in test["sessions"][node].log]


# ---------------------------------------------------------------------------
# tests/test_fs_faults.py
# ---------------------------------------------------------------------------

class TestLazyfs:
    def test_map_normalization(self, pkg):
        lz = pkg.lazyfs.lazyfs("/var/lib/db/data")
        assert lz["dir"] == "/var/lib/db/data"
        assert lz["data-dir"] == "/var/lib/db/data.data"
        assert lz["fifo"].endswith(".lazyfs/fifo")
        assert "lazyfs.log" in lz["log-file"]

    def test_config_includes_fifo_and_log(self, pkg):
        lz = pkg.lazyfs.lazyfs("/data")
        cfg = pkg.lazyfs.config(lz)
        assert 'fifo_path="/data.lazyfs/fifo"' in cfg
        assert 'logfile="/data.lazyfs/lazyfs.log"' in cfg

    def test_mount_and_fault_commands(self, pkg):
        test = make_test(pkg)
        lz = pkg.lazyfs.lazyfs("/data")
        with pkg.control.with_session(test, "n1"):
            pkg.lazyfs.mount(lz)
            pkg.lazyfs.lose_unfsynced_writes(lz)
            pkg.lazyfs.checkpoint(lz)
            pkg.lazyfs.umount(lz)
        got = " ; ".join(cmds(pkg, test, "n1"))
        assert "--config-path /data.lazyfs/lazyfs.conf" in got
        assert "subdir=/data.data" in got
        assert "lazyfs::clear-cache > /data.lazyfs/fifo" in got
        assert "lazyfs::cache-checkpoint" in got
        assert "fusermount -u /data" in got

    def test_db_wrapper_kill_loses_unfsynced(self, pkg):
        test = make_test(pkg)
        testing = pkg.testing

        class Inner(testing.AtomDB):
            supports_kill = True

            def __init__(self):
                super().__init__(testing.AtomState())
                self.killed = 0

            def kill(self, t, node):
                self.killed += 1
                return "killed"

        inner = Inner()
        db = pkg.lazyfs.LazyFSDB("/data", inner)
        assert db.supports_kill
        assert not db.supports_pause
        with pkg.control.with_session(test, "n1"):
            out = db.kill(test, "n1")
        assert out == "killed" and inner.killed == 1
        got = " ; ".join(cmds(pkg, test, "n1"))
        assert "lazyfs::clear-cache" in got

    def test_nemesis_op(self, pkg):
        test = make_test(pkg)
        nem = pkg.lazyfs.nemesis("/data")
        done = nem.invoke(test, pkg.op(
            type="info", f="lose-unfsynced-writes", value=["n1"]))
        assert done.value == {"n1": "done"}
        assert any("clear-cache" in c for c in cmds(pkg, test, "n1"))
        assert not any("clear-cache" in c for c in cmds(pkg, test, "n2"))
        assert nem.fs() == {"lose-unfsynced-writes"}
        with pytest.raises(ValueError, match="unknown f"):
            nem.invoke(test, pkg.op(type="info", f="scramble",
                                    value=["n1"]))


class TestFileCorruptionPackageLazyfs:
    def test_lose_unfsynced_writes_fault(self, pkg):
        combined = pkg.m("nemesis.combined")
        test = make_test(pkg)
        lz = pkg.lazyfs.lazyfs("/data")
        p = combined.file_corruption_package({
            "db": pkg.testing.AtomDB(pkg.testing.AtomState()),
            "faults": {"file-corruption"},
            "file_corruption": {
                "targets": ["all"], "lazyfs": lz,
                "corruptions": [{"type": "lose-unfsynced-writes"}]}})
        assert "lose-unfsynced-writes" in p["nemesis"].fs()
        nem = p["nemesis"].setup(test)
        done = nem.invoke(test, pkg.op(
            type="info", f="lose-unfsynced-writes", value=["all", None]))
        assert set(done.value) == {"n1", "n2"}
        assert any("clear-cache" in c for c in cmds(pkg, test, "n1"))

    def test_requires_lazyfs_map(self, pkg):
        combined = pkg.m("nemesis.combined")
        with pytest.raises(ValueError, match="lazyfs"):
            combined.file_corruption_package({
                "db": pkg.testing.AtomDB(pkg.testing.AtomState()),
                "faults": {"file-corruption"},
                "file_corruption": {
                    "targets": ["all"],
                    "corruptions": [
                        {"type": "lose-unfsynced-writes"}]}})


class TestCharybdefs:
    def test_fault_commands(self, pkg):
        test = make_test(pkg)
        with pkg.control.with_session(test, "n1"):
            pkg.charybdefs.break_all()
            pkg.charybdefs.break_one_percent()
            pkg.charybdefs.clear()
        got = cmds(pkg, test, "n1")
        assert any("./recipes --io-error" in c for c in got)
        assert any("./recipes --probability" in c for c in got)
        assert any("./recipes --clear" in c for c in got)

    def test_nemesis(self, pkg):
        test = make_test(pkg)
        nem = pkg.charybdefs.nemesis()
        done = nem.invoke(test, pkg.op(type="info", f="break-all",
                                       value=None))
        assert set(done.value) == {"n1", "n2"}
        for n in ("n1", "n2"):
            assert any("--io-error" in c for c in cmds(pkg, test, n))
        nem.teardown(test)
        assert any("--clear" in c for c in cmds(pkg, test, "n1"))
        assert nem.fs() == {"break-all", "break-one-percent",
                            "clear-faults"}


class TestFaketime:
    def test_script(self, pkg):
        s = pkg.faketime.script("/opt/db/bin.no-faketime", 5, 1.25)
        assert 'faketime -m -f "+5s x1.25"' in s
        assert s.startswith("#!/bin/bash")
        s = pkg.faketime.script("/x", -3, 0.5)
        assert '"-3s x0.5"' in s

    def test_wrap_and_unwrap(self, pkg):
        state = {"wrapped": False}

        def responder(node, action):
            if action.cmd.startswith("stat "):
                # .no-faketime exists only after wrap
                ok = state["wrapped"] and ".no-faketime" in action.cmd
                return pkg.Result(exit=0 if ok else 1, out="", err="",
                                  cmd=action.cmd)
            return None

        test = make_test(pkg, responder)
        with pkg.control.with_session(test, "n1"):
            pkg.faketime.wrap("/opt/db/bin", 2, 1.5)
            state["wrapped"] = True
            pkg.faketime.unwrap("/opt/db/bin")
        got = cmds(pkg, test, "n1")
        assert any(c.startswith("mv /opt/db/bin /opt/db/bin.no-faketime")
                   for c in got)
        assert any("chmod a+x /opt/db/bin" in c for c in got)
        assert any(c.startswith("mv /opt/db/bin.no-faketime /opt/db/bin")
                   for c in got)

    def test_rand_factor_bounds(self, pkg):
        rng = random.Random(3)
        rates = [pkg.faketime.rand_factor(2.5, rng) for _ in range(200)]
        assert max(rates) <= 2.5 * min(rates) + 1e-9
        assert all(0 < r < 2 for r in rates)


class TestReviewRegressions:
    def test_package_accepts_bare_dir(self, pkg):
        """A bare dir (or partial map) normalizes like every other lazyfs
        entry point."""
        combined = pkg.m("nemesis.combined")
        test = make_test(pkg)
        p = combined.file_corruption_package({
            "db": pkg.testing.AtomDB(pkg.testing.AtomState()),
            "faults": {"file-corruption"},
            "file_corruption": {
                "targets": ["all"], "lazyfs": "/data",
                "corruptions": [{"type": "lose-unfsynced-writes"}]}})
        nem = p["nemesis"].setup(test)
        done = nem.invoke(test, pkg.op(
            type="info", f="lose-unfsynced-writes", value=["all", None]))
        assert set(done.value) == {"n1", "n2"}


def test_rand_factor_and_script_alike():
    j, p = both(lambda pkg: (
        [pkg.faketime.rand_factor(f, random.Random(7))
         for f in (1.0, 1.5, 2.5, 10)],
        pkg.faketime.script("/opt/db/bin", -2.7, 3)))
    assert p == j


# ---------------------------------------------------------------------------
# Command streams across the packages
# ---------------------------------------------------------------------------

def fs_responder(pkg):
    """Answers for the installs: charybdefs is not built yet, thrift's
    archive unpacks to one directory, dpkg lists nothing; tcpdump runs
    from its start until SIGINT."""
    alive = {}

    def respond(node, action):
        cmd = action.cmd
        if cmd in ("stat /opt/charybdefs/charybdefs",
                   "stat /opt/jepsen/lazyfs/.git") or cmd.startswith(
                       "stat /tmp/jepsen/wget-cache/"):
            return pkg.Result(exit=1, out="", err="absent", cmd=cmd)
        if cmd.startswith("ls -A "):
            return "thrift-0.10.0"
        if cmd.startswith("dirname "):
            return cmd.split()[-1].rsplit("/", 1)[0] or "/"
        if "start-stop-daemon" in cmd and "/usr/bin/tcpdump" in cmd:
            alive[node] = True
        if cmd == "cat /tmp/jepsen/tcpdump/pid":
            return "77" if alive.get(node) else pkg.Result(
                exit=1, out="", err="No such file", cmd=cmd)
        if cmd == "kill -s INT 77":
            alive[node] = False
        if cmd == "ps -p 77":
            return pkg.Result(exit=0 if alive.get(node) else 1, out="",
                              err="", cmd=cmd)
        if cmd == "bash -c 'echo $SSH_CLIENT'":
            return "10.0.0.9 52110 22"
        return None

    return respond


def fs_streams(pkg):
    test = make_test(pkg, fs_responder(pkg))
    lz = pkg.lazyfs.lazyfs({"dir": "/var/lib/db", "user": "db",
                            "cache-size": "1GB"})
    td = pkg.m("dbs.tcpdump").tcpdump(ports=[2379, 2380],
                                      clients_only=True,
                                      filter="tcp")
    with pkg.control.with_session(test, "n1"):
        pkg.lazyfs.install()
        pkg.lazyfs.mount(lz)
        pkg.lazyfs.fifo(lz, "lazyfs::display-cache-usage")
        pkg.lazyfs.umount(lz)
        pkg.faketime.install()
        pkg.faketime.wrap("/opt/db/bin/db", -3, 1.25)
        pkg.faketime.unwrap("/opt/db/bin/db")
    with pkg.control.with_session(test, "n2"):
        pkg.charybdefs.install()
        pkg.charybdefs.break_all()
        pkg.charybdefs.break_one_percent()
        pkg.charybdefs.clear()
        td.setup(test, "n2")
        td.teardown(test, "n2")
        files = td.log_files(test, "n2")
    return stream(pkg, test, "n1"), stream(pkg, test, "n2"), files


def test_command_streams_equal_across_packages():
    j, p = both(fs_streams)
    assert p == j
    n1, n2, files = p
    c1 = [e[0] for e in n1]
    assert c1[0] == "mkdir -p /opt/jepsen/lazyfs"
    assert ("git clone https://github.com/dsrhaslab/lazyfs.git "
            "/opt/jepsen/lazyfs") in c1
    assert "chown db:db /var/lib/db" in c1
    assert any("faketime -m -f" in (e[3] or "") for e in n1)
    c2 = [e[0] for e in n2]
    assert any(c.startswith("wget ") for c in c2)  # thrift's archive
    assert "cmake CMakeLists.txt" in c2
    assert any("'port 2379 or port 2380 and host 10.0.0.9 and tcp'" in c
               for c in c2)
    assert c2.count("ps -p 77") == 1 and "kill -s INT 77" in c2
    assert files == {"/tmp/jepsen/tcpdump/log": "tcpdump.log",
                     "/tmp/jepsen/tcpdump/tcpdump": "tcpdump.pcap"}


class TestTcpdump:
    def test_teardown_waits_for_the_capture_to_end(self, pkg):
        """tcpdump's teardown polls `ps -p` until it fails: here the
        process outlives SIGINT by three polls."""
        polls = {"left": 3}

        def respond(node, action):
            if action.cmd == "cat /tmp/jepsen/tcpdump/pid":
                return "88"
            if action.cmd == "ps -p 88":
                polls["left"] -= 1
                return pkg.Result(exit=0 if polls["left"] >= 0 else 1,
                                  out="", err="", cmd=action.cmd)
            return None

        test = make_test(pkg, respond)
        td = pkg.m("dbs.tcpdump").tcpdump()
        done = threading.Event()

        def teardown():
            with pkg.control.with_session(test, "n1"):
                td.teardown(test, "n1")
            done.set()

        t = threading.Thread(target=teardown, daemon=True)
        t.start()
        assert done.wait(10), "teardown did not end"
        got = cmds(pkg, test, "n1")
        assert got.count("ps -p 88") == 4
        assert got.index("kill -s INT 88") < got.index("ps -p 88")
        assert got[-1] == "rm -rf /tmp/jepsen/tcpdump"

    def test_teardown_without_a_pid_file(self, pkg):
        def respond(node, action):
            if action.cmd.startswith("cat "):
                return pkg.Result(exit=1, out="", err="absent",
                                  cmd=action.cmd)
            return None

        test = make_test(pkg, respond)
        with pkg.control.with_session(test, "n1"):
            pkg.m("dbs.tcpdump").tcpdump().teardown(test, "n1")
        got = cmds(pkg, test, "n1")
        assert not any(c.startswith(("kill -s INT", "ps -p"))
                       for c in got)
        assert "killall -9 -w tcpdump" in got
        assert got[-1] == "rm -rf /tmp/jepsen/tcpdump"

    def test_setup_starts_a_daemon_with_the_filter(self, pkg):
        test = make_test(pkg)
        with pkg.control.with_session(test, "n1"):
            pkg.m("dbs.tcpdump").tcpdump(ports=[5432]).setup(test, "n1")
        got = cmds(pkg, test, "n1")
        assert got[0] == "mkdir -p /tmp/jepsen/tcpdump"
        ssd = next(c for c in got if "start-stop-daemon" in c)
        assert "--pidfile /tmp/jepsen/tcpdump/pid" in ssd
        assert "-w /tmp/jepsen/tcpdump/tcpdump" in ssd
        assert ssd.endswith("'port 5432' >> /tmp/jepsen/tcpdump/log 2>&1")
        sudo = {a.sudo for a in test["sessions"]["n1"].log}
        assert sudo == {"root"}


# ---------------------------------------------------------------------------
# tests/test_fs_cache.py
# ---------------------------------------------------------------------------

@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("JEPSEN_TPU_CACHE_DIR", str(d))
    return d


class TestFsCache:
    def test_string_roundtrip(self, pkg, cache_dir):
        fc = pkg.fs_cache
        assert not fc.cached_p(["foo", 1])
        assert fc.load_string(["foo", 1]) is None
        fc.save_string("hello", ["foo", 1])
        assert fc.cached_p(["foo", 1])
        assert fc.load_string(["foo", 1]) == "hello"

    def test_data_roundtrip(self, pkg, cache_dir):
        fc = pkg.fs_cache
        fc.save_data({"a": [1, 2], "b": None}, ["db", "license"])
        assert fc.load_data(["db", "license"]) == {"a": [1, 2], "b": None}

    def test_path_encoding_weird_parts(self, pkg, cache_dir):
        fc = pkg.fs_cache
        fc.save_string("x", ["a/b", True, 3, None])
        assert fc.load_string(["a/b", True, 3, None]) == "x"
        # slash must not escape the cache dir
        assert "a%2Fb" in str(fc.file(["a/b"]))

    def test_file_roundtrip(self, pkg, cache_dir, tmp_path):
        fc = pkg.fs_cache
        src = tmp_path / "artifact.bin"
        src.write_bytes(b"\x00\x01payload")
        fc.save_file(src, ["bin", "v1"])
        got = fc.load_file(["bin", "v1"])
        assert got is not None and got.read_bytes() == b"\x00\x01payload"

    def test_atomic_write_no_partial_on_error(self, pkg, cache_dir):
        fc = pkg.fs_cache

        class Boom(Exception):
            pass

        with pytest.raises(Boom):
            with fc._atomic(fc.file(["x"])) as tmp:
                tmp.write_text("partial")
                raise Boom()
        assert not fc.cached_p(["x"])
        assert not [p for p in cache_dir.rglob("*") if p.is_file()]

    def test_deploy_remote(self, pkg, cache_dir, tmp_path):
        fc = pkg.fs_cache
        src = tmp_path / "bin"
        src.write_text("binary!")
        fc.save_file(src, ["tool"])
        test = make_test(pkg, nodes=("n1",))
        with pkg.control.with_session(test, "n1"):
            fc.deploy_remote(["tool"], "/opt/bin/tool")
        log = test["sessions"]["n1"].log
        got = cmds(pkg, test, "n1")
        assert any("rm -rf /opt/bin/tool" in c for c in got)
        assert any("mkdir -p /opt/bin" in c for c in got)
        uploads = [e for e in log if isinstance(e, tuple)
                   and e[0] == "upload"]
        assert uploads and uploads[0][2] == "/opt/bin/tool"

    def test_deploy_uncached_raises(self, pkg, cache_dir):
        with pytest.raises(RuntimeError):
            pkg.fs_cache.deploy_remote(["nope"], "/opt/x")

    def test_deploy_suspicious_path_raises(self, pkg, cache_dir, tmp_path):
        src = tmp_path / "f"
        src.write_text("x")
        pkg.fs_cache.save_file(src, ["f"])
        with pytest.raises(ValueError):
            pkg.fs_cache.deploy_remote(["f"], "/etc")

    def test_locking_serializes(self, pkg, cache_dir):
        order = []

        def worker(i):
            with pkg.fs_cache.locking(["expensive"]):
                order.append(("in", i))
                time.sleep(0.001)
                order.append(("out", i))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        # never two 'in's without an 'out' between them
        depth = 0
        for kind, _ in order:
            depth += 1 if kind == "in" else -1
            assert 0 <= depth <= 1
        assert len(order) == 8


class TestFsCacheReviewRegressions:
    def test_dotdot_cannot_escape_cache(self, pkg, cache_dir):
        fc = pkg.fs_cache
        fc.save_string("x", ["..", "evil"])
        f = fc.file(["..", "evil"])
        assert fc._base().resolve() in f.resolve().parents

    def test_relative_deploy_path_rejected(self, pkg, cache_dir, tmp_path):
        src = tmp_path / "f"
        src.write_text("x")
        pkg.fs_cache.save_file(src, ["g"])
        with pytest.raises(ValueError):
            pkg.fs_cache.deploy_remote(["g"], "tmp/sub/file")

    def test_scalar_and_list_paths_share_a_lock(self, pkg, cache_dir):
        order = []

        def one(spelling):
            with pkg.fs_cache.locking(spelling):
                order.append("in")
                time.sleep(0.01)
                order.append("out")

        ts = [threading.Thread(target=one, args=(s,))
              for s in ("same", ["same"])]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert order == ["in", "out", "in", "out"]

    def test_save_data_rejects_non_json(self, pkg, cache_dir):
        with pytest.raises(TypeError):
            pkg.fs_cache.save_data({"v": Path("/x")}, ["bad"])
        assert not pkg.fs_cache.cached_p(["bad"])


def test_a_cache_carries_over_between_packages(cache_dir, tmp_path):
    """The same variable, default directory and layout: what one
    package saved, the other finds under the same file."""
    j, p = (Pkg(r).fs_cache for r in ("jepsen_tpu", "jepsen_tpu_torch"))
    assert p.DEFAULT_DIR == j.DEFAULT_DIR
    paths = (["str", 1, True, None, "a/b"], ["data", "v1"], ["file"])
    for path in paths:
        assert p.file(path) == j.file(path)
    j.save_string("from jax", paths[0])
    p.save_data({"from": "port"}, paths[1])
    src = tmp_path / "blob"
    src.write_bytes(b"\x00blob")
    j.save_file(src, paths[2])
    assert p.load_string(paths[0]) == "from jax"
    assert j.load_data(paths[1]) == {"from": "port"}
    assert p.load_file(paths[2]).read_bytes() == b"\x00blob"
    p.clear()
    assert not j.cached_p(paths[0]) and not cache_dir.exists()


def test_save_remote_downloads_into_the_cache(pkg, cache_dir):
    test = make_test(pkg, nodes=("n1",))
    with pkg.control.with_session(test, "n1"):
        got = pkg.fs_cache.save_remote("/var/lib/db/snapshot",
                                       ["snap", "n1"])
    assert got == "/var/lib/db/snapshot"
    (kind, remote, local), = [e for e in test["sessions"]["n1"].log
                              if isinstance(e, tuple)]
    assert kind == "download" and remote == ["/var/lib/db/snapshot"]
    # the dummy wrote nothing: the atomic rename leaves an empty file
    # where the download landed, and no temporary file beside it
    assert Path(local).parent == pkg.fs_cache.file(["snap", "n1"]).parent
    assert [p.name for p in pkg.fs_cache.file(["snap"]).iterdir()] == \
        ["n1"]


# ---------------------------------------------------------------------------
# ROADMAP C11: pair-valued nemesis ops reach the independent checker
# ---------------------------------------------------------------------------

def test_nemesis_pairs_become_independent_keys():
    """Jepsen's independent checker keys only its own tuples; both
    packages key every op whose value is a two-element list, so a
    file-corruption op `[node-spec, corruption]` and a membership
    completion `[node, status]` are checked as keys, the key None's
    certificate fails to validate, and a node list as the spec (a list
    key) raises TypeError."""
    def scen(pkg):
        models = pkg.m("checker.models")
        opts = {"model": models.cas_register()}
        if pkg.root == "jepsen_tpu_torch":
            opts["device"] = "cpu"
        c = pkg.m("independent").checker(pkg.m("checker").linearizable(
            opts))
        h = pkg.m("history")
        ops = [h.op(type="invoke", f="write", value=(0, 1), process=0),
               h.op(type="ok", f="write", value=(0, 1), process=0),
               h.op(type="info", f="lose-unfsynced-writes",
                    value=[None, None], process="nemesis"),
               h.op(type="info", f="lose-unfsynced-writes",
                    value={"n1": "done"}, process="nemesis"),
               h.op(type="info", f="remove-member", value="n4",
                    process="nemesis"),
               h.op(type="info", f="remove-member", value=["n4", "removed"],
                    process="nemesis"),
               h.op(type="invoke", f="read", value=(0, None), process=0),
               h.op(type="ok", f="read", value=(0, 1), process=0)]
        res = pkg.m("core").analyze({"history": h.History(ops),
                                     "checker": c})["results"]
        keyed = {k: (v["valid?"], v.get("certified"),
                     "certificate-error" in v)
                 for k, v in res["results"].items()}
        with pytest.raises(TypeError, match="unhashable"):
            c.check({}, h.History(ops[:2] + [h.op(
                type="info", f="lose-unfsynced-writes",
                value=[["n1", "n2"], None], process="nemesis")]))
        return res["valid?"], keyed

    j, p = both(scen)
    assert p == j
    assert p == (True, {0: (True, True, False), None: (True, None, True),
                        "n4": (True, True, False)})


# ---------------------------------------------------------------------------
# One small core.run in each package
# ---------------------------------------------------------------------------

def fault_run(pkg, store_base):
    """A register run at concurrency 1 over ScpRemote(DummyRemote): the
    LazyFSDB over a fake DB, the nemesis ops between phases of client
    ops: lose-unfsynced-writes on all nodes, kill on n3 (LazyFSDB.kill
    drops the page cache), remove n4 from the member list, start all,
    add n4 back, then the packages' final generator."""
    from test_torch_core import fake_db, responder

    root = pkg.root
    gen = pkg.m("generator")
    chk = pkg.m("checker")
    db = pkg.lazyfs.LazyFSDB("/var/lib/db", fake_db(root))

    class State(chip_smoke.MemberMachine,
                pkg.m("nemesis.membership").MembershipState):
        control = pkg.control

    members = chip_smoke.MemberList(NODES)
    state = State(members, db=db, seed=3)
    p = pkg.m("nemesis.combined").nemesis_package({
        "db": db, "faults": ["file-corruption", "kill", "membership"],
        "interval": 1,
        "file_corruption": {"lazyfs": db.lazyfs, "corruptions": [
            {"type": "lose-unfsynced-writes"}]},
        "membership": {"state": state,
                       "view-interval": 0.01}})
    opts = {"model": pkg.m("checker.models").cas_register()}
    if root == "jepsen_tpu_torch":
        opts["device"] = "cpu"
    lin = pkg.m("independent").checker(chk.linearizable(opts))

    def client_ops(seed, n):
        rng = random.Random(seed)
        out = []
        for _ in range(n):
            k = rng.randrange(3)
            r = rng.random()
            if r < 0.5:
                out.append({"f": "read", "value": (k, None)})
            else:
                out.append({"f": "write", "value": (k, rng.randrange(3))})
        return gen.clients(out)

    def nem(f, value):
        return gen.nemesis({"type": "info", "f": f, "value": value})

    def settled():
        # the pollers saw n4 leave before anything else happens
        deadline = time.time() + 10
        while time.time() < deadline and (
                state.pending or "n4" in (state.view or ())):
            time.sleep(0.01)
        return None

    test = pkg.testing.noop_test()
    test.update({
        "name": "fault-parity", "store_base": str(store_base),
        "remote": pkg.m("control.scp").ScpRemote(
            pkg.m("control.dummy").DummyRemote(responder)),
        "db": db, "concurrency": 1,
        "client": pkg.testing.KVClient(pkg.testing.KVState(),
                                       latency_s=0),
        "nemesis": p["nemesis"],
        "checker": chk.compose({"workload": lin, "stats": chk.stats()}),
        "plot": {"nemeses": p["perf"]},
        "generator": gen.phases(
            client_ops(1, 10),
            nem("lose-unfsynced-writes", ["all", None]),
            client_ops(2, 10), nem("kill", ["n3"]),
            client_ops(3, 10), nem("remove-member", "n4"),
            settled, nem("start", "all"), client_ops(4, 10),
            nem("add-member", "n4"),
            gen.nemesis(p["final_generator"]))})
    out = pkg.m("core").run(test)
    rec = pkg.m("coverage").load_record(out["store_dir"])
    faults = sorted((f["kind"], f["count"]) for f in rec["faults"])
    return out, faults, sorted(members.members)


def test_core_run_under_the_fs_faults_alike(tmp_path):
    from test_torch_core import untimed

    def scen(pkg):
        out, faults, members = fault_run(pkg, tmp_path / pkg.root)
        hist = [(o.type, o.f, untimed(o.value), o.process)
                for o in out["history"]]
        logs = {n: [a.cmd if not isinstance(a, tuple) else
                    (a[0], str(a[1]),
                     str(a[2]).replace(str(out["store_dir"]), "<run>"))
                    for a in s.base.log]
                for n, s in out["sessions"].items()}
        return hist, logs, untimed(out["results"]), faults, members

    j, p = both(scen)
    assert p[0] == j[0]
    assert p[1] == j[1]
    assert p[2] == j[2]
    assert p[3] == j[3] and p[4] == j[4] == NODES
    hist, logs, results, faults, _m = p
    assert len([o for o in hist if o[3] == 0]) == 80
    nem_done = [(f, v) for t, f, v, proc in hist
                if proc == "nemesis" and isinstance(v, (dict, list))]
    assert ("remove-member", ["n4", "removed"]) in nem_done
    assert ("add-member", ["n4", "added"]) in nem_done
    kinds = dict(faults)
    assert kinds["file-lost-writes"] >= 1 and kinds["membership"] >= 2
    assert kinds["db-kill"] >= 1
    # kill through LazyFSDB dropped n3's page cache, the add wiped n4's
    # stale data directory, every node unmounted lazyfs at teardown
    assert sum("lazyfs::clear-cache" in c for c in logs["n3"]
               if isinstance(c, str)) == 2
    assert f"rm -rf {chip_smoke.LAZYFS_DIR}/n4" in logs["n4"]
    assert all("fusermount -u /var/lib/db" in logs[n] for n in NODES)
    assert results["valid?"] is True
    assert not [t for t in threading.enumerate()
                if t.name.startswith("membership-view-")]


def test_chip_smoke_phase_25_on_the_cpu():
    """chip_smoke's transports phase at a small size on the CPU: every
    check of the phase runs (verdicts against the CPU re-analysis, fault
    kinds in coverage, the fetched tcpdump files, the sudo download, the
    transport faults and reconnects, the view threads, the fs_cache
    directory); the card-only launch counts are skipped by the phase."""
    import torch

    threads = set(threading.enumerate())
    got = chip_smoke.transports_path(torch.device("cpu"), False, {
        "register_keys": 4, "txn_ops": 1500, "nemesis_ops": 12})
    assert got["wgl_search"] == {"transports-register-ssh-stack": 1,
                                 "transports-register-twin-docker": 1}
    assert got["scc"] == {"transports-list-append-k8s": 0}
    assert not [t.name for t in threading.enumerate() if t not in threads]
