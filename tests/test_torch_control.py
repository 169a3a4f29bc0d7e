"""The port's control plane against the JAX package's: control/core.py,
the dummy remote, the control DSL (control/__init__.py), control/util.py,
os_setup/ and net.py.

Each scenario runs once with each package's modules over its own dummy
remote and returns what the nodes were asked to do (every session's log:
command, sudo user, directory, stdin, timeout, uploads and downloads)
and what the call returned. The two packages must give the same, and
the port's result must also meet the JAX package's own test of it
(tests/test_control_util.py, test_os_setup.py, test_net.py and the dummy
part of test_remotes.py). All comparisons are exact.
"""

from __future__ import annotations

import importlib
import random

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")


class Pkg:
    """One package's modules by their shared names."""

    def __init__(self, root: str):
        self.root = root

    def m(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    @property
    def control(self):
        return self.m("control")

    @property
    def cu(self):
        return self.m("control.util")

    @property
    def core(self):
        return self.m("control.core")

    @property
    def net(self):
        return self.m("net")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    """Both packages' net modules memoize node addresses at module
    level; a test must leave neither cache behind (other files' tests
    resolve the same node names through other responders)."""
    for root in ROOTS:
        importlib.import_module(f"{root}.net").clear_ip_cache()
    yield
    for root in ROOTS:
        importlib.import_module(f"{root}.net").clear_ip_cache()


def entry(a):
    if isinstance(a, tuple):
        return tuple(map(repr, a))
    return (a.cmd, a.sudo, a.dir, a.stdin, a.timeout)


def session_test(pkg: Pkg, responder=None, nodes=("n1",)):
    dummy = pkg.m("control.dummy")
    remote = dummy.DummyRemote(responder)
    return {"nodes": list(nodes), "remote": remote, "ssh": {},
            "sessions": {n: remote.connect({"host": n}) for n in nodes}}


def logs(test) -> dict:
    return {n: [entry(a) for a in s.log]
            for n, s in test["sessions"].items()}


def both(scenario, *args):
    """(jax, port) outcomes of one scenario, each seeding the global
    random module the same way first."""
    out = []
    for root in ROOTS:
        random.seed(1234)
        out.append(scenario(Pkg(root), *args))
    assert out[0] == out[1]
    return out[1]


def on_n1(pkg, body, responder=None):
    """Runs body(pkg) with n1's session bound; returns (result, logs)."""
    test = session_test(pkg, responder)
    with pkg.control.with_session(test, "n1"):
        res = body(pkg)
    return res, logs(test)


def n1_cmds(out, sudo=None):
    return [(c[0], c[1]) for c in out[1]["n1"]
            if len(c) == 5 and (sudo is None or c[1] == sudo)]


# ---------------------------------------------------------------------------
# control/core.py: shell construction, the dummy remote
# ---------------------------------------------------------------------------

ARGS = [["echo", "hi"], ["a b", "c'd", 3, None, ["x", "y z"]],
        ["ls", "-A", "/tmp/jepsen"], ["", "$HOME", "a;b", "%^@+=:,./"]]


@pytest.mark.parametrize("args", ARGS, ids=range(len(ARGS)))
def test_join_cmd_and_escape(args):
    def scen(pkg):
        core = pkg.core
        return (core.join_cmd(*args), [core.escape(a) for a in args
                                       if a is not None
                                       and not isinstance(a, list)],
                core.join_cmd(core.Lit(">"), "f"),
                core.env_string({"A": "b c", "N": 1}),
                core.env_string(None))

    got = both(scen)
    assert got[2] == "> f"


@pytest.mark.parametrize("sudo,dir_", [(None, None), ("root", None),
                                       ("db", "/opt/db"), (None, "/x y")])
def test_wrap_sudo(sudo, dir_):
    def scen(pkg):
        core = pkg.core
        return core.wrap_sudo(core.Action(cmd="echo 'hi'", sudo=sudo,
                                          dir=dir_))

    got = both(scen)
    if sudo:
        assert got.endswith("bash -c 'echo '\"'\"'hi'\"'\"''")


def test_dummy_remote_records_and_answers():
    def scen(pkg):
        core = pkg.core

        def responder(node, action):
            if action.cmd == "hostname":
                return f"{node}.local"
            if action.cmd == "false":
                return core.Result(exit=1, out="", err="no", cmd="false")
            return None

        sess = pkg.m("control.dummy").DummyRemote(responder).connect(
            {"host": "n2"})
        outs = [sess.execute(core.Action(cmd=c))
                for c in ("hostname", "false", "true")]
        sess.upload(["/a"], "/b")
        sess.download(["/c"], "/d")
        with pytest.raises(core.RemoteError):
            core.throw_on_nonzero_exit("n2", outs[1])
        return ([(r.exit, r.out, r.err, r.cmd) for r in outs],
                [entry(a) for a in sess.log])

    got = both(scen)
    assert got[0][0] == (0, "n2.local", "", "hostname")


def test_traced_execute_records_remote_spans(tmp_path):
    def scen(pkg):
        core, tracing = pkg.core, pkg.m("tracing")
        tr = tracing.get()
        tr.reset(enabled=True)
        try:
            sess = pkg.m("control.dummy").DummyRemote().connect(
                {"host": "n1"})
            op = pkg.m("history").op(index=0, type="invoke", process=0,
                                     f="write", value=1, time=0)
            with tr.op_span(op):
                core.traced_execute(sess, core.Action(cmd="echo hi",
                                                      sudo="root"),
                                    node="n1")
                core.traced_transfer(sess, "upload", ["/a"], "/b",
                                     node="n1")
            recs = tr.records()
        finally:
            tr.reset(enabled=False)
        return [(r.get("kind"), r.get("name"), r.get("attrs"))
                for r in recs]

    got = both(scen)
    assert ("remote", "remote.echo",
            {"cmd": "echo hi", "node": "n1", "sudo": "root",
             "exit": 0}) in got


# ---------------------------------------------------------------------------
# control/__init__.py: the DSL
# ---------------------------------------------------------------------------

def test_conn_spec_and_remote_for():
    def scen(pkg):
        c = pkg.control
        spec = c.conn_spec({"ssh": {"username": "u", "port": 2222}}, "n3")
        r = pkg.m("control.dummy").DummyRemote()
        return (spec, c.remote_for({"remote": r}) is r,
                type(c.remote_for({"ssh": {"dummy": True}})).__name__)

    got = both(scen)
    assert got[0]["host"] == "n3" and got[0]["port"] == 2222


@pytest.mark.parametrize("test_map", [{}, {"ssh": {}},
                                      {"ssh": {"username": "admin"}}])
def test_the_ssh_remote_is_refused(test_map):
    from jepsen_tpu_torch import control

    with pytest.raises(NotImplementedError, match="ROADMAP A3c"):
        control.remote_for(test_map)
    with pytest.raises(NotImplementedError, match="ROADMAP A3c"):
        control.session(test_map, "n1")
    with pytest.raises(NotImplementedError, match="ROADMAP A3c"):
        control.open_sessions(dict(test_map, nodes=["n1"]))


def test_su_cd_exec_upload_download():
    def body(pkg):
        c = pkg.control
        out = [c.exec_("echo", "a b")]
        with c.su():
            with c.cd("/opt"):
                with c.cd("db"):
                    out.append(c.exec_("ls", stdin="x", timeout=5.0))
                with c.cd("/abs"):
                    c.exec_("pwd")
            c.upload(["/local/f"], "/remote/f")
        c.download(["/remote/g"], "/local/g")
        res = c.exec_result("false")
        out.append((res.exit, res.out))
        out.append(str(c.current_node()))
        return out

    got = both(lambda pkg: on_n1(pkg, body))
    assert ("ls", "root", "/opt/db", "x", 5.0) in got[1]["n1"]
    assert ("pwd", "root", "/abs", None, 600.0) in got[1]["n1"]


def test_exec_raises_on_nonzero_exit():
    def scen(pkg):
        core = pkg.core

        def responder(node, action):
            return core.Result(exit=3, out="o", err="e", cmd=action.cmd)

        test = session_test(pkg, responder)
        with pkg.control.with_session(test, "n1"):
            with pytest.raises(core.RemoteError) as ei:
                pkg.control.exec_("boom")
        return (ei.value.exit, ei.value.out, ei.value.err, ei.value.cmd,
                ei.value.node)

    assert both(scen) == (3, "o", "e", "boom", "n1")


def test_current_session_outside_with_session_raises():
    from jepsen_tpu_torch import control

    with pytest.raises(RuntimeError, match="no ambient control session"):
        control.current_session()


def test_on_nodes_and_sessions():
    def scen(pkg):
        c = pkg.control
        dummy = pkg.m("control.dummy")
        test = {"nodes": ["n1", "n2", "n3"],
                "remote": dummy.DummyRemote(lambda n, a: f"up {n}")}
        test = c.open_sessions(test)
        res = c.on_nodes(test, lambda t, n: c.exec_("uptime"))
        sub = c.on_nodes(test, lambda t, n: c.exec_("date"), ["n2"])
        c.close_sessions(test)
        return res, sub, logs(test), sorted(test["sessions"])

    got = both(scen)
    assert got[0] == {"n1": "up n1", "n2": "up n2", "n3": "up n3"}
    assert got[1] == {"n2": "up n2"}


def test_with_session_opens_and_closes_its_own():
    def scen(pkg):
        dummy = pkg.m("control.dummy")
        test = {"nodes": ["n1"], "remote": dummy.DummyRemote()}
        with pkg.control.with_session(test, "n1") as sess:
            pkg.control.exec_("true")
            return [entry(a) for a in sess.log]

    assert both(scen) == [("true", None, None, None, 600.0)]


# ---------------------------------------------------------------------------
# control/util.py (tests/test_control_util.py)
# ---------------------------------------------------------------------------

def _fail_stat(pkg):
    core = pkg.core

    def responder(node, action):
        if action.cmd.startswith("stat"):
            return core.Result(exit=1, out="", err="no such file",
                               cmd=action.cmd)
        return None

    return responder


def test_grepkill_default_signal():
    got = both(lambda pkg: on_n1(pkg, lambda p: p.cu.grepkill("etcd")))
    assert ("pgrep -f --ignore-ancestors etcd | xargs "
            "--no-run-if-empty kill -9", None) in n1_cmds(got)


def test_grepkill_named_signal():
    def body(pkg):
        with pkg.control.su():
            pkg.cu.grepkill("etcd", "stop")

    got = both(lambda pkg: on_n1(pkg, body))
    assert ("pgrep -f --ignore-ancestors etcd | xargs "
            "--no-run-if-empty kill -STOP", "root") in n1_cmds(got)


def test_start_daemon():
    got = both(lambda pkg: on_n1(pkg, lambda p: p.cu.start_daemon(
        {"logfile": "/var/log/db.log", "pidfile": "/run/db.pid",
         "chdir": "/opt/db"}, "/opt/db/bin/db", "--port", 2379)))
    assert got[0] == "started"
    assert n1_cmds(got)[1][0] == (
        "start-stop-daemon --start --background --no-close "
        "--make-pidfile --exec /opt/db/bin/db --pidfile /run/db.pid "
        "--chdir /opt/db --startas /opt/db/bin/db -- --port 2379 "
        ">> /var/log/db.log 2>&1")


def test_start_daemon_env_and_name():
    got = both(lambda pkg: on_n1(pkg, lambda p: p.cu.start_daemon(
        {"logfile": "/l", "chdir": "/", "pidfile": None,
         "env": {"SEEDS": "flax"}, "match_process_name": True,
         "process_name": "dbd"}, "/bin/db")))
    assert n1_cmds(got)[1][0] == (
        "SEEDS=flax start-stop-daemon --start --background --no-close "
        "--exec /bin/db --name dbd --chdir / --startas /bin/db -- "
        ">> /l 2>&1")


def test_start_daemon_already_running():
    def scen(pkg):
        core = pkg.core

        def responder(node, action):
            if "start-stop-daemon" in action.cmd:
                return core.Result(exit=1, out="", err="", cmd=action.cmd)
            return None

        return on_n1(pkg, lambda p: p.cu.start_daemon(
            {"logfile": "/l", "chdir": "/"}, "/bin/db"), responder)

    assert both(scen)[0] == "already-running"


def test_stop_daemon_by_cmd_and_by_pidfile():
    def scen(pkg):
        a = on_n1(pkg, lambda p: p.cu.stop_daemon("etcd", "/run/etcd.pid"))
        b = on_n1(pkg, lambda p: p.cu.stop_daemon("/run/db.pid"),
                  lambda n, act: "4242" if act.cmd == "cat /run/db.pid"
                  else None)
        return a, b

    a, b = both(scen)
    assert ("killall -9 -w etcd", None) in n1_cmds(a)
    assert ("rm -rf /run/etcd.pid", None) in n1_cmds(a)
    assert ("kill -9 4242", None) in n1_cmds(b)


def test_write_file_uses_stdin():
    got = both(lambda pkg: on_n1(
        pkg, lambda p: p.cu.write_file("hello\nworld", "/etc/motd")))
    assert got[1]["n1"][0] == ("cat > /etc/motd", None, None,
                               "hello\nworld", 600.0)


def test_cached_wget_key_is_base64():
    import base64

    url = "https://example.com/v1.2/foo.tar"
    enc = base64.b64encode(url.encode()).decode()
    got = both(lambda pkg: on_n1(pkg, lambda p: p.cu.cached_wget(url),
                                 _fail_stat(pkg)))
    assert got[0] == f"/tmp/jepsen/wget-cache/{enc}"
    wgets = [c for c in got[1]["n1"] if c[0].startswith("wget")]
    assert len(wgets) == 1 and wgets[0][2] == "/tmp/jepsen/wget-cache"


def test_await_tcp_port_immediate():
    got = both(lambda pkg: on_n1(
        pkg, lambda p: p.cu.await_tcp_port(2379, timeout_secs=1)))
    assert ("nc -z localhost 2379", None) in n1_cmds(got)


def test_files_dirs_and_daemons():
    def body(pkg):
        cu = pkg.cu
        return (cu.file_p("/etc/x"), cu.exists_p("/etc/y"), cu.ls("/d"),
                cu.ls_full("/d"), cu.tmp_file(), cu.tmp_dir(),
                cu.expand_path("~/a"), cu.expand_path("/b"),
                cu.daemon_running("/run/db.pid"), cu.signal("db", "HUP"),
                cu.ensure_user("jepsen"), cu.wget("http://h/f.tgz"))

    def responder(node, action):
        if action.cmd.startswith("ls -A"):
            return "a\nb\n"
        if action.cmd == "cat /run/db.pid":
            return "77"
        if action.cmd.startswith("readlink"):
            return "/root/a"
        return None

    got = both(lambda pkg: on_n1(pkg, body, responder))
    assert got[0][:4] == (True, True, ["a", "b"], ["/d/a", "/d/b"])


def test_install_archive():
    def responder(node, action):
        if action.cmd.startswith("ls -A"):
            return "foolib-1.2.3"
        if action.cmd.startswith("dirname"):
            return "/opt"
        return None

    def scen(pkg):
        a = on_n1(pkg, lambda p: p.cu.install_archive(
            "file:///tmp/foo.tar.gz", "/opt/foo"), responder)
        b = on_n1(pkg, lambda p: p.cu.install_archive(
            "https://h/foo.zip", "/opt/foo"), responder)
        return a, b

    a, b = both(scen)
    assert a[0] == "/opt/foo"
    assert any(c[0].startswith("unzip") for c in b[1]["n1"])


# ---------------------------------------------------------------------------
# os_setup/ (tests/test_control_util.py Debian part, test_os_setup.py)
# ---------------------------------------------------------------------------

def debian_responder(installed=("wget", "curl"), last_update="999999"):
    sel = "\n".join(f"{p}\tinstall" for p in installed)

    def responder(node, action):
        cmd = action.cmd
        if cmd.startswith("cat /etc/hosts"):
            return "127.0.0.1\tlocalhost\n10.0.0.1\tn1"
        if cmd.startswith("date +%s"):
            return "1000000"
        if cmd.startswith("stat -c %Y"):
            return last_update
        if cmd.startswith("dpkg --get-selections"):
            return sel
        if cmd.startswith("apt-cache policy"):
            return "foo:\n  Installed: 1.0\n  Candidate: 2.0"
        return None

    return responder


def test_debian_setup_installs_missing():
    got = both(lambda pkg: on_n1(
        pkg, lambda p: p.m("os_setup.debian").Debian().setup(
            {"nodes": ["n1"], "net": None}, "n1"), debian_responder()))
    installs = [c for c, s in n1_cmds(got, "root") if "apt-get install" in c]
    assert len(installs) == 1 and "tcpdump" in installs[0]


@pytest.mark.parametrize("call", ["maybe_update", "install_pinned",
                                  "hostfile", "teardown", "uninstall"])
def test_debian_calls(call):
    def body(pkg):
        d = pkg.m("os_setup.debian")
        if call == "maybe_update":
            return d.maybe_update()
        if call == "install_pinned":
            return d.install({"foo": "2.0"})
        if call == "hostfile":
            return d.setup_hostfile()
        if call == "teardown":
            return d.Debian().teardown({"nodes": ["n1"]}, "n1")
        return d.uninstall(["wget", "nope"])

    got = both(lambda pkg: on_n1(pkg, body, debian_responder(
        last_update="0")))
    if call == "maybe_update":
        assert ("apt-get --allow-releaseinfo-change update", "root") in \
            n1_cmds(got)


@pytest.mark.parametrize("os_name", ["centos", "smartos", "ubuntu"])
def test_os_setup_commands(os_name):
    def scen(pkg):
        core = pkg.core

        def responder(node, action):
            if action.cmd.startswith("rpm -qa"):
                return core.Result(exit=0, out="wget\ncurl\n", err="",
                                   cmd=action.cmd)
            if action.cmd.startswith("pkgin -p list"):
                return core.Result(exit=0, out="curl-8.0\nwget-1.21\n",
                                   err="", cmd=action.cmd)
            if action.cmd.startswith("stat ") and os_name == "centos":
                return core.Result(exit=1, out="", err="absent",
                                   cmd=action.cmd)
            return debian_responder()(node, action)

        test = pkg.m("testing").noop_test()
        test.update(session_test(pkg, responder))
        with pkg.control.with_session(test, "n1"):
            pkg.m(f"os_setup.{os_name}").os.setup(test, "n1")
        return logs(test)

    got = both(scen)
    cmds = [c[0] for c in got["n1"]]
    if os_name == "centos":
        assert "gcc" in next(c for c in cmds if "yum -y install" in c)
    if os_name == "smartos":
        assert any("svcadm enable -r ipfilter" in c for c in cmds)


def test_centos_daemon_build_runs_in_workdir():
    got = both(lambda pkg: on_n1(
        pkg, lambda p: p.m("os_setup.centos").install_start_stop_daemon()))
    cp = next(c for c in got[1]["n1"] if c[0].startswith("cp "))
    assert cp[2] == "/tmp/jepsen/dpkg-build/dpkg-1.17.27"


# ---------------------------------------------------------------------------
# net.py (tests/test_net.py)
# ---------------------------------------------------------------------------

def net_responder(node, action):
    cmd = action.cmd
    if cmd.startswith("getent ahostsv4"):
        host = cmd.split()[-1]
        return f"10.0.0.{host[1:]}   STREAM {host}\n10.0.0.{host[1:]}   DGRAM"
    if cmd == "ip -o link show":
        return ("1: lo: <LOOPBACK,UP> mtu 65536\n"
                "2: eth0: <BROADCAST,MULTICAST,UP> mtu 1500")
    if cmd == "hostname -I":
        return f"10.9.9.{node[1:]} fe80::1"
    return None


NODES = ("n1", "n2", "n3", "n4", "n5")


def net_scenario(name):
    def scen(pkg):
        net = pkg.net
        net.clear_ip_cache()
        test = session_test(pkg, net_responder, NODES)
        if name == "drop":
            out = net.iptables.drop(test, "n1", "n2")
        elif name == "heal":
            out = net.iptables.heal(test)
        elif name == "drop_all":
            out = net.iptables.drop_all(
                test, {"n1": {"n2", "n3"}, "n2": {"n1"}, "n3": set()})
        elif name == "slow_flaky_fast":
            out = [net.iptables.slow(test),
                   net.iptables.slow(test, mean=100, variance=5,
                                     distribution="pareto"),
                   net.iptables.flaky(test), net.iptables.fast(test)]
        elif name == "shape":
            out = net.iptables.shape(test, ["n2"], {"delay": {}})
        elif name == "shape_reset":
            out = net.iptables.shape(test, [], {})
        elif name == "ipfilter":
            out = [net.ipfilter.drop(test, "n1", "n2"),
                   net.ipfilter.heal(test)]
        elif name == "noop":
            out = [net.noop.drop(test, "n1", "n2"), net.noop.heal(test),
                   net.noop.drop_all(test, {"n1": {"n2"}})]
        else:
            with pkg.control.with_session(test, "n1"):
                out = [net.ip("n3"), net.ip("n3"), net.local_ip(),
                       net.reachable("n2"), net.net_dev()]
        return out, logs(test)

    return scen


@pytest.mark.parametrize("name", ["drop", "heal", "drop_all",
                                  "slow_flaky_fast", "shape",
                                  "shape_reset", "ipfilter", "noop", "ip"])
def test_net_commands(name):
    out, got = both(net_scenario(name))
    cmds = {n: [(c[0], c[1]) for c in v] for n, v in got.items()}
    if name == "drop":
        assert ("iptables -A INPUT -s 10.0.0.1 -j DROP -w", "root") in \
            cmds["n2"]
    if name == "heal":
        assert all(("iptables -F -w", "root") in cmds[n] for n in NODES)
    if name == "shape":
        assert out[0] == "shaped"
    if name == "shape_reset":
        assert out[0] == "reliable" and [c for c, _ in cmds["n1"]] == [
            "ip -o link show", "/sbin/tc qdisc del dev eth0 root"]
    if name == "ip":
        assert out[:2] == ["10.0.0.3", "10.0.0.3"]
        assert sum(c.startswith("getent") for c, _ in cmds["n1"]) == 1


def test_net_drop_all_fallback_expands_pairs():
    def scen(pkg):
        calls = []

        class MinimalNet(pkg.net.Net):
            def drop(self, test, src, dest):
                calls.append((src, dest))

        MinimalNet().drop_all(session_test(pkg, None, NODES),
                              {"n1": ["n2", "n3"], "n2": ["n1"]})
        return sorted(calls)

    assert both(scen) == [("n1", "n2"), ("n2", "n1"), ("n3", "n1")]


@pytest.mark.parametrize("behaviors", [{"delay": {}}, {"rate": {}},
                                       {"loss": {"percent": "5%"}},
                                       {"reorder": {}},
                                       {"corrupt": {}, "duplicate": {},
                                        "delay": {"time": "9ms"}}])
def test_behaviors_to_netem(behaviors):
    both(lambda pkg: pkg.net.behaviors_to_netem(behaviors))


def test_ip_blank_raises_and_control_ip():
    def scen(pkg):
        test = session_test(pkg, None)
        with pkg.control.with_session(test, "n1"):
            with pytest.raises(pkg.net.BlankGetentIP):
                pkg.net.ip("n9")
        test = session_test(pkg, lambda n, a: "10.1.1.1 5555 22")
        with pkg.control.with_session(test, "n1"):
            return pkg.net.control_ip()

    assert both(scen) == "10.1.1.1"


def test_ip_caches_are_the_modules_own():
    from jepsen_tpu import net as jnet
    from jepsen_tpu_torch import net as pnet

    test = session_test(Pkg("jepsen_tpu_torch"), net_responder)
    from jepsen_tpu_torch import control

    with control.with_session(test, "n1"):
        assert pnet.ip("n4") == "10.0.0.4"
    assert pnet._ip_cache == {"n4": "10.0.0.4"}
    assert "n4" not in jnet._ip_cache
    pnet.clear_ip_cache()
    assert pnet._ip_cache == {}
