"""Raftis (redis + raft) test suite: a linearizable register and a
counter over redis-cli.

Capability reference: raftis/src/jepsen/raftis.clj — tarball install
with the host:8901 initial-cluster string (70-100), a read/write
register client over the redis protocol with no-leader/socket errors
mapped to definite fails and indeterminate writes to info (28-62),
partitions + linearizable checking (the reference's test map). The
reference links the carmine redis client into the JVM; here ops run
`redis-cli` on the node over the control plane. Beyond the
reference's register, the suite also exercises the counter checker
through INCRBY/DECRBY — atomic in redis, so the counter's bounds
hold on a healthy cluster.

The port's copy of jepsen_tpu/suites/raftis.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging
import random

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "v1.0"
DIR = "/opt/raftis"
BINARY = f"{DIR}/raftis"
LOGFILE = f"{DIR}/raftis.log"
PIDFILE = f"{DIR}/raftis.pid"
PORT = 6379
PEER_PORT = 8901


def initial_cluster(test) -> str:
    """node:8901,... (raftis.clj initial-cluster, 73-80)."""
    return ",".join(f"{n}:{PEER_PORT}" for n in test["nodes"])


class RaftisDB(jdb.DB):
    """Tarball install + daemon with the peer cluster string
    (raftis.clj db, 83-110)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, test, node):
        cu.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            BINARY,
            "--cluster", initial_cluster(test),
            "--local_ip", str(node),
            "--local_port", str(PEER_PORT),
            "--listen_port", str(PORT))

    def setup(self, test, node):
        logger.info("%s installing raftis %s", node, self.version)
        with control.su():
            debian.install(["redis-tools"])  # the client transport
            url = (f"https://github.com/PikaLabs/floyd/releases/"
                   f"download/{self.version}/raftis-"
                   f"{self.version}.tar.gz")
            cu.install_archive(url, DIR)
            self._start(test, node)
        cu.await_tcp_port(PORT, timeout_secs=60)

    def teardown(self, test, node):
        logger.info("%s tearing down raftis", node)
        with control.su():
            cu.stop_daemon(BINARY, PIDFILE)
            control.exec_("rm", "-rf", DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("raftis")
        return "killed"

    def start(self, test, node):
        with control.su():
            self._start(test, node)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# redis-cli transport
# ---------------------------------------------------------------------------

class RedisCli:
    """One redis-cli command on the node. Split out so tests can stub
    `run`.

    Uses a NON-retrying session: SET/INCRBY are not idempotent, and
    the default control stack's transport retry would re-execute a
    command whose connection dropped AFTER it ran — double-applying an
    increment the history records once (the same double-execution
    hazard control/ssh.py's timeout path documents)."""

    def __init__(self, test, node, timeout: float = 5.0):
        self.test = test
        self.node = node
        self.timeout = timeout
        self.sess = self._session(test, node)

    @staticmethod
    def _session(test, node):
        if test.get("remote") is not None or \
                (test.get("ssh") or {}).get("dummy"):
            return control.session(test, node)
        from ..control.scp import ScpRemote
        from ..control.ssh import SshRemote

        return ScpRemote(SshRemote()).connect(
            control.conn_spec(test, node))

    def run(self, *args) -> str:
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_("redis-cli", "-h", str(self.node),
                                 "-p", str(PORT), *args,
                                 timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


_DEFINITE = ("no leader", "socket closed", "connection refused",
             "could not connect")

# redis error replies arrive on stdout with exit 0; NON-tty redis-cli
# (what exec gives us) prints them raw, tty mode wraps them in
# "(error) ..." — accept both
_ERROR_PREFIXES = ("(error)", "ERR ", "-ERR", "WRONGTYPE", "MOVED",
                   "CLUSTERDOWN", "LOADING", "NOAUTH", "READONLY")


class _ErrorReply(Exception):
    """The server REJECTED the command — it definitely did not apply
    (the reference's no-leader -> :fail mapping generalized)."""


def _reply(out: str) -> str:
    s = out.strip()
    if s.startswith(_ERROR_PREFIXES):
        raise _ErrorReply(s)
    return s


def _classify(op, e: Exception):
    if isinstance(e, _ErrorReply):
        return op.copy(type="fail", error=str(e)[:200])
    msg = f"{getattr(e, 'err', '')} {getattr(e, 'out', '')} {e}".lower()
    if op.f == "read" or any(m in msg for m in _DEFINITE):
        return op.copy(type="fail", error=msg.strip()[:200])
    return op.copy(type="info", error=msg.strip()[:200])


class RaftisRegisterClient(jclient.Client):
    """Read/write register at key "r" (raftis.clj client, 28-62).
    redis-cli prints errors like "(error) ERR ..." on stdout with exit
    0, so replies are checked, not just exit codes."""

    def __init__(self, cli_factory=RedisCli):
        self.cli_factory = cli_factory
        self.cli = None

    def open(self, test, node):
        c = RaftisRegisterClient(self.cli_factory)
        c.cli = self.cli_factory(test, node)
        return c

    def close(self, test):
        if self.cli is not None:
            self.cli.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = _reply(self.cli.run("GET", "r"))
                return op.copy(type="ok",
                               value=int(out) if out else None)
            if op.f == "write":
                out = _reply(self.cli.run("SET", "r", str(op.value)))
                if out != "OK":
                    # unrecognized non-OK reply: indeterminate
                    raise RemoteError("unexpected SET reply", exit=0,
                                      out=out, err="", cmd="SET",
                                      node=None)
                return op.copy(type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except (RemoteError, _ErrorReply) as e:
            return _classify(op, e)


class RaftisCounterClient(jclient.Client):
    """Counter at key "c": INCRBY/DECRBY are atomic; reads report the
    current value for checker.counter's concurrent-bounds analysis."""

    def __init__(self, cli_factory=RedisCli):
        self.cli_factory = cli_factory
        self.cli = None

    def open(self, test, node):
        c = RaftisCounterClient(self.cli_factory)
        c.cli = self.cli_factory(test, node)
        return c

    def close(self, test):
        if self.cli is not None:
            self.cli.close()

    def invoke(self, test, op):
        try:
            if op.f == "add":
                delta = int(op.value)
                cmd = ("INCRBY", "c", str(delta)) if delta >= 0 \
                    else ("DECRBY", "c", str(-delta))
                out = _reply(self.cli.run(*cmd))
                if not out.lstrip("-").isdigit():
                    raise RemoteError("unexpected reply", exit=0,
                                      out=out, err="", cmd=cmd[0],
                                      node=None)
                return op.copy(type="ok")
            if op.f == "read":
                out = _reply(self.cli.run("GET", "c"))
                return op.copy(type="ok",
                               value=int(out) if out else 0)
            raise ValueError(f"unknown f {op.f!r}")
        except (RemoteError, _ErrorReply) as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    rng = random.Random(opts.get("seed"))

    def one():
        if rng.random() < 0.5:
            return {"f": "read", "value": None}
        return {"f": "write", "value": rng.randrange(5)}

    return {
        "client": RaftisRegisterClient(),
        "generator": gen.limit(opts.get("ops", 500), one),
        "checker": chk.linearizable(
            {"model": models.register(),
             "device": opts.get("device")}),
    }


def counter_workload(opts: dict) -> dict:
    from ..workloads import counter

    w = counter.workload({"ops": opts.get("ops", 500),
                          "seed": opts.get("seed")})
    w["client"] = RaftisCounterClient()
    return w


WORKLOADS = {"register": register_workload,
             "counter": counter_workload}


def raftis_test(opts: dict) -> dict:
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"raftis-{name}",
        os=debian.os,
        db=RaftisDB(opts.get("version", VERSION)),
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        nemesis=jnemesis.partition_random_halves(),
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=gen.time_limit(
            opts.get("time_limit", 30),
            gen.clients(
                gen.stagger(1.0 / opts.get("rate", 20),
                            w["generator"]),
                jnemesis.start_stop_cycle(10.0))))
    return test


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default register). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="raftis release tag to install.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(raftis_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
