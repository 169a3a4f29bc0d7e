"""Disque (the redis-family distributed message broker) test suite:
queue conservation over the `disque` CLI.

Capability reference: jepsen's disque test (aphyr/jepsen disque/src/
jepsen/disque.clj) — source build + disque-server daemon, cluster-meet
topology from the primary, an enqueue/dequeue/drain client over the
disque protocol with ADDJOB/GETJOB/ACKJOB, and total-queue checking
under partitions. The reference links the jedisque JVM client; here
ops run the bundled `disque` CLI on the node over the control plane,
the same transport pattern as the raftis suite. Every dequeue ACKs the
job it fetched — an unacked GETJOB is redelivered by design, so a
crashed dequeue yields a duplicate (visible to total-queue) rather
than a lost message.

The port's copy of jepsen_tpu/suites/disque.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing
from ..control import util as cu
from ..control.core import RemoteError
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "1.0-rc1"
DIR = "/opt/disque"
BINARY = f"{DIR}/src/disque-server"
CLI_BIN = f"{DIR}/src/disque"
LOGFILE = f"{DIR}/disque.log"
PIDFILE = f"{DIR}/disque.pid"
PORT = 7711
QUEUE = "jepsen"


class DisqueDB(jdb.DB):
    """Source build + daemon + cluster meet (disque.clj db)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, test, node):
        cu.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            BINARY,
            "--port", str(PORT),
            "--appendonly", "yes",
            "--appendfsync", "everysec")

    def setup(self, test, node):
        logger.info("%s installing disque %s", node, self.version)
        with control.su():
            debian.install(["build-essential"])
            url = (f"https://github.com/antirez/disque/archive/"
                   f"refs/tags/{self.version}.tar.gz")
            cu.install_archive(url, DIR)
            with control.cd(DIR):
                control.exec_("make")
            self._start(test, node)
        cu.await_tcp_port(PORT, timeout_secs=60)
        # mesh the cluster: every node meets every other (the
        # reference meets from one node; symmetric meets converge to
        # the same gossip view and need no primary election)
        for other in test["nodes"]:
            if str(other) != str(node):
                control.exec_(CLI_BIN, "-p", str(PORT),
                              "cluster", "meet", str(other),
                              str(PORT))

    def teardown(self, test, node):
        logger.info("%s tearing down disque", node)
        with control.su():
            cu.stop_daemon(BINARY, PIDFILE)
            control.exec_("rm", "-rf", DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("disque-server")
        return "killed"

    def start(self, test, node):
        with control.su():
            self._start(test, node)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# disque CLI transport
# ---------------------------------------------------------------------------

class DisqueCli:
    """One `disque` CLI command on the node. Split out so tests can
    stub `run`. Non-retrying session: ADDJOB is not idempotent — a
    transport retry after the broker accepted the job double-enqueues
    a message the history records once (the raftis RedisCli
    rationale)."""

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
            return control.exec_(CLI_BIN, "-p", str(PORT), *args,
                                 timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


_DEFINITE = ("noreplica", "connection refused", "could not connect",
             "pausing", "loading")

_ERROR_PREFIXES = ("(error)", "ERR ", "-ERR", "NOREPLICA", "PAUSED",
                   "LOADING", "BUSYKEY")


class _ErrorReply(Exception):
    """The broker REJECTED the command — it definitely did not apply."""


def _reply(out: str) -> str:
    s = out.strip()
    if s.startswith(_ERROR_PREFIXES):
        raise _ErrorReply(s)
    return s


def _classify(op, e: Exception):
    if isinstance(e, _ErrorReply):
        return op.copy(type="fail", error=str(e)[:200])
    msg = f"{getattr(e, 'err', '')} {getattr(e, 'out', '')} {e}".lower()
    if any(m in msg for m in _DEFINITE):
        return op.copy(type="fail", error=msg.strip()[:200])
    return op.copy(type="info", error=msg.strip()[:200])


class DisqueQueueClient(jclient.Client):
    """enqueue -> ADDJOB, dequeue -> GETJOB + ACKJOB, drain -> GETJOB
    until empty (disque.clj client). An indeterminate dequeue whose
    GETJOB fetched but whose ACK was lost redelivers — total-queue
    reports it as duplicated, never lost."""

    def __init__(self, cli_factory=DisqueCli):
        self.cli_factory = cli_factory
        self.cli = None

    def open(self, test, node):
        c = DisqueQueueClient(self.cli_factory)
        c.cli = self.cli_factory(test, node)
        return c

    def close(self, test):
        if self.cli is not None:
            self.cli.close()

    def _getjob(self):
        """One GETJOB NOHANG: (job-id, value) or None when the queue
        is (locally) empty. The CLI prints queue/id/body lines."""
        out = _reply(self.cli.run("getjob", "nohang", "count", "1",
                                  "from", QUEUE))
        lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        if len(lines) < 3:
            return None
        jid, body = lines[1], lines[2]
        return jid, int(body.strip('"'))

    def invoke(self, test, op):
        try:
            if op.f == "enqueue":
                jid = _reply(self.cli.run("addjob", QUEUE,
                                          str(op.value), "100"))
                if not jid.startswith(("DI", "D-")):
                    raise RemoteError("unexpected ADDJOB reply",
                                      exit=0, out=jid, err="",
                                      cmd="addjob", node=None)
                return op.copy(type="ok")
            if op.f == "dequeue":
                got = self._getjob()
                if got is None:
                    return op.copy(type="fail", error="empty")
                jid, value = got
                _reply(self.cli.run("ackjob", jid))
                return op.copy(type="ok", value=value)
            if op.f == "drain":
                out = []
                while True:
                    got = self._getjob()
                    if got is None:
                        return op.copy(type="ok", value=out)
                    jid, value = got
                    _reply(self.cli.run("ackjob", jid))
                    out.append(value)
            raise ValueError(f"unknown f {op.f!r}")
        except (RemoteError, _ErrorReply, ValueError) as e:
            if isinstance(e, ValueError) and "unknown f" in str(e):
                raise
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def queue_workload(opts: dict) -> dict:
    from ..workloads import queue

    w = queue.workload({"ops": opts.get("ops", 500)})
    w["client"] = DisqueQueueClient()
    return w


WORKLOADS = {"queue": queue_workload}


def disque_test(opts: dict) -> dict:
    name = opts.get("workload") or "queue"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"disque-{name}",
        os=debian.os,
        db=DisqueDB(opts.get("version", VERSION)),
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        nemesis=jnemesis.partition_random_halves(),
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        # the queue workload's generator already ends in its own
        # drain phase; the time limit brackets everything (a run cut
        # before the drain degrades honestly to valid? unknown)
        generator=gen.time_limit(
            opts.get("time_limit", 30),
            gen.clients(
                gen.stagger(1.0 / opts.get("rate", 20),
                            w["generator"]),
                jnemesis.start_stop_cycle(10.0))))
    return test


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default queue). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="disque release tag to build.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(disque_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    commands.update(cli.coverage_cmd(list(WORKLOADS)))
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
