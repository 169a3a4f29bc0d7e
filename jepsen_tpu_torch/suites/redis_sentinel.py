"""Redis + Sentinel test suite: a CAS register across sentinel-driven
failover.

Capability reference: the original aphyr/jepsen redis test
(redis/src/jepsen/redis.clj and the "Redis" Jepsen post) — one master,
N-1 replicas, a sentinel quorum promoting a replica when the master is
partitioned away, and a linearizable-register workload that catches
the split-brain window where acknowledged writes to the old master are
discarded on failover. The reference drives carmine from the JVM; here
ops run `redis-cli` on the node over the control plane (the raftis
suite's transport pattern), with CAS made atomic server-side via a
tiny EVAL script — redis has no native CAS, and a WATCH/MULTI pair
over two CLI invocations would not be one operation.

Clients discover the current master through their LOCAL sentinel
(`SENTINEL get-master-addr-by-name`), re-resolving once when a command
bounces off a READONLY replica — exactly how a sentinel-aware client
library behaves.

The port's copy of jepsen_tpu/suites/redis_sentinel.py: the same host code, with
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

DIR = "/opt/redis-sentinel"
CONF = f"{DIR}/redis.conf"
SENTINEL_CONF = f"{DIR}/sentinel.conf"
LOGFILE = f"{DIR}/redis.log"
SENTINEL_LOG = f"{DIR}/sentinel.log"
PIDFILE = f"{DIR}/redis.pid"
SENTINEL_PID = f"{DIR}/sentinel.pid"
PORT = 6379
SENTINEL_PORT = 26379
MASTER_NAME = "jepsen"

# server-side CAS: atomic because EVAL runs exclusively
CAS_LUA = ("if redis.call('GET', KEYS[1]) == ARGV[1] then "
           "redis.call('SET', KEYS[1], ARGV[2]); return 1 "
           "else return 0 end")


def primary_node(test):
    return str(test["nodes"][0])


class RedisSentinelDB(jdb.DB):
    """apt install + a replica-of-the-first-node topology + one
    sentinel per node monitoring it (redis.clj db): the sentinels form
    the failover quorum the partitions attack."""

    supports_kill = True

    def _start(self, test, node):
        cu.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            "/usr/bin/redis-server", CONF)
        cu.start_daemon(
            {"logfile": SENTINEL_LOG, "pidfile": SENTINEL_PID,
             "chdir": DIR},
            "/usr/bin/redis-server", SENTINEL_CONF, "--sentinel")

    def setup(self, test, node):
        logger.info("%s installing redis + sentinel", node)
        primary = primary_node(test)
        quorum = len(test["nodes"]) // 2 + 1
        with control.su():
            debian.install(["redis-server", "redis-sentinel",
                            "redis-tools"])
            # the distro units would fight our daemons for the ports
            control.exec_("systemctl", "stop", "redis-server",
                          check=False)
            control.exec_("systemctl", "stop", "redis-sentinel",
                          check=False)
            control.exec_("mkdir", "-p", DIR)
            conf = [f"port {PORT}", "bind 0.0.0.0",
                    "protected-mode no", f"dir {DIR}",
                    "appendonly yes", "appendfsync everysec"]
            if str(node) != primary:
                conf.append(f"replicaof {primary} {PORT}")
            cu.write_file("\n".join(conf) + "\n", CONF)
            sent = [f"port {SENTINEL_PORT}", "bind 0.0.0.0",
                    "protected-mode no", f"dir {DIR}",
                    f"sentinel monitor {MASTER_NAME} {primary} "
                    f"{PORT} {quorum}",
                    f"sentinel down-after-milliseconds {MASTER_NAME} "
                    "5000",
                    f"sentinel failover-timeout {MASTER_NAME} 10000",
                    f"sentinel parallel-syncs {MASTER_NAME} 1"]
            cu.write_file("\n".join(sent) + "\n", SENTINEL_CONF)
            self._start(test, node)
        cu.await_tcp_port(PORT, timeout_secs=60)
        cu.await_tcp_port(SENTINEL_PORT, timeout_secs=60)

    def teardown(self, test, node):
        logger.info("%s tearing down redis + sentinel", node)
        with control.su():
            cu.stop_daemon("/usr/bin/redis-server", SENTINEL_PID)
            cu.stop_daemon("/usr/bin/redis-server", PIDFILE)
            control.exec_("rm", "-rf", DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("redis-server")
        return "killed"

    def start(self, test, node):
        with control.su():
            self._start(test, node)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE, SENTINEL_LOG]


# ---------------------------------------------------------------------------
# redis-cli transport with sentinel master discovery
# ---------------------------------------------------------------------------

class SentinelCli:
    """redis-cli against the CURRENT master, resolved through the
    node's local sentinel. Split out so tests can stub `run`.
    Non-retrying session: SET/EVAL are not idempotent (the raftis
    RedisCli rationale)."""

    def __init__(self, test, node, timeout: float = 5.0):
        self.test = test
        self.node = node
        self.timeout = timeout
        self.master = None  # (host, port), lazily resolved
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

    def _cli(self, host, port, *args) -> str:
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_("redis-cli", "-h", str(host), "-p",
                                 str(port), *args,
                                 timeout=self.timeout)

    def resolve_master(self) -> tuple:
        out = self._cli(self.node, SENTINEL_PORT, "SENTINEL",
                        "get-master-addr-by-name", MASTER_NAME)
        lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        if len(lines) < 2:
            raise RemoteError("sentinel knows no master", exit=0,
                              out=out, err="", cmd="SENTINEL",
                              node=self.node)
        self.master = (lines[0], int(lines[1]))
        return self.master

    def run(self, *args) -> str:
        if self.master is None:
            self.resolve_master()
        return self._cli(self.master[0], self.master[1], *args)

    def forget_master(self) -> None:
        self.master = None

    def close(self):
        control.disconnect(self.sess)


_DEFINITE = ("connection refused", "could not connect", "no route",
             "name or service not known", "knows no master")

_ERROR_PREFIXES = ("(error)", "ERR ", "-ERR", "WRONGTYPE", "LOADING",
                   "MASTERDOWN", "NOAUTH", "READONLY", "NOREPLICAS")


class _ErrorReply(Exception):
    """The server REJECTED the command — it definitely did not
    apply."""


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
        # reads are safe to fail; refused connections never applied
        return op.copy(type="fail", error=msg.strip()[:200])
    return op.copy(type="info", error=msg.strip()[:200])


class SentinelRegisterClient(jclient.Client):
    """CAS register at key "r" on the sentinel-resolved master. A
    command bouncing off a READONLY replica (stale master view after a
    failover) re-resolves ONCE and retries — still one history op,
    because the READONLY bounce provably did not apply."""

    def __init__(self, cli_factory=SentinelCli):
        self.cli_factory = cli_factory
        self.cli = None

    def open(self, test, node):
        c = SentinelRegisterClient(self.cli_factory)
        c.cli = self.cli_factory(test, node)
        return c

    def close(self, test):
        if self.cli is not None:
            self.cli.close()

    def _run(self, *args) -> str:
        try:
            return _reply(self.cli.run(*args))
        except _ErrorReply as e:
            if not str(e).startswith("READONLY"):
                raise
            # stale master: the replica REFUSED the write (nothing
            # applied), so one re-resolve + retry is sound
            self.cli.forget_master()
            return _reply(self.cli.run(*args))

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self._run("GET", "r")
                return op.copy(type="ok",
                               value=int(out) if out else None)
            if op.f == "write":
                out = self._run("SET", "r", str(op.value))
                if out != "OK":
                    raise RemoteError("unexpected SET reply", exit=0,
                                      out=out, err="", cmd="SET",
                                      node=None)
                return op.copy(type="ok")
            if op.f == "cas":
                frm, to = op.value
                out = self._run("EVAL", CAS_LUA, "1", "r", str(frm),
                                str(to))
                if out not in ("0", "1"):
                    raise RemoteError("unexpected EVAL reply", exit=0,
                                      out=out, err="", cmd="EVAL",
                                      node=None)
                return op.copy(type="ok" if out == "1" else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except (RemoteError, _ErrorReply) as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    rng = random.Random(opts.get("seed"))

    def one():
        r = rng.random()
        if r < 0.4:
            return {"f": "read", "value": None}
        if r < 0.7:
            return {"f": "write", "value": rng.randrange(5)}
        return {"f": "cas", "value": [rng.randrange(5),
                                      rng.randrange(5)]}

    return {
        "client": SentinelRegisterClient(),
        "generator": gen.limit(opts.get("ops", 500), one),
        "checker": chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")}),
    }


WORKLOADS = {"register": register_workload}


def redis_sentinel_test(opts: dict) -> dict:
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"redis-sentinel-{name}",
        os=debian.os,
        db=RedisSentinelDB(),
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        # the reference's shape: partition the master away from the
        # sentinel majority and watch the failover window
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
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(redis_sentinel_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    commands.update(cli.coverage_cmd(list(WORKLOADS)))
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
