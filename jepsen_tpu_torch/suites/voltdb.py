"""VoltDB test suite: linearizable per-key registers and dirty-read
detection over sqlcmd against a k-safe cluster.

Capability reference: voltdb/src/jepsen/voltdb.clj (tarball install to
/opt/voltdb, a generated deployment.xml carrying sitesperhost +
kfactor, `voltdb create --deployment --host <primary>` on every node,
await the client port), single.clj (single-partition register table,
read/write/cas per independent key — CAS is a guarded UPDATE whose
modified-tuple count decides ok/fail), and dirty_read.clj (writers
insert, readers probe the in-flight row single-partition, and after
healing every client takes a multi-partition strong read; a value some
read saw that no strong read contains was a dirty read). The reference
drives the Java client; here every transaction is one sqlcmd batch on
the client's own node with tagged SELECTs carrying read results (the
tidb/galera transport stance — VoltDB speaks SQL over sqlcmd, and
its DML results arrive as modified-tuple counts).

The port's copy of jepsen_tpu/suites/voltdb.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging
import re

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb, independent
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing, workloads
from . import common
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "6.8"
DIR = "/opt/voltdb"
CLIENT_PORT = 21212
HTTP_PORT = 8080
DEPLOYMENT = f"{DIR}/deployment.xml"
LOGFILE = f"{DIR}/stdout.log"
PIDFILE = f"{DIR}/voltdb.pid"


def deployment_xml(kfactor: int, sites_per_host: int = 2) -> str:
    """voltdb.clj deployment: k-safety + command logging, so a killed
    node replays its journal instead of forgetting acked writes."""
    return (
        "<?xml version=\"1.0\"?>\n"
        f"<deployment>\n"
        f"  <cluster sitesperhost=\"{sites_per_host}\" "
        f"kfactor=\"{kfactor}\" />\n"
        "  <commandlog enabled=\"true\" synchronous=\"true\">\n"
        "    <frequency time=\"2\" />\n"
        "  </commandlog>\n"
        "</deployment>\n")


class VoltdbDB(jdb.DB):
    """Tarball install + `voltdb create` on every node
    (voltdb.clj:40-120); the primary loads the schema once."""

    supports_kill = True

    def __init__(self, version: str = VERSION, kfactor: int | None = None):
        self.version = version
        self.kfactor = kfactor

    def _kfactor(self, test) -> int:
        # k-safety defaults to tolerating a minority (voltdb.clj)
        if self.kfactor is not None:
            return self.kfactor
        return max(0, (len(test["nodes"]) - 1) // 2)

    def _start(self, test, node):
        cu.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            f"{DIR}/bin/voltdb", "create",
            "--deployment", DEPLOYMENT,
            "--host", str(primary(test)))
        cu.await_tcp_port(CLIENT_PORT, timeout_secs=180)

    def setup(self, test, node):
        logger.info("%s installing voltdb %s", node, self.version)
        with control.su():
            debian.install(["openjdk-8-jdk"])
            url = (f"https://downloads.voltdb.com/technologies/server/"
                   f"voltdb-community-{self.version}.tar.gz")
            cu.install_archive(url, DIR)
            control.exec_("bash", "-c",
                          f"cat > {DEPLOYMENT} <<'EOF'\n"
                          f"{deployment_xml(self._kfactor(test))}EOF")
            self._start(test, node)
        from .. import core

        core.synchronize(test)
        if node == primary(test):
            self._schema(node)
        core.synchronize(test)

    def _schema(self, node):
        stmts = [
            "CREATE TABLE registers (id INTEGER NOT NULL, "
            "value INTEGER NOT NULL, PRIMARY KEY (id));",
            "PARTITION TABLE registers ON COLUMN id;",
            "CREATE TABLE dirty_reads (id INTEGER NOT NULL, "
            "PRIMARY KEY (id));",
            "PARTITION TABLE dirty_reads ON COLUMN id;",
        ]
        control.exec_(f"{DIR}/bin/sqlcmd", f"--servers={node}",
                      "--query=" + " ".join(stmts))

    def teardown(self, test, node):
        logger.info("%s tearing down voltdb", node)
        with control.su():
            cu.grepkill("org.voltdb.VoltDB")
            control.exec_("rm", "-rf", DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("org.voltdb.VoltDB")
        return "killed"

    def start(self, test, node):
        with control.su():
            self._start(test, node)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE, f"{DIR}/voltdbroot/log/volt.log"]


# ---------------------------------------------------------------------------
# sqlcmd transport
# ---------------------------------------------------------------------------

class VoltSql(common.SqlCli):
    """sqlcmd batches against the node's own server. sqlcmd takes the
    statement list as one --query= token, so run() folds the batch into
    the final argv element instead of appending it."""

    def __init__(self, test, node, timeout: float = 10.0):
        super().__init__(
            test, node,
            [f"{DIR}/bin/sqlcmd", f"--servers={node}",
             "--output-skip-metadata", "--query="],
            timeout=timeout)

    def run(self, sql: str) -> str:
        argv = self.argv[:-1] + [self.argv[-1] + sql]
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_(*argv, timeout=self.timeout)


_classify = common.make_classifier([
    r"connection refused", r"no connections", r"server is paused",
    r"unable to connect", r"connection to database host"])


def _count(out: str) -> int:
    """The modified-tuple count a DML statement prints as its result
    row (the first bare integer line; voltdb surfaces DML results as
    one-column counts)."""
    for line in out.splitlines():
        s = line.strip()
        if re.fullmatch(r"-?\d+", s):
            return int(s)
    return 0


class VoltRegisterClient(jclient.Client):
    """Independent-key read/write/cas on the partitioned registers
    table (single.clj). CAS is the guarded single-partition UPDATE;
    its modified count decides ok vs fail."""

    def __init__(self, sql_factory=VoltSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = VoltRegisterClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        k, v = independent.key_(op.value), independent.value_(op.value)
        try:
            if op.f == "read":
                out = self.sql.run(
                    "SELECT 'v=' || CAST(value AS VARCHAR) FROM "
                    f"registers WHERE id = {int(k)};")
            elif op.f == "write":
                self.sql.run(
                    f"UPSERT INTO registers (id, value) VALUES "
                    f"({int(k)}, {int(v)});")
                return op.copy(type="ok")
            elif op.f == "cas":
                old, new = v
                out = self.sql.run(
                    f"UPDATE registers SET value = {int(new)} WHERE "
                    f"id = {int(k)} AND value = {int(old)};")
                return op.copy(
                    type="ok" if _count(out) > 0 else "fail",
                    error=None if _count(out) > 0 else "cas mismatch")
            else:
                raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)
        # parse OUTSIDE the error net: a corrupt value is evidence
        m = re.search(r"v=(-?\d+)", out)
        return op.copy(type="ok", value=independent.ktuple(
            k, int(m.group(1)) if m else None))


class VoltDirtyReadClient(jclient.Client):
    """dirty_read.clj contract: write inserts the row, read probes it
    single-partition (ok iff visible), strong-read scans the whole
    table multi-partition. refresh is a no-op ack — VoltDB commits are
    immediately visible on the partition owner; the phase exists for
    generator parity with the eventually-consistent suites."""

    def __init__(self, sql_factory=VoltSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = VoltDirtyReadClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "write":
                out = self.sql.run(
                    "INSERT INTO dirty_reads (id) VALUES "
                    f"({int(op.value)});")
                return op.copy(
                    type="ok" if _count(out) > 0 else "fail")
            if op.f == "read":
                out = self.sql.run(
                    "SELECT 'v=' || CAST(id AS VARCHAR) FROM "
                    f"dirty_reads WHERE id = {int(op.value)};")
                seen = re.search(r"v=(-?\d+)", out) is not None
                return op.copy(type="ok" if seen else "fail")
            if op.f == "refresh":
                return op.copy(type="ok")
            if op.f == "strong-read":
                out = self.sql.run(
                    "SELECT 'i=' || CAST(id AS VARCHAR) FROM "
                    "dirty_reads ORDER BY id;")
                vals = sorted(int(m.group(1)) for m in
                              re.finditer(r"i=(-?\d+)", out))
                return op.copy(type="ok", value=vals)
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    """Linearizable reads/writes/cas per independent key
    (single.clj workload)."""
    import random

    rng = random.Random(opts.get("seed"))
    keys = list(range(opts.get("keys", 4)))

    def key_gen(_k):
        return gen.limit(
            opts.get("ops_per_key", 200),
            gen.mix([lambda: {"f": "read", "value": None},
                     lambda: {"f": "write",
                              "value": rng.randrange(5)},
                     lambda: {"f": "cas",
                              "value": [rng.randrange(5),
                                        rng.randrange(5)]}]))

    return {
        "client": VoltRegisterClient(),
        "generator": independent.concurrent_generator(
            opts["concurrency"], keys, key_gen),
        "checker": independent.checker(chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")})),
    }


def dirty_read_workload(opts: dict) -> dict:
    w = workloads.dirty_read.workload(dict(opts))
    w["client"] = VoltDirtyReadClient()
    return w


WORKLOADS = {"register": register_workload,
             "dirty-read": dirty_read_workload}


def voltdb_test(opts: dict) -> dict:
    """Test map from CLI options (jepsen.voltdb/voltdb-test)."""
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    db = VoltdbDB(opts.get("version", VERSION),
                  kfactor=opts.get("kfactor"))
    main = gen.time_limit(
        opts.get("time_limit", 30),
        gen.clients(
            gen.stagger(1.0 / opts.get("rate", 10), w["generator"]),
            jnemesis.start_stop_cycle(10.0)))
    phases = [main,
              gen.nemesis(gen.once({"type": "info", "f": "stop"})),
              gen.sleep(opts.get("recovery_time", 10))]
    if w.get("final_generator"):
        phases.append(gen.clients(w["final_generator"]))
    test = testing.noop_test()
    test.update(
        name=f"voltdb-{name}",
        os=debian.os,
        db=db,
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        nemesis=jnemesis.partition_random_halves(),
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=gen.phases(*phases))
    return test


def _opts(p):
    p.add_argument("--workload", default="register",
                   help="Workload. " + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="voltdb community version to install.")
    p.add_argument("--rate", type=float, default=10)
    p.add_argument("--kfactor", type=int, default=None,
                   help="k-safety factor (default: tolerate a "
                        "minority).")
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(voltdb_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
