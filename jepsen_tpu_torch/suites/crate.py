"""CrateDB test suite: a CAS register over the HTTP `_sql` endpoint.

Capability reference: aphyr/jepsen crate (crate/src/jepsen/crate.clj
and the "Crate 0.54.9 version divergence" analysis) — a tarball
install with unicast discovery, an Elasticsearch-backed SQL layer, and
a register workload using Crate's optimistic concurrency (`_version`)
that exposed dirty reads and lost updates under partition. The
reference drives the Java client; here every op is one `curl` POST to
the node's `_sql` endpoint over the control plane (the CLI-transport
pattern of the raftis/disque suites), with conditional UPDATEs
standing in for the version-guarded writes.

Crate reads are eventually visible without an explicit `REFRESH
TABLE`, so the client refreshes before every read — the reference does
the same; without it, stale reads are a client artifact, not a
database anomaly.

The port's copy of jepsen_tpu/suites/crate.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import json
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

VERSION = "5.7.2"
DIR = "/opt/crate"
LOGFILE = f"{DIR}/crate.log"
PIDFILE = f"{DIR}/crate.pid"
HTTP_PORT = 4200
TRANSPORT_PORT = 4300
TABLE = "jepsen_r"


class CrateDB(jdb.DB):
    """Tarball install + unicast-discovery cluster (crate.clj db)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, test, node):
        cu.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            f"{DIR}/bin/crate",
            "-Cnetwork.host=0.0.0.0",
            f"-Cnode.name={node}",
            "-Ccluster.name=jepsen",
            f"-Chttp.port={HTTP_PORT}",
            f"-Ctransport.port={TRANSPORT_PORT}",
            "-Cdiscovery.seed_hosts="
            + ",".join(f"{n}:{TRANSPORT_PORT}"
                       for n in test["nodes"]),
            "-Ccluster.initial_master_nodes="
            + ",".join(str(n) for n in test["nodes"]))

    def setup(self, test, node):
        logger.info("%s installing crate %s", node, self.version)
        with control.su():
            debian.install(["openjdk-17-jre-headless", "curl"])
            url = (f"https://cdn.crate.io/downloads/releases/"
                   f"cratedb/x64_linux/crate-{self.version}.tar.gz")
            cu.install_archive(url, DIR)
            self._start(test, node)
        cu.await_tcp_port(HTTP_PORT, timeout_secs=120)
        # schema from the primary only, once the cluster formed
        if str(node) == str(test["nodes"][0]):
            CrateSql(test, node).stmt(
                f"CREATE TABLE IF NOT EXISTS {TABLE} "
                "(id INT PRIMARY KEY, val INT) "
                "CLUSTERED INTO 5 SHARDS "
                "WITH (number_of_replicas = "
                f"{len(test['nodes']) - 1})")

    def teardown(self, test, node):
        logger.info("%s tearing down crate", node)
        with control.su():
            cu.stop_daemon(f"{DIR}/bin/crate", PIDFILE)
            control.exec_("rm", "-rf", DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("crate")
        return "killed"

    def start(self, test, node):
        with control.su():
            self._start(test, node)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# the _sql-over-curl transport
# ---------------------------------------------------------------------------

class CrateSqlError(Exception):
    """Crate REJECTED the statement (an `error` JSON reply) — it
    definitely did not apply."""


class CrateSql:
    """One SQL statement = one curl POST to the node's `_sql`
    endpoint. Split out so tests can stub `stmt`. Non-retrying
    session: INSERT/UPDATE are not idempotent (the raftis RedisCli
    rationale)."""

    def __init__(self, test, node, timeout: float = 8.0):
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

    def stmt(self, sql: str, args: list | None = None) -> dict:
        body = json.dumps({"stmt": sql, "args": args or []})
        with control.with_session(self.test, self.node, self.sess):
            out = control.exec_(
                "curl", "-s", "--max-time",
                str(int(self.timeout)),
                "-H", "Content-Type: application/json",
                "-XPOST", f"http://{self.node}:{HTTP_PORT}/_sql",
                "-d", body, timeout=self.timeout + 2)
        try:
            reply = json.loads(out)
        except ValueError:
            raise RemoteError("non-JSON _sql reply", exit=0,
                              out=out[:200], err="", cmd="curl",
                              node=self.node)
        if isinstance(reply.get("error"), dict):
            raise CrateSqlError(
                str(reply["error"].get("message", reply["error"]))
                [:200])
        return reply

    def close(self):
        control.disconnect(self.sess)


_DEFINITE = ("connection refused", "could not connect",
             "couldn't connect", "no route", "empty reply")

# error classes Crate REJECTS before applying anything — only these
# make a write a definite :fail (the rethinkdb-suite rule: an opaque
# server error during a partition may have applied on the primary
# shard, so it must stay indeterminate :info, never a false definite)
_REJECTED = ("sqlparseexception", "columnunknown", "relationunknown",
             "relation unknown", "invalidcolumnname", "forbidden",
             "read-only", "unauthorized")


def _classify(op, e: Exception):
    msg = (str(e) if isinstance(e, CrateSqlError) else
           f"{getattr(e, 'err', '')} {getattr(e, 'out', '')} {e}"
           ).lower()
    if op.f == "read":
        return op.copy(type="fail", error=msg.strip()[:200])
    if isinstance(e, CrateSqlError):
        if any(m in msg for m in _REJECTED):
            return op.copy(type="fail", error=msg.strip()[:200])
        # opaque server-side error (internal timeout, shard failure):
        # the write may have applied — indeterminate
        return op.copy(type="info", error=msg.strip()[:200])
    if any(m in msg for m in _DEFINITE):
        return op.copy(type="fail", error=msg.strip()[:200])
    return op.copy(type="info", error=msg.strip()[:200])


class CrateRegisterClient(jclient.Client):
    """CAS register at row id=0 (crate.clj client): writes upsert,
    CAS is a conditional UPDATE whose rowcount proves whether it
    applied, reads REFRESH first (visibility, see module doc)."""

    def __init__(self, sql_factory=CrateSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = CrateRegisterClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                self.sql.stmt(f"REFRESH TABLE {TABLE}")
                r = self.sql.stmt(
                    f"SELECT val FROM {TABLE} WHERE id = 0")
                rows = r.get("rows") or []
                return op.copy(type="ok",
                               value=rows[0][0] if rows else None)
            if op.f == "write":
                r = self.sql.stmt(
                    f"INSERT INTO {TABLE} (id, val) VALUES (0, ?) "
                    "ON CONFLICT (id) DO UPDATE SET val = ?",
                    [int(op.value), int(op.value)])
                if r.get("rowcount") != 1:
                    raise RemoteError("unexpected upsert rowcount",
                                      exit=0,
                                      out=str(r.get("rowcount")),
                                      err="", cmd="INSERT",
                                      node=None)
                return op.copy(type="ok")
            if op.f == "cas":
                frm, to = op.value
                # conditional write: rowcount 1 = applied, 0 = the
                # precondition failed (a definite :fail). REFRESH
                # first so the predicate sees the newest segment.
                self.sql.stmt(f"REFRESH TABLE {TABLE}")
                r = self.sql.stmt(
                    f"UPDATE {TABLE} SET val = ? "
                    "WHERE id = 0 AND val = ?",
                    [int(to), int(frm)])
                n = r.get("rowcount")
                if n not in (0, 1):
                    raise RemoteError("unexpected cas rowcount",
                                      exit=0, out=str(n), err="",
                                      cmd="UPDATE", node=None)
                return op.copy(type="ok" if n == 1 else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except (RemoteError, CrateSqlError) as e:
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
        "client": CrateRegisterClient(),
        "generator": gen.limit(opts.get("ops", 500), one),
        "checker": chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")}),
    }


WORKLOADS = {"register": register_workload}


def crate_test(opts: dict) -> dict:
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"crate-{name}",
        os=debian.os,
        db=CrateDB(opts.get("version", VERSION)),
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
                   help="CrateDB release to install.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(crate_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    commands.update(cli.coverage_cmd(list(WORKLOADS)))
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
