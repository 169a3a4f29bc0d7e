"""PostgreSQL test suite: serializable list-append (elle) and bank
transfer workloads against a single postgres instance, driven through
`psql` on the client nodes.

Capability reference: stolon/src/jepsen/stolon/append.clj (table-per-
key-hash layout, INSERT .. ON CONFLICT append, per-txn isolation,
could-not-serialize/deadlock -> :fail mapping), stolon/client.clj
(with-errors classification), stolon/ledger.clj + tests/bank.clj
(transfer/read over an accounts table), and postgres-rds (the
single-endpoint topology: every client talks to one postgres server —
here the primary node — the way the reference's clients all talk to
one RDS endpoint). The reference links a JDBC driver into the JVM;
here ops go through `psql -c` on the client's own node over the
control plane, so the suite needs no SQL driver on the control host
(the same transport stance as the zookeeper suite's zkCli).

The port's copy of jepsen_tpu/suites/postgres.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging
import random
import re

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing, workloads
from ..control.core import Lit, RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

USER = "jepsen"
DBNAME = "jepsen"
PORT = 5432
TABLE_COUNT = 3
LOG_DIR = "/var/log/postgresql"


def table_for(k) -> str:
    """txn<i> table for a key (stolon/append.clj table-for)."""
    return f"txn{int(k) % TABLE_COUNT}"


class PostgresDB(jdb.DB):
    """apt-installed postgres on the primary, psql client everywhere
    (stolon runs its own keeper/sentinel topology; the plain-postgres
    analog is one server + thin clients)."""

    def __init__(self, accounts=8, initial_balance=10):
        self.accounts = accounts
        self.initial_balance = initial_balance

    def _sql(self, sql: str) -> str:
        """Runs sql locally as the postgres superuser."""
        with control.su("postgres"):
            return control.exec_("psql", "-X", "-q", "-A", "-t",
                                 "-v", "ON_ERROR_STOP=1", "-c", sql)

    def setup(self, test, node):
        if node != primary(test):
            logger.info("%s installing psql client", node)
            with control.su():
                debian.install(["postgresql-client"])
            return
        logger.info("%s installing postgres server", node)
        with control.su():
            debian.install(["postgresql"])
            control.exec_("service", "postgresql", "start",
                          check=False)
        # Reachable from the other nodes: listen on all interfaces,
        # trust the test network (the reference configures hba/ssl via
        # stolon's cluster spec, stolon/db.clj)
        self._sql("ALTER SYSTEM SET listen_addresses = '*'")
        hba = self._sql("SHOW hba_file").strip()
        if hba:
            with control.su():
                control.exec_(
                    "sh", "-c",
                    f"echo 'host all {USER} 0.0.0.0/0 trust' >> {hba}")
        with control.su():
            control.exec_("service", "postgresql", "restart")
        self._sql(f"DROP DATABASE IF EXISTS {DBNAME}")
        self._sql(f"DROP ROLE IF EXISTS {USER}")
        self._sql(f"CREATE ROLE {USER} LOGIN")
        self._sql(f"CREATE DATABASE {DBNAME} OWNER {USER}")
        # Tables: append tables + the bank ledger with its invariant
        # enforced in-database (negative balances abort the txn)
        ddl = []
        for i in range(TABLE_COUNT):
            ddl.append(f"CREATE TABLE txn{i} ("
                       f"id int NOT NULL PRIMARY KEY, val text)")
        ddl.append("CREATE TABLE accounts ("
                   "id int NOT NULL PRIMARY KEY, "
                   "balance int NOT NULL CHECK (balance >= 0))")
        for i in range(self.accounts):
            ddl.append(f"INSERT INTO accounts VALUES "
                       f"({i}, {self.initial_balance})")
        for stmt in ddl:
            with control.su("postgres"):
                control.exec_("psql", "-X", "-q", "-d", DBNAME,
                              "-v", "ON_ERROR_STOP=1", "-c", stmt)
        with control.su("postgres"):
            control.exec_("psql", "-X", "-q", "-d", DBNAME, "-c",
                          f"GRANT ALL ON ALL TABLES IN SCHEMA public "
                          f"TO {USER}")

    def teardown(self, test, node):
        if node != primary(test):
            return
        logger.info("%s tearing down postgres", node)
        with control.su("postgres"):
            control.exec_("psql", "-X", "-q", "-c",
                          f"DROP DATABASE IF EXISTS {DBNAME}",
                          check=False)
        with control.su():
            control.exec_("service", "postgresql", "stop", check=False)

    def log_files(self, test, node):
        if node != primary(test):
            return []
        try:
            out = control.exec_("ls", Lit(f"{LOG_DIR}/*.log"),
                                check=False)
            return [p for p in out.split() if p]
        except RemoteError:
            return []


# ---------------------------------------------------------------------------
# psql transport + error classification
# ---------------------------------------------------------------------------

class Psql:
    """Runs SQL through psql on a client node against the primary
    (stolon/client.clj open, minus the JDBC stack). Split out so tests
    can stub `run`."""

    def __init__(self, test, node, host, timeout: float = 10.0,
                 port: int = PORT):
        self.test = test
        self.node = node
        self.host = host
        self.port = port
        self.timeout = timeout
        self.sess = control.session(test, node)

    def run(self, sql: str) -> str:
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_(
                "psql", "-h", self.host, "-p", str(self.port),
                "-U", USER, "-d", DBNAME,
                "-X", "-q", "-A", "-t", "-v", "ON_ERROR_STOP=1",
                "-c", sql, timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


# Definite aborts: postgres rejected the transaction, nothing
# committed (stolon/client.clj with-errors)
_DEFINITE_RE = re.compile(
    "|".join([
        r"could not serialize access",
        r"deadlock detected",
        r"violates check constraint",
        r"connection refused",
        r"could not connect",
        r"no route to host",
        r"database system is (starting up|shutting down)",
    ]), re.I)


def classify_error(op, e: Exception):
    """RemoteError -> completed op. Serialization failures, constraint
    violations and refused connections are definite :fail; anything
    else (timeouts, dropped connections mid-commit) is :info."""
    msg = " ".join(str(x) for x in
                   (getattr(e, "err", ""), getattr(e, "out", ""), e))
    if _DEFINITE_RE.search(msg):
        return op.copy(type="fail", error=_short_error(msg))
    return op.copy(type="info", error=_short_error(msg))


def _short_error(msg: str) -> str:
    m = re.search(r"ERROR:\s*([^\n]+)", msg)
    return m.group(1)[:200] if m else msg[:200]


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------

class PgAppendClient(jclient.Client):
    """Elle list-append over SQL: reads select the comma-joined list,
    appends upsert with INSERT .. ON CONFLICT .. val || ',' || new
    (stolon/append.clj append-using-on-conflict!). Multi-mop
    transactions run inside one BEGIN ISOLATION LEVEL <iso> block in a
    single psql round-trip, so the recorded txn is exactly one SQL
    transaction."""

    def __init__(self, psql_factory=Psql, isolation="SERIALIZABLE"):
        self.psql_factory = psql_factory
        self.isolation = isolation
        self.psql = None

    def open(self, test, node):
        c = PgAppendClient(self.psql_factory, self.isolation)
        c.psql = self.psql_factory(test, node, primary(test))
        return c

    def close(self, test):
        if self.psql is not None:
            self.psql.close()

    def _mop_sql(self, i: int, f: str, k, v) -> str:
        t = table_for(k)
        if f == "r":
            return (f"SELECT 'm{i}=' || COALESCE("
                    f"(SELECT val FROM {t} WHERE id = {int(k)}), '~')")
        return (f"INSERT INTO {t} AS t (id, val) "
                f"VALUES ({int(k)}, '{int(v)}') "
                f"ON CONFLICT (id) DO UPDATE "
                f"SET val = t.val || ',' || EXCLUDED.val")

    def invoke(self, test, op):
        mops = op.value
        stmts = [self._mop_sql(i, f, k, v)
                 for i, (f, k, v) in enumerate(mops)]
        # ALWAYS wrap, even single mops: postgres SSI only promises
        # serializability among SERIALIZABLE transactions — a lone
        # read at the session default can witness the read-only
        # anomaly and elle would flag a healthy server
        sql = (f"BEGIN ISOLATION LEVEL {self.isolation}; "
               + "; ".join(stmts) + "; COMMIT;")
        try:
            out = self.psql.run(sql)
        except RemoteError as e:
            return classify_error(op, e)
        reads = {}
        for line in out.splitlines():
            m = re.match(r"m(\d+)=(.*)$", line.strip())
            if m:
                raw = m.group(2)
                reads[int(m.group(1))] = (
                    None if raw == "~"
                    else [int(x) for x in raw.split(",") if x])
        done = []
        for i, (f, k, v) in enumerate(mops):
            if f == "r":
                done.append(["r", k, reads.get(i)])
            else:
                done.append(["append", k, v])
        return op.copy(type="ok", value=done)


class PgBankClient(jclient.Client):
    """Bank transfers: two guarded UPDATEs in one serializable txn;
    the accounts table's CHECK (balance >= 0) turns an overdraft into
    a definite abort. Reads aggregate the whole table in one SELECT
    (tests/bank.clj ops; stolon/ledger.clj is the reference's SQL
    shape)."""

    def __init__(self, psql_factory=Psql, isolation="SERIALIZABLE"):
        self.psql_factory = psql_factory
        self.isolation = isolation
        self.psql = None

    def open(self, test, node):
        c = PgBankClient(self.psql_factory, self.isolation)
        c.psql = self.psql_factory(test, node, primary(test))
        return c

    def close(self, test):
        if self.psql is not None:
            self.psql.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.psql.run(
                    "SELECT 'b=' || COALESCE(string_agg("
                    "id || ':' || balance, ',' ORDER BY id), '') "
                    "FROM accounts;")
                m = re.search(r"b=(.*)$", out, re.M)
                if not m:
                    raise ValueError(f"unparseable read: {out!r}")
                balances = {}
                for part in m.group(1).split(","):
                    if part:
                        acct, bal = part.split(":")
                        balances[int(acct)] = int(bal)
                return op.copy(type="ok", value=balances)
            if op.f == "transfer":
                v = op.value
                frm, to, amt = (int(v["from"]), int(v["to"]),
                                int(v["amount"]))
                sql = (
                    f"BEGIN ISOLATION LEVEL {self.isolation}; "
                    f"UPDATE accounts SET balance = balance - {amt} "
                    f"WHERE id = {frm}; "
                    f"UPDATE accounts SET balance = balance + {amt} "
                    f"WHERE id = {to}; "
                    f"COMMIT;")
                self.psql.run(sql)
                return op.copy(type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            if op.f == "read":
                return op.copy(type="fail", error=_short_error(
                    f"{getattr(e, 'err', '')} {e}"))
            return classify_error(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def append_workload(opts: dict) -> dict:
    w = workloads.txn_append.workload(
        {"ops": opts.get("ops", 2000),
         "key-count": opts.get("keys", 6),
         "seed": opts.get("seed"),
         "device": opts.get("device")})
    w["client"] = PgAppendClient(
        isolation=opts.get("isolation", "SERIALIZABLE"))
    return w


def bank_workload(opts: dict) -> dict:
    from ..workloads import bank

    accounts = list(range(opts.get("accounts", 8)))
    total = opts.get("accounts", 8) * opts.get("initial_balance", 10)
    return {
        "client": PgBankClient(
            isolation=opts.get("isolation", "SERIALIZABLE")),
        "generator": bank.generator(accounts=accounts,
                                    seed=opts.get("seed")),
        "checker": chk.checker(
            lambda test, hist, o: bank.check_fast(
                hist, total, device=opts.get("device"))),
    }


WORKLOADS = {"append": append_workload, "bank": bank_workload}


def postgres_test(opts: dict) -> dict:
    name = opts.get("workload", "append")
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"postgres-{name}",
        os=debian.os,
        db=PostgresDB(accounts=opts.get("accounts", 8),
                      initial_balance=opts.get("initial_balance", 10)),
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
    p.add_argument("--workload", default="append",
                   help="Workload. " + cli.one_of(WORKLOADS))
    p.add_argument("--rate", type=float, default=20)
    p.add_argument("--isolation", default="SERIALIZABLE",
                   choices=["SERIALIZABLE", "REPEATABLE READ",
                            "READ COMMITTED"],
                   help="Transaction isolation level under test.")
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(postgres_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
