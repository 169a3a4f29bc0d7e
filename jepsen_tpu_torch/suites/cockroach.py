"""CockroachDB test suite: register, bank, monotonic and sequential
workloads over `cockroach sql` on the nodes.

Capability reference: cockroachdb/src/jepsen/cockroach/ — auto.clj
(tarball install, `cockroach start --insecure --join` on every node,
one-time `cockroach init`), register.clj (per-key cas register over
SQL), bank.clj (transfer txns), monotonic.clj (max+1 inserts carrying
cluster_logical_timestamp(), node, process, table), sequential.clj
(subkey chains probed in reverse), runner.clj (workload menu). The
reference drives JDBC; here every op is one `cockroach sql -e` batch
on the client's node — cockroach speaks the postgres dialect, so the
statement shapes mirror the postgres suite's, plus cockroach-isms:
UPSERT, RETURNING on guarded updates, and
cluster_logical_timestamp() as the monotonic timestamp source.

The port's copy of jepsen_tpu/suites/cockroach.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging
import random
import re
from decimal import Decimal

from .. import checker as chk
from .. import cli, client as jclient, control, core, db as jdb
from .. import generator as gen
from .. import independent
from .. import nemesis as jnemesis
from .. import testing, workloads
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "v23.1.14"
DIR = "/opt/cockroach"
BINARY = f"{DIR}/cockroach"
STORE_DIR = "/var/lib/cockroach"
LOGFILE = f"{DIR}/cockroach.log"
PIDFILE = f"{DIR}/cockroach.pid"
SQL_PORT = 26257
HTTP_PORT = 8080
DB_NAME = "jepsen"


class CockroachDB(jdb.DB):
    """Tarball install + insecure cluster join; the test primary runs
    the one-time init (auto.clj)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        logger.info("%s installing cockroach %s", node, self.version)
        join = ",".join(f"{n}:{SQL_PORT}" for n in test["nodes"])
        with control.su():
            url = (f"https://binaries.cockroachdb.com/cockroach-"
                   f"{self.version}.linux-amd64.tgz")
            cu.install_archive(url, DIR)
            control.exec_("mkdir", "-p", STORE_DIR)
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                BINARY, "start", "--insecure",
                "--store", STORE_DIR,
                "--listen-addr", f"{node}:{SQL_PORT}",
                "--http-addr", f"{node}:{HTTP_PORT}",
                "--join", join)
        core.synchronize(test)  # every daemon up before init
        if node == primary(test):
            with control.su():
                control.exec_(BINARY, "init", "--insecure",
                              "--host", f"{node}:{SQL_PORT}",
                              check=False)  # idempotent re-runs fail
            self._schema(test, node)
        core.synchronize(test)

    def _schema(self, test, node):
        stmts = [
            f"CREATE DATABASE IF NOT EXISTS {DB_NAME}",
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.kv "
            "(k INT PRIMARY KEY, v INT)",
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.accounts "
            "(id INT PRIMARY KEY, balance INT NOT NULL "
            "CHECK (balance >= 0))",
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.mono "
            "(val INT PRIMARY KEY, sts DECIMAL, node INT, "
            "process INT, tb INT)",
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.seq "
            "(key STRING PRIMARY KEY)",
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.sets "
            "(v INT PRIMARY KEY)",
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.g2a "
            "(id INT PRIMARY KEY, k INT)",
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.g2b "
            "(id INT PRIMARY KEY, k INT)",
        ] + [
            # (key, id) composite pk: the causal-reverse workload's
            # write ids are per-key sequences, not globally unique
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.comment_{i} "
            "(id INT, key INT, PRIMARY KEY (key, id))"
            for i in range(COMMENT_TABLES)
        ] + [
            f"CREATE TABLE IF NOT EXISTS {DB_NAME}.bank{i} "
            "(id INT PRIMARY KEY, balance INT NOT NULL "
            "CHECK (balance >= 0))"
            for i in range(8)
        ] + [
            f"INSERT INTO {DB_NAME}.bank{i} VALUES (0, 10) "
            "ON CONFLICT (id) DO NOTHING" for i in range(8)
        ]
        accounts = ",".join(f"({i}, 10)" for i in range(8))
        stmts.append(f"INSERT INTO {DB_NAME}.accounts VALUES "
                     f"{accounts} ON CONFLICT (id) DO NOTHING")
        for s in stmts:
            control.exec_(BINARY, "sql", "--insecure",
                          "--host", f"{node}:{SQL_PORT}", "-e", s)

    def teardown(self, test, node):
        logger.info("%s tearing down cockroach", node)
        with control.su():
            cu.stop_daemon(BINARY, PIDFILE)
            control.exec_("rm", "-rf", STORE_DIR, DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("cockroach")
        return "killed"

    def start(self, test, node):
        join = ",".join(f"{n}:{SQL_PORT}" for n in test["nodes"])
        with control.su():
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                BINARY, "start", "--insecure",
                "--store", STORE_DIR,
                "--listen-addr", f"{node}:{SQL_PORT}",
                "--http-addr", f"{node}:{HTTP_PORT}",
                "--join", join)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# SQL transport
# ---------------------------------------------------------------------------

COMMENT_TABLES = 4


class CrdbSql:
    """One `cockroach sql -e` batch on the client's node. Split out so
    tests can stub `run`."""

    def __init__(self, test, node, timeout: float = 10.0):
        self.test = test
        self.node = node
        self.timeout = timeout
        self.sess = control.session(test, node)

    def run(self, sql: str) -> str:
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_(
                BINARY, "sql", "--insecure",
                "--host", f"{self.node}:{SQL_PORT}",
                "-d", DB_NAME, "--format", "tsv", "-e", sql,
                timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


_DEFINITE_RE = re.compile(
    "|".join([r"restart transaction", r"TransactionRetryError",
              r"connection refused", r"failed to connect",
              r"violates check constraint",
              r"node is not ready"]), re.I)


def _classify(op, e: Exception):
    msg = f"{getattr(e, 'err', '')} {getattr(e, 'out', '')} {e}"
    if op.f == "read" or _DEFINITE_RE.search(msg):
        return op.copy(type="fail", error=msg.strip()[:200])
    return op.copy(type="info", error=msg.strip()[:200])


def _data_lines(out: str) -> list[str]:
    """tsv output minus the header row and notices."""
    lines = [ln for ln in out.splitlines()
             if ln.strip() and not ln.startswith(("NOTICE", "#"))]
    return lines[1:] if lines else []


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------

class CrdbRegisterClient(jclient.Client):
    """Per-key cas register over the kv table (register.clj): UPSERT
    writes, UPDATE .. WHERE v = old RETURNING guarded cas."""

    def __init__(self, sql_factory=CrdbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = CrdbRegisterClient(self.sql_factory)
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
                    f"SELECT v FROM kv WHERE k = {int(k)};")
                rows = _data_lines(out)
                val = int(rows[0]) if rows else None
                return op.copy(type="ok",
                               value=independent.ktuple(k, val))
            if op.f == "write":
                self.sql.run(f"UPSERT INTO kv VALUES "
                             f"({int(k)}, {int(v)});")
                return op.copy(type="ok")
            if op.f == "cas":
                old, new = v
                out = self.sql.run(
                    f"UPDATE kv SET v = {int(new)} "
                    f"WHERE k = {int(k)} AND v = {int(old)} "
                    f"RETURNING v;")
                return op.copy(
                    type="ok" if _data_lines(out) else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)


class CrdbMonotonicClient(jclient.Client):
    """Monotonic inserts (monotonic.clj): ONE atomic statement reads
    the max and inserts max+1 stamped with
    cluster_logical_timestamp()."""

    def __init__(self, sql_factory=CrdbSql):
        self.sql_factory = sql_factory
        self.sql = None
        self.node_index = 0

    def open(self, test, node):
        c = CrdbMonotonicClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        nodes = list(test.get("nodes", ()))
        c.node_index = nodes.index(node) if node in nodes else 0
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    @staticmethod
    def _row(parts) -> dict:
        # HLC timestamps carry 10 fractional digits (the logical
        # component); scale to an exact int so the value is numeric in
        # SQL (DECIMAL column: ORDER BY is numeric, not lexicographic)
        # AND survives the JSON store round trip losslessly — a
        # Decimal would be re-read as a repr STRING and the checker
        # would compare timestamps lexicographically
        return {"val": int(parts[0]),
                "sts": int(Decimal(parts[1]) * 10**10),
                "node": int(parts[2]),
                "process": int(parts[3]),
                "tb": int(parts[4])}

    def invoke(self, test, op):
        try:
            if op.f == "add":
                tb = random.randrange(2)
                out = self.sql.run(
                    "INSERT INTO mono (val, sts, node, process, tb) "
                    "SELECT COALESCE(MAX(val), 0) + 1, "
                    "cluster_logical_timestamp(), "
                    f"{self.node_index}, {int(op.process)}, {tb} "
                    "FROM mono RETURNING val, sts, node, process, tb;")
                rows = _data_lines(out)
                if not rows:
                    raise ValueError(f"no row returned: {out!r}")
                return op.copy(type="ok",
                               value=self._row(rows[0].split("\t")))
            if op.f == "read":
                out = self.sql.run(
                    "SELECT val, sts, node, process, tb FROM mono "
                    "ORDER BY sts;")
                rows = [self._row(ln.split("\t"))
                        for ln in _data_lines(out)]
                return op.copy(type="ok", value=rows)
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)


class CrdbSequentialClient(jclient.Client):
    """Subkey chains (sequential.clj): inserts in order, each its own
    statement; reads probe reversed."""

    def __init__(self, sql_factory=CrdbSql, key_count: int = 5):
        self.sql_factory = sql_factory
        self.key_count = key_count
        self.sql = None

    def open(self, test, node):
        c = CrdbSequentialClient(self.sql_factory,
                                 test.get("key_count",
                                          self.key_count))
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        seq = workloads.sequential
        ks = seq.subkeys(self.key_count, op.value)
        try:
            if op.f == "write":
                for k in ks:
                    self.sql.run(f"INSERT INTO seq (key) "
                                 f"VALUES ('{k}') "
                                 f"ON CONFLICT (key) DO NOTHING;")
                return op.copy(type="ok")
            if op.f == "read":
                obs = []
                for k in reversed(ks):
                    out = self.sql.run(
                        f"SELECT key FROM seq WHERE key = '{k}';")
                    rows = _data_lines(out)
                    obs.append(rows[0] if rows else None)
                return op.copy(type="ok", value=(op.value, obs))
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)


class CrdbBankClient(jclient.Client):
    """Bank transfers in one serializable batch (bank.clj; cockroach
    is always SERIALIZABLE) guarded by the accounts CHECK."""

    def __init__(self, sql_factory=CrdbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = CrdbBankClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.sql.run(
                    "SELECT id, balance FROM accounts ORDER BY id;")
                balances = {}
                for ln in _data_lines(out):
                    i, b = ln.split("\t")
                    balances[int(i)] = int(b)
                return op.copy(type="ok", value=balances)
            if op.f == "transfer":
                v = op.value
                f, t, a = (int(v["from"]), int(v["to"]),
                           int(v["amount"]))
                self.sql.run(
                    "BEGIN; "
                    f"UPDATE accounts SET balance = balance - {a} "
                    f"WHERE id = {f}; "
                    f"UPDATE accounts SET balance = balance + {a} "
                    f"WHERE id = {t}; "
                    "COMMIT;")
                return op.copy(type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    rng = random.Random(opts.get("seed"))
    keys = list(range(opts.get("keys", 4)))

    def one():
        r = rng.random()
        if r < 0.4:
            return {"f": "read", "value": None}
        if r < 0.7:
            return {"f": "write", "value": rng.randrange(5)}
        return {"f": "cas",
                "value": [rng.randrange(5), rng.randrange(5)]}

    return {
        "client": CrdbRegisterClient(),
        "generator": independent.concurrent_generator(
            opts["concurrency"], keys,
            lambda k: gen.limit(opts.get("ops_per_key", 200), one)),
        "checker": independent.checker(chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")})),
    }


def bank_workload(opts: dict) -> dict:
    from ..workloads import bank

    total = 8 * 10
    return {
        "client": CrdbBankClient(),
        "generator": bank.generator(accounts=list(range(8)),
                                    seed=opts.get("seed")),
        "checker": chk.checker(
            lambda test, hist, o: bank.check_fast(
                hist, total, device=opts.get("device"))),
    }


def monotonic_workload(opts: dict) -> dict:
    w = workloads.monotonic.workload({"ops": opts.get("ops", 300)})
    w["client"] = CrdbMonotonicClient()
    return w


def sequential_workload(opts: dict) -> dict:
    w = workloads.sequential.workload(
        {"ops": opts.get("ops", 400),
         "writers": workloads.sequential.default_writers(
             opts["concurrency"]),
         "seed": opts.get("seed")})
    w["client"] = CrdbSequentialClient(key_count=w["key_count"])
    return w


class CrdbSetClient(jclient.Client):
    """sets.clj: blind inserts of unique ints, one final full read."""

    def __init__(self, sql_factory=CrdbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = CrdbSetClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "add":
                self.sql.run(f"INSERT INTO sets (v) VALUES "
                             f"({int(op.value)});")
                return op.copy(type="ok")
            out = self.sql.run("SELECT v FROM sets;")
            return op.copy(type="ok", value=sorted(
                int(x) for x in _data_lines(out)))
        except RemoteError as e:
            return _classify(op, e)


class CrdbCommentsClient(jclient.Client):
    """comments.clj: blind inserts of (id, key) hashed across
    comment_N tables; reads select ids for the key across ALL tables
    in one txn. A read seeing w but missing an acked predecessor of w
    is the strict-serializability violation (causal-reverse)."""

    def __init__(self, sql_factory=CrdbSql,
                 table_count: int = COMMENT_TABLES):
        self.sql_factory = sql_factory
        self.table_count = table_count
        self.sql = None

    def open(self, test, node):
        c = CrdbCommentsClient(self.sql_factory, self.table_count)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def _table(self, wid) -> str:
        return f"comment_{int(wid) % self.table_count}"

    def invoke(self, test, op):
        k, v = op.value
        try:
            if op.f == "write":
                self.sql.run(
                    f"INSERT INTO {self._table(v)} (id, key) VALUES "
                    f"({int(v)}, {int(k)});")
                return op.copy(type="ok")
            sels = "; ".join(
                f"SELECT id FROM comment_{i} WHERE key = {int(k)}"
                for i in range(self.table_count))
            out = self.sql.run(f"BEGIN; {sels}; COMMIT;")
            ids = sorted(int(x) for x in out.split()
                         if x.strip().lstrip("-").isdigit())
            return op.copy(type="ok", value=(k, ids))
        except RemoteError as e:
            return _classify(op, e)


class CrdbG2Client(jclient.Client):
    """adya.clj G2: predicate-read both pair tables; insert only when
    both are empty. Serializability allows at most one committed
    insert per key (anti-dependency cycle otherwise)."""

    def __init__(self, sql_factory=CrdbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = CrdbG2Client(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        k, pair = op.value
        a_id, b_id = pair
        table, rid = (("g2a", a_id) if a_id is not None
                      else ("g2b", b_id))
        try:
            # ONE statement = one serializable txn: the predicate
            # check and the insert must not be split, or a healthy DB
            # serializes two unconditional inserts and gets flagged
            out = self.sql.run(
                f"INSERT INTO {table} (id, k) "
                f"SELECT {int(rid)}, {int(k)} WHERE NOT EXISTS "
                f"(SELECT 1 FROM g2a WHERE k = {int(k)}) AND "
                f"NOT EXISTS (SELECT 1 FROM g2b WHERE k = {int(k)}) "
                "RETURNING id;")
            if _data_lines(out):
                return op.copy(type="ok")
            return op.copy(type="fail", error="existing row")
        except RemoteError as e:
            return _classify(op, e)


class CrdbMultiBankClient(CrdbBankClient):
    """bank.clj multitable: each account in its own bankN table; the
    transfer txn spans two tables (different ranges/shards)."""

    def open(self, test, node):
        c = CrdbMultiBankClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def invoke(self, test, op):
        try:
            if op.f == "read":
                sels = "; ".join(
                    f"SELECT balance FROM bank{i} WHERE id = 0"
                    for i in range(8))
                out = self.sql.run(f"BEGIN; {sels}; COMMIT;")
                vals = [int(x) for x in _data_lines(out)
                        if x.strip().lstrip("-").isdigit()]
                return op.copy(type="ok",
                               value={i: b for i, b in
                                      enumerate(vals)})
            v = op.value
            f, t, a = (int(v["from"]), int(v["to"]),
                       int(v["amount"]))
            self.sql.run(
                "BEGIN; "
                f"UPDATE bank{f} SET balance = balance - {a} "
                "WHERE id = 0; "
                f"UPDATE bank{t} SET balance = balance + {a} "
                "WHERE id = 0; COMMIT;")
            return op.copy(type="ok")
        except RemoteError as e:
            return _classify(op, e)


def sets_workload(opts: dict) -> dict:
    w = workloads.sets.workload({"ops": opts.get("ops", 400)})
    w["client"] = CrdbSetClient()
    return w


def comments_workload(opts: dict) -> dict:
    w = workloads.causal_reverse.workload(dict(opts))
    w["client"] = CrdbCommentsClient()
    return w


def g2_workload(opts: dict) -> dict:
    w = workloads.adya.workload(dict(opts))
    w["client"] = CrdbG2Client()
    return w


def bank_multitable_workload(opts: dict) -> dict:
    w = bank_workload(opts)
    w["client"] = CrdbMultiBankClient()
    return w


WORKLOADS = {"register": register_workload,
             "bank": bank_workload,
             "bank-multitable": bank_multitable_workload,
             "monotonic": monotonic_workload,
             "sequential": sequential_workload,
             "sets": sets_workload,
             "comments": comments_workload,
             "g2": g2_workload}


def cockroach_test(opts: dict) -> dict:
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"cockroach-{name}",
        os=debian.os,
        db=CockroachDB(opts.get("version", VERSION)),
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        key_count=w.get("key_count", 5),
        client=w["client"],
        nemesis=jnemesis.partition_random_halves(),
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=_suite_generator(opts, w))
    return test


def _suite_generator(opts, w):
    main = gen.time_limit(
        opts.get("time_limit", 30),
        gen.clients(
            gen.stagger(1.0 / opts.get("rate", 20), w["generator"]),
            jnemesis.start_stop_cycle(10.0)))
    final = w.get("final_generator")
    if final is None:
        return main
    return gen.phases(
        main,
        gen.nemesis(gen.once({"type": "info", "f": "stop"})),
        gen.sleep(opts.get("recovery_time", 5)),
        gen.clients(final))


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default register). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="cockroach release tag to install.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(cockroach_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
