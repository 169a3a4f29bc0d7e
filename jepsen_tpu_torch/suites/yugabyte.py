"""YugabyteDB test suite: an API-parameterized workload matrix — each
workload runs over YCQL (cassandra dialect) or YSQL (postgres
dialect), exactly the reference's two client families.

Capability reference: yugabyte/src/yugabyte/
  core.clj:75-105  — workloads-ycql / workloads-ysql matrix this
                     module mirrors (counter, set, set-index, bank,
                     bank-multitable, long-fork, single/multi-key-acid,
                     append, append-table, default-value)
  auto.clj         — master/tserver daemon automation, replication
                     factor, --master_addresses wiring
  ycql/client.clj, ysql/client.clj — per-API clients; ycql bank runs
                     allow-negatives (core.clj:80-82 comment)
  ysql/append.clj  — elle list-append over text-concat rows;
                     append_table.clj the per-table variant
  ysql/default_value.clj — DDL default-value race: concurrent ALTER
                     TABLE ADD COLUMN DEFAULT + inserts; no read may
                     see a NULL in the defaulted column
  multi_key_acid.clj — atomic two-key writes, linearizable against a
                     multi-register model

Transport: `ysqlsh` (psql-compatible) and `ycqlsh -e` on the client's
own node. Clients depend on a small `run(stmt) -> str` runner, so the
clusterless tests substitute scripted fakes.

The port's copy of jepsen_tpu/suites/yugabyte.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging
import re
import random as _random

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import independent, testing
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..os_setup import debian
from ..workloads import bank as bank_wl
from ..workloads import counter as counter_wl
from ..workloads import long_fork as lf_wl
from ..workloads import sets as sets_wl
from ..workloads import txn_append as append_wl

logger = logging.getLogger(__name__)

DIR = "/opt/yugabyte"
VERSION = "2.20.1.3"
URL = (f"https://downloads.yugabyte.com/releases/{VERSION}/"
       f"yugabyte-{VERSION}-b3-linux-x86_64.tar.gz")
MASTER_PORT = 7100
TSERVER_PORT = 9100
YSQL_PORT = 5433
YCQL_PORT = 9042
MASTER = (f"{DIR}/master.log", f"{DIR}/master.pid")
TSERVER = (f"{DIR}/tserver.log", f"{DIR}/tserver.pid")
KEYSPACE = "jepsen"


def master_addresses(test) -> str:
    return ",".join(f"{n}:{MASTER_PORT}" for n in test["nodes"])


class YbDB(jdb.DB):
    """Installs and runs yb-master + yb-tserver on every node
    (auto.clj start-master!/start-tserver!)."""

    supports_kill = True

    def __init__(self, version: str = VERSION, replicas: int = 3):
        self.version = version
        self.replicas = replicas

    def setup(self, test, node):
        with control.su():
            cu.install_archive(URL, DIR)
            control.exec_(f"{DIR}/bin/post_install.sh", check=False)
        self._start_master(test, node)
        self._start_tserver(test, node)
        cu.await_tcp_port(YSQL_PORT, timeout_secs=180)
        # YCQL clients run inside this keyspace (ycqlsh has no
        # default; unqualified DDL would fail otherwise)
        control.exec_(
            f"{DIR}/bin/ycqlsh", node, str(YCQL_PORT), "-e",
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE};",
            check=False)

    def _start_master(self, test, node):
        with control.su():
            cu.start_daemon(
                {"chdir": DIR, "logfile": MASTER[0],
                 "pidfile": MASTER[1]},
                f"{DIR}/bin/yb-master",
                "--master_addresses", master_addresses(test),
                "--rpc_bind_addresses", f"{node}:{MASTER_PORT}",
                "--replication_factor", str(self.replicas),
                "--fs_data_dirs", f"{DIR}/data/master")

    def _start_tserver(self, test, node):
        with control.su():
            cu.start_daemon(
                {"chdir": DIR, "logfile": TSERVER[0],
                 "pidfile": TSERVER[1]},
                f"{DIR}/bin/yb-tserver",
                "--tserver_master_addrs", master_addresses(test),
                "--rpc_bind_addresses", f"{node}:{TSERVER_PORT}",
                "--start_pgsql_proxy",
                "--pgsql_proxy_bind_address", f"{node}:{YSQL_PORT}",
                "--cql_proxy_bind_address", f"{node}:{YCQL_PORT}",
                "--fs_data_dirs", f"{DIR}/data/tserver")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", f"{DIR}/data", MASTER[0],
                          TSERVER[0], check=False)

    def log_files(self, test, node):
        return [MASTER[0], TSERVER[0]]

    def kill(self, test, node):
        with control.su():
            cu.grepkill("yb-master")
            cu.grepkill("yb-tserver")
            control.exec_("rm", "-rf", MASTER[1], TSERVER[1],
                          check=False)

    def start(self, test, node):
        self._start_master(test, node)
        self._start_tserver(test, node)


# ---------------------------------------------------------------------------
# Runners (ysqlsh / ycqlsh), swappable in tests
# ---------------------------------------------------------------------------


class YsqlRunner:
    """SQL through ysqlsh on the client's own node (ysql/client.clj)."""

    dialect = "ysql"

    def __init__(self, test, node, timeout: float = 10.0):
        self.node = node
        self.timeout = timeout

    def run(self, stmt: str) -> str:
        return control.exec_(
            f"{DIR}/bin/ysqlsh", "-h", self.node, "-p",
            str(YSQL_PORT), "-U", "yugabyte", "-d", "yugabyte",
            "-X", "-q", "-A", "-t", "-v", "ON_ERROR_STOP=1",
            "-c", stmt, timeout=self.timeout)

    def close(self):
        pass


class YcqlRunner:
    """CQL through ycqlsh on the client's own node (ycql/client.clj)."""

    dialect = "ycql"

    def __init__(self, test, node, timeout: float = 10.0):
        self.node = node
        self.timeout = timeout

    def run(self, stmt: str) -> str:
        return control.exec_(
            f"{DIR}/bin/ycqlsh", self.node, str(YCQL_PORT),
            "--no-color", "-k", KEYSPACE, "-e", stmt,
            timeout=self.timeout)

    def close(self):
        pass


RUNNERS = {"ysql": YsqlRunner, "ycql": YcqlRunner}

# Definite rejections: the statement was refused, nothing committed
_DEFINITE = ("could not serialize", "conflicts with higher priority",
             "restart read required", "duplicate key",
             "invalidqueryexception", "conditional", "aborted")


def _classify(op, e: Exception, writing: bool):
    msg = str(e).lower()
    if any(p in msg for p in _DEFINITE):
        return op.copy(type="fail", error=str(e)[:200])
    return op.copy(type="info" if writing else "fail",
                   error=str(e)[:200])


def _int_lines(out: str) -> list[int]:
    """Integers from CLI output, one per line — robust to ycqlsh's
    headers, rules, and '(n rows)' trailers."""
    vals = []
    for line in out.splitlines():
        s = line.strip()
        if re.fullmatch(r"-?\d+", s):
            vals.append(int(s))
    return vals


class _YbClient(jclient.Client):
    runner_factory: type = YsqlRunner
    setup_stmts: tuple = ()

    @property
    def dialect(self) -> str:
        return getattr(self.runner, "dialect", "ysql")

    def __init__(self, runner_factory=None):
        if runner_factory is not None:
            self.runner_factory = runner_factory
        self.runner = None

    def open(self, test, node):
        c = type(self)(self.runner_factory)
        c.runner = self.runner_factory(test, node)
        return c

    def setup(self, test):
        if self.runner is not None:
            for stmt in self.setup_stmts:
                try:
                    self.runner.run(stmt)
                except RemoteError:
                    pass
        return self

    def close(self, test):
        if self.runner is not None:
            self.runner.close()
            self.runner = None


# -- counter ---------------------------------------------------------------


class CounterClient(_YbClient):
    """increment/read one counter row (ycql/counter.clj uses a CQL
    counter column; ysql an int column). UPDATE .. count + x is valid
    in both dialects; only the DDL differs."""

    @property
    def setup_stmts(self):
        if self.dialect == "ycql":
            # CQL counter tables can't be INSERTed; the first UPDATE
            # creates the row
            return ("CREATE TABLE IF NOT EXISTS counters "
                    "(id INT PRIMARY KEY, count COUNTER)",)
        return (
            "CREATE TABLE IF NOT EXISTS counters (id INT PRIMARY "
            "KEY, count INT)",
            "INSERT INTO counters (id, count) VALUES (0, 0) "
            "ON CONFLICT (id) DO NOTHING",
        )

    def invoke(self, test, op):
        try:
            if op.f == "add":
                self.runner.run("UPDATE counters SET count = count + "
                                f"{op.value} WHERE id = 0")
                return op.copy(type="ok")
            out = self.runner.run(
                "SELECT count FROM counters WHERE id = 0")
            vals = _int_lines(out)
            return op.copy(type="ok", value=vals[0] if vals else 0)
        except RemoteError as e:
            return _classify(op, e, op.f == "add")


# -- set -------------------------------------------------------------------


class SetClient(_YbClient):
    """add unique ints / read them all (ycql+ysql set.clj); the
    `index` flavor reads through a covering secondary index
    (ycql/set.clj CQLSetIndexClient)."""

    index = False
    setup_stmts = (
        "CREATE TABLE IF NOT EXISTS elements (v INT PRIMARY KEY)",
    )

    def invoke(self, test, op):
        try:
            if op.f == "add":
                self.runner.run(
                    f"INSERT INTO elements (v) VALUES ({op.value})")
                return op.copy(type="ok")
            out = self.runner.run("SELECT v FROM elements")
            return op.copy(type="ok", value=sorted(_int_lines(out)))
        except RemoteError as e:
            return _classify(op, e, op.f == "add")


class SetIndexClient(SetClient):
    index = True
    setup_stmts = SetClient.setup_stmts + (
        "CREATE INDEX IF NOT EXISTS elements_idx ON elements (v)",
    )


# -- bank ------------------------------------------------------------------


class BankClient(_YbClient):
    """Single-table bank; transfers in one SQL txn. The reference runs
    allow-negatives for both APIs (core.clj:80-82), so the guard stays
    out and the checker gets negative-balances? true. `multitable`
    puts every account in its own table (ysql/bank.clj
    YSQLMultiBankClient)."""

    multitable = False
    accounts = tuple(range(8))
    initial = 10

    @property
    def setup_stmts(self):
        # CQL INSERT is already an upsert; ON CONFLICT is ysql-only
        guard = ("" if self.dialect == "ycql"
                 else " ON CONFLICT (id) DO NOTHING")
        if self.multitable:
            out = []
            for a in self.accounts:
                out.append(f"CREATE TABLE IF NOT EXISTS bank{a} "
                           "(id INT PRIMARY KEY, balance INT)")
                out.append(f"INSERT INTO bank{a} (id, balance) "
                           f"VALUES (0, {self.initial}){guard}")
            return tuple(out)
        return (
            "CREATE TABLE IF NOT EXISTS bank (id INT PRIMARY KEY, "
            "balance INT)",
        ) + tuple(
            f"INSERT INTO bank (id, balance) VALUES ({a}, "
            f"{self.initial}){guard}" for a in self.accounts)

    def _table(self, a):
        return f"bank{a}" if self.multitable else "bank"

    def _id(self, a):
        return 0 if self.multitable else a

    def _read_stmt(self) -> str:
        # ONE statement = one snapshot: a per-account SELECT loop
        # would read across concurrent transfers (bank.clj reads all
        # balances in a single query)
        if self.multitable:
            return " UNION ALL ".join(
                f"SELECT {a} AS id, balance FROM bank{a} WHERE id = 0"
                for a in self.accounts)
        if self.dialect == "ycql":
            # CQL rejects ORDER BY on the partition key; rows sort
            # host-side by the parsed ids anyway
            return "SELECT id, balance FROM bank"
        return "SELECT id, balance FROM bank ORDER BY id"

    def _txn(self, stmts: list[str]) -> str:
        if self.dialect == "ycql":
            return ("BEGIN TRANSACTION " + "; ".join(stmts)
                    + "; END TRANSACTION;")
        return ("BEGIN TRANSACTION ISOLATION LEVEL SERIALIZABLE; "
                + "; ".join(stmts) + "; COMMIT;")

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.runner.run(self._read_stmt())
                bal = {}
                for line in out.splitlines():
                    m = re.match(r"\s*(\d+)\s*\|\s*(-?\d+)\s*$",
                                 line)
                    if m:
                        bal[int(m.group(1))] = int(m.group(2))
                return op.copy(type="ok", value=bal)
            v = op.value
            frm, to, amt = v["from"], v["to"], v["amount"]
            self.runner.run(self._txn([
                f"UPDATE {self._table(frm)} SET balance = balance - "
                f"{amt} WHERE id = {self._id(frm)}",
                f"UPDATE {self._table(to)} SET balance = balance + "
                f"{amt} WHERE id = {self._id(to)}"]))
            return op.copy(type="ok")
        except RemoteError as e:
            return _classify(op, e, op.f == "transfer")


class MultiBankClient(BankClient):
    multitable = True


# -- single-key acid -------------------------------------------------------


class SingleKeyAcidClient(_YbClient):
    """Per-key linearizable register: write / read / cas one row
    (single_key_acid.clj; CQL uses IF-conditions, SQL a guarded
    UPDATE)."""

    setup_stmts = (
        "CREATE TABLE IF NOT EXISTS registers (id INT PRIMARY KEY, "
        "val INT)",
    )

    def invoke(self, test, op):
        k, v = op.value
        try:
            if op.f == "read":
                out = self.runner.run(
                    f"SELECT val FROM registers WHERE id = {k}")
                vals = _int_lines(out)
                return op.copy(type="ok",
                               value=(k, vals[0] if vals else None))
            if op.f == "write":
                if self.dialect == "ycql":
                    # CQL INSERT is an upsert
                    self.runner.run(
                        f"INSERT INTO registers (id, val) VALUES "
                        f"({k}, {v})")
                else:
                    self.runner.run(
                        f"INSERT INTO registers (id, val) VALUES "
                        f"({k}, {v}) ON CONFLICT (id) DO UPDATE SET "
                        f"val = {v}")
                return op.copy(type="ok")
            old, new = v
            if self.dialect == "ycql":
                out = self.runner.run(
                    f"UPDATE registers SET val = {new} WHERE "
                    f"id = {k} IF val = {old}")
                applied = "true" in out.lower()
            else:
                out = self.runner.run(
                    f"UPDATE registers SET val = {new} WHERE "
                    f"id = {k} AND val = {old} RETURNING val")
                applied = bool(_int_lines(out))
            if applied:
                return op.copy(type="ok")
            return op.copy(type="fail", error="cas mismatch")
        except RemoteError as e:
            return _classify(op, e, op.f != "read")


# -- multi-key acid --------------------------------------------------------


class MultiRegister(models.Model):
    """Two registers written atomically; reads see both
    (multi_key_acid.clj's multi-register model)."""

    tabulable = True

    def __init__(self, vals=(None, None)):
        self.vals = tuple(vals)

    def step(self, op):
        if op.f == "write":
            return MultiRegister([op.value[0][1], op.value[1][1]])
        if op.value is None:
            return self
        want = (op.value[0][1], op.value[1][1])
        if want == self.vals:
            return self
        return models.inconsistent(
            f"read {want}, register holds {self.vals}")

    def __eq__(self, other):
        return (isinstance(other, MultiRegister)
                and self.vals == other.vals)

    def __hash__(self):
        return hash(self.vals)

    def __repr__(self):
        return f"MultiRegister{self.vals}"


class MultiKeyAcidClient(_YbClient):
    """Atomic two-subkey writes per key group; value is
    [[subkey, v], [subkey, v]] (multi_key_acid.clj)."""

    setup_stmts = (
        "CREATE TABLE IF NOT EXISTS multireg (id TEXT PRIMARY KEY, "
        "val INT)",
    )

    def invoke(self, test, op):
        k, v = op.value
        try:
            if op.f == "write":
                if self.dialect == "ycql":
                    stmts = "; ".join(
                        f"INSERT INTO multireg (id, val) VALUES "
                        f"('{k}_{sk}', {x})" for sk, x in v)
                    self.runner.run("BEGIN TRANSACTION " + stmts
                                    + "; END TRANSACTION;")
                else:
                    stmts = "; ".join(
                        f"INSERT INTO multireg (id, val) VALUES "
                        f"('{k}_{sk}', {x}) ON CONFLICT (id) DO "
                        f"UPDATE SET val = {x}" for sk, x in v)
                    self.runner.run(
                        "BEGIN TRANSACTION ISOLATION LEVEL "
                        "SERIALIZABLE; " + stmts + "; COMMIT;")
                return op.copy(type="ok")
            # ONE statement = one snapshot; a per-subkey SELECT loop
            # could observe an atomic write half-applied
            ids = ", ".join(f"'{k}_{sk}'" for sk, _x in v)
            out = self.runner.run(
                f"SELECT id, val FROM multireg WHERE id IN ({ids})")
            seen = {}
            for line in out.splitlines():
                m = re.match(
                    r"\s*(\S+?)_(\d+)\s*\|\s*(-?\d+)\s*$", line)
                if m:
                    seen[int(m.group(2))] = int(m.group(3))
            got = [[sk, seen.get(sk)] for sk, _x in v]
            return op.copy(type="ok", value=(k, got))
        except RemoteError as e:
            return _classify(op, e, op.f == "write")


# -- append (elle list-append) ---------------------------------------------


class AppendClient(_YbClient):
    """elle list-append over comma-concat text rows (ysql/append.clj);
    `per_table` spreads keys over tables (append_table.clj)."""

    per_table = False
    table_count = 3

    @property
    def setup_stmts(self):
        if self.per_table:
            return tuple(
                f"CREATE TABLE IF NOT EXISTS append{i} (k INT PRIMARY "
                "KEY, v TEXT)" for i in range(self.table_count))
        return ("CREATE TABLE IF NOT EXISTS append0 (k INT PRIMARY "
                "KEY, v TEXT)",)

    def _table(self, k):
        return (f"append{int(k) % self.table_count}" if self.per_table
                else "append0")

    def invoke(self, test, op):
        try:
            stmts = []
            for i, (f, k, v) in enumerate(op.value):
                if f == "append":
                    stmts.append(
                        f"INSERT INTO {self._table(k)} (k, v) VALUES "
                        f"({k}, '{v}') ON CONFLICT (k) DO UPDATE SET "
                        f"v = {self._table(k)}.v || ',{v}'")
                else:
                    # tagged scalar subquery: ALWAYS one output line,
                    # so zero-row reads can't shift later reads'
                    # positional alignment
                    stmts.append(
                        f"SELECT 'm{i}=' || COALESCE((SELECT v FROM "
                        f"{self._table(k)} WHERE k = {k}), '~')")
            out = self.runner.run(
                "BEGIN TRANSACTION ISOLATION LEVEL SERIALIZABLE; "
                + "; ".join(stmts) + "; COMMIT;")
            tagged = {}
            for line in out.splitlines():
                m = re.match(r"\s*m(\d+)=(.*)$", line.strip())
                if m:
                    tagged[int(m.group(1))] = m.group(2)
            res = [list(m_) for m_ in op.value]
            for i, (f, k, v) in enumerate(op.value):
                if f != "append":
                    raw = tagged.get(i, "~")
                    res[i][2] = ([int(x) for x in raw.split(",") if x]
                                 if raw != "~" else [])
            return op.copy(type="ok", value=res)
        except RemoteError as e:
            return _classify(op, e, True)


class AppendTableClient(AppendClient):
    per_table = True


class TxnWClient(_YbClient):
    """w/r micro-op txns for long-fork (ycql/ysql long_fork.clj):
    writes upsert single-int cells, reads come back tagged so
    zero-row reads can't misalign."""

    setup_stmts = (
        "CREATE TABLE IF NOT EXISTS lf (k INT PRIMARY KEY, v INT)",
    )

    def _invoke_ycql(self, op):
        # YCQL transactions accept only DML — no SELECT, no
        # expressions. long-fork txns are single-write or all-read
        # (long_fork.clj's generator shape), so: writes go in a
        # DML-only txn, reads as ONE SELECT .. IN (a single-statement
        # snapshot).
        writes = [(k, v) for f, k, v in op.value if f == "w"]
        res = [list(m_) for m_ in op.value]
        if writes:
            stmts = "; ".join(f"INSERT INTO lf (k, v) VALUES "
                              f"({k}, {v})" for k, v in writes)
            if len(writes) == 1:
                self.runner.run(stmts + ";")
            else:
                self.runner.run("BEGIN TRANSACTION " + stmts
                                + "; END TRANSACTION;")
        read_keys = [k for f, k, v in op.value if f == "r"]
        if read_keys:
            ks = ", ".join(str(k) for k in read_keys)
            out = self.runner.run(
                f"SELECT k, v FROM lf WHERE k IN ({ks})")
            seen = {}
            for line in out.splitlines():
                m = re.match(r"\s*(\d+)\s*\|\s*(-?\d+)\s*$",
                             line)
                if m:
                    seen[int(m.group(1))] = int(m.group(2))
            for i, (f, k, v) in enumerate(op.value):
                if f == "r":
                    res[i][2] = seen.get(k)
        return op.copy(type="ok", value=res)

    def invoke(self, test, op):
        try:
            if self.dialect == "ycql":
                return self._invoke_ycql(op)
            stmts = []
            for i, (f, k, v) in enumerate(op.value):
                if f == "w":
                    stmts.append(
                        f"INSERT INTO lf (k, v) VALUES ({k}, {v})"
                        f" ON CONFLICT (k) DO UPDATE SET v = {v}")
                else:
                    stmts.append(
                        f"SELECT 'm{i}=' || COALESCE((SELECT "
                        f"CAST(v AS TEXT) FROM lf WHERE k = {k}), "
                        "'~')")
            out = self.runner.run(
                "BEGIN TRANSACTION ISOLATION LEVEL SERIALIZABLE; "
                + "; ".join(stmts) + "; COMMIT;")
            tagged = {}
            for line in out.splitlines():
                m = re.match(r"\s*m(\d+)=(.*)$", line.strip())
                if m:
                    tagged[int(m.group(1))] = m.group(2)
            res = [list(m_) for m_ in op.value]
            for i, (f, k, v) in enumerate(op.value):
                if f == "r":
                    raw = tagged.get(i, "~")
                    res[i][2] = None if raw == "~" else int(raw)
            return op.copy(type="ok", value=res)
        except RemoteError as e:
            return _classify(op, e, True)


# -- default-value (DDL race) ----------------------------------------------


def check_default_values(hist) -> dict:
    """No read may observe NULL in the defaulted column
    (ysql/default_value.clj checker)."""
    bad = [op for op in hist
           if op.type == "ok" and op.f == "read"
           and isinstance(op.value, list)
           and any(v is None for v in op.value)]
    return {"valid?": not bad,
            "bad-reads": [o.to_dict() for o in bad[:8]]}


class DefaultValueClient(_YbClient):
    """Concurrent ALTER TABLE ADD COLUMN ... DEFAULT vs inserts vs
    full-column reads (ysql/default_value.clj)."""

    setup_stmts = (
        "CREATE TABLE IF NOT EXISTS dv (id SERIAL PRIMARY KEY)",
    )

    def invoke(self, test, op):
        try:
            if op.f == "insert":
                self.runner.run("INSERT INTO dv DEFAULT VALUES")
                return op.copy(type="ok")
            if op.f == "add-column":
                self.runner.run(
                    f"ALTER TABLE dv ADD COLUMN IF NOT EXISTS "
                    f"c{op.value} INT NOT NULL DEFAULT 0")
                return op.copy(type="ok")
            out = self.runner.run(
                "SELECT * FROM dv ORDER BY id DESC LIMIT 8")
            vals = []
            for line in out.splitlines():
                for cell in line.split("|")[1:]:
                    vals.append(int(cell) if cell.strip() else None)
            return op.copy(type="ok", value=vals)
        except RemoteError as e:
            return _classify(op, e, op.f != "read")


def default_value_workload(opts):
    o = dict(opts or {})
    cols = iter(range(10_000))

    def one():
        r = _random.random()
        if r < 0.45:
            return {"f": "insert", "value": None}
        if r < 0.55:
            return {"f": "add-column", "value": next(cols)}
        return {"f": "read", "value": None}

    return {
        "generator": gen.limit(o.get("ops", 200), one),
        "checker": chk.checker(
            lambda test, hist, copts: check_default_values(hist)),
        "client": DefaultValueClient(),
    }


def multi_key_acid_workload(opts):
    o = dict(opts or {})
    keys = o.get("keys", list(range(6)))

    def key_gen(k):
        rng = _random.Random(None if o.get("seed") is None
                             else repr((o.get("seed"), k)))

        def one():
            if rng.random() < 0.5:
                v = rng.randrange(5)
                return {"f": "write", "value": [[0, v], [1, v + 100]]}
            return {"f": "read", "value": [[0, None], [1, None]]}

        return gen.limit(o.get("ops_per_key", 40), one)

    return {
        "generator": independent.concurrent_generator(
            o.get("group_size", 3), keys, key_gen),
        "checker": independent.checker(chk.linearizable(
            {"model": MultiRegister(), "device": o.get("device")})),
        "client": MultiKeyAcidClient(),
    }


def single_key_acid_workload(opts):
    from ..workloads import register as register_wl

    o = dict(opts or {})
    w = register_wl.workload(dict(o, initial=None))
    w["client"] = SingleKeyAcidClient()
    return w


# ---------------------------------------------------------------------------
# The API x workload matrix (core.clj:75-105)
# ---------------------------------------------------------------------------


def _with(base_fn, client, **extra):
    def build(opts):
        w = base_fn(dict(opts or {}, **extra))
        w["client"] = client()
        return w

    return build


def _bank(opts):
    o = dict(opts or {})
    o.setdefault("negative-balances?", True)  # core.clj:80-82
    return bank_wl.workload(o)


WORKLOADS = {
    "ycql/counter": _with(counter_wl.workload, CounterClient),
    "ycql/set": _with(sets_wl.workload, SetClient),
    "ycql/set-index": _with(sets_wl.workload, SetIndexClient),
    "ycql/bank": _with(_bank, BankClient),
    "ycql/long-fork": _with(lf_wl.workload, TxnWClient),
    "ycql/single-key-acid": single_key_acid_workload,
    "ycql/multi-key-acid": multi_key_acid_workload,
    "ysql/counter": _with(counter_wl.workload, CounterClient),
    "ysql/set": _with(sets_wl.workload, SetClient),
    "ysql/bank": _with(_bank, BankClient),
    "ysql/bank-multitable": _with(_bank, MultiBankClient),
    "ysql/long-fork": _with(lf_wl.workload, TxnWClient),
    "ysql/single-key-acid": single_key_acid_workload,
    "ysql/multi-key-acid": multi_key_acid_workload,
    "ysql/append": _with(append_wl.workload, AppendClient),
    "ysql/append-table": _with(append_wl.workload, AppendTableClient),
    "ysql/default-value": default_value_workload,
}


def workload_for(name: str, opts: dict) -> dict:
    """Resolves 'api/workload' (or bare workload + --api opt) and pins
    the matching runner dialect onto the client."""
    if "/" not in name:
        name = f"{opts.get('api', 'ysql')}/{name}"
    api = name.split("/")[0]
    w = WORKLOADS[name](opts)
    w["client"].runner_factory = RUNNERS[api]
    return w, name


def nemesis_for(opts: dict, db) -> dict:
    from ..nemesis import combined

    faults = set(opts.get("faults") or ("partition", "kill"))
    o = dict(opts)
    o.update(db=db, faults=faults,
             interval=opts.get("nemesis_interval", 15))
    return combined.compose_packages(combined.nemesis_packages(o))


def yugabyte_test(opts: dict) -> dict:
    w, name = workload_for(opts.get("workload") or "ysql/append",
                           opts)
    db = YbDB(version=opts.get("version", VERSION),
              replicas=opts.get("replicas", 3))
    pkg = nemesis_for(opts, db)
    test = testing.noop_test()
    test.update(
        name=f"yugabyte-{name.replace('/', '-')}",
        os=debian.os,
        db=db,
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        nemesis=pkg["nemesis"],
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=_suite_generator(opts, w, pkg))
    for extra in ("total-amount", "accounts"):
        if extra in w:
            test[extra] = w[extra]
    return test


def _suite_generator(opts, w, pkg):
    nemesis_gen = pkg.get("generator")
    client_part = gen.stagger(1.0 / opts.get("rate", 15),
                              w["generator"])
    mix = gen.time_limit(
        opts.get("time_limit", 60),
        gen.clients(client_part, nemesis_gen)
        if nemesis_gen is not None else gen.clients(client_part))
    parts = [mix]
    final = w.get("final_generator")
    if final is not None:
        parts.append(gen.sleep(opts.get("recovery_time", 10)))
        parts.append(gen.clients(final))
    return parts[0] if len(parts) == 1 else gen.phases(*parts)


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="api/workload (default ysql/append). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--api", default="ysql", choices=("ysql", "ycql"),
                   help="API for bare workload names")
    p.add_argument("--rate", type=float, default=15)
    p.add_argument("--version", default=VERSION)
    p.add_argument("--replicas", type=int, default=3)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(yugabyte_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
