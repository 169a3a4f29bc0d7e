"""TiDB test suite: elle list-append, bank and long-fork over the
mysql CLI against a pd/tikv/tidb cluster.

Capability reference: tidb/src/tidb/ — db.clj (one tarball shipping
pd-server/tikv-server/tidb-server; pd forms the quorum with
initial-cluster urls, tikv registers with pd, tidb fronts the mysql
protocol on port 4000), core.clj:32-60 (the canonical workloads map +
sweep shape), txn.clj/bank.clj/long_fork.clj (workload semantics).
The reference drives JDBC; here every transaction is one
`mysql -h <node> -P 4000` batch on the client's own node, with
tagged SELECTs carrying read results (the postgres/galera suite
transport stance — TiDB speaks the mysql dialect, so appends use
INSERT .. ON DUPLICATE KEY UPDATE CONCAT).

The port's copy of jepsen_tpu/suites/tidb.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging
import re

from .. import checker as chk
from .. import cli, client as jclient, control, core, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing, util as jutil, workloads
from . import common
from ..control import util as cu
from ..control.core import RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "v7.5.1"
DIR = "/opt/tidb"
PD_PORT = 2379
PD_PEER_PORT = 2380
KV_PORT = 20160
SQL_PORT = 4000
DB_NAME = "jepsen"
TABLE_COUNT = 3


def pd_initial_cluster(test) -> str:
    return ",".join(f"pd-{n}=http://{n}:{PD_PEER_PORT}"
                    for n in test["nodes"])


def pd_endpoints(test) -> str:
    return ",".join(f"{n}:{PD_PORT}" for n in test["nodes"])


class TidbDB(jdb.DB):
    """pd -> tikv -> tidb daemon stack per node (tidb/db.clj)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start_all(self, test, node):
        cu.start_daemon(
            {"logfile": f"{DIR}/pd.log", "pidfile": f"{DIR}/pd.pid",
             "chdir": DIR},
            f"{DIR}/bin/pd-server",
            "--name", f"pd-{node}",
            "--data-dir", f"{DIR}/data/pd",
            "--client-urls", f"http://0.0.0.0:{PD_PORT}",
            "--advertise-client-urls", f"http://{node}:{PD_PORT}",
            "--peer-urls", f"http://0.0.0.0:{PD_PEER_PORT}",
            "--advertise-peer-urls", f"http://{node}:{PD_PEER_PORT}",
            "--initial-cluster", pd_initial_cluster(test))
        cu.await_tcp_port(PD_PORT, timeout_secs=120)
        cu.start_daemon(
            {"logfile": f"{DIR}/tikv.log", "pidfile": f"{DIR}/tikv.pid",
             "chdir": DIR},
            f"{DIR}/bin/tikv-server",
            "--pd", pd_endpoints(test),
            "--addr", f"0.0.0.0:{KV_PORT}",
            "--advertise-addr", f"{node}:{KV_PORT}",
            "--data-dir", f"{DIR}/data/tikv")
        cu.await_tcp_port(KV_PORT, timeout_secs=120)
        cu.start_daemon(
            {"logfile": f"{DIR}/tidb.log", "pidfile": f"{DIR}/tidb.pid",
             "chdir": DIR},
            f"{DIR}/bin/tidb-server",
            "-P", str(SQL_PORT),
            "--store", "tikv",
            "--path", pd_endpoints(test))
        cu.await_tcp_port(SQL_PORT, timeout_secs=180)

    def setup(self, test, node):
        logger.info("%s installing tidb %s", node, self.version)
        with control.su():
            debian.install(["mariadb-client"])  # the mysql CLI
            # the plain binary bundle (bin/{pd,tikv,tidb}-server),
            # NOT the tidb-community-server TiUP offline mirror whose
            # payload is nested per-component tarballs
            url = (f"https://download.pingcap.org/tidb-"
                   f"{self.version}-linux-amd64.tar.gz")
            cu.install_archive(url, DIR)
            self._start_all(test, node)
        core.synchronize(test)
        if node == primary(test):
            self._schema(node)
        core.synchronize(test)

    def _schema(self, node):
        stmts = [f"CREATE DATABASE IF NOT EXISTS {DB_NAME}"]
        for i in range(TABLE_COUNT):
            stmts.append(
                f"CREATE TABLE IF NOT EXISTS {DB_NAME}.txn{i} "
                "(id INT NOT NULL PRIMARY KEY, val TEXT)")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {DB_NAME}.accounts "
                     "(id INT NOT NULL PRIMARY KEY, "
                     "balance BIGINT NOT NULL)")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {DB_NAME}.lf "
                     "(k INT NOT NULL PRIMARY KEY, val INT)")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {DB_NAME}.registers"
                     " (id INT NOT NULL PRIMARY KEY, val INT)")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {DB_NAME}.sets "
                     "(id INT AUTO_INCREMENT PRIMARY KEY, val INT)")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {DB_NAME}.setcas "
                     "(id INT NOT NULL PRIMARY KEY, val TEXT)")
        stmts.append(f"INSERT IGNORE INTO {DB_NAME}.setcas "
                     "VALUES (0, '')")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {DB_NAME}.seq "
                     "(sk VARCHAR(64) NOT NULL PRIMARY KEY)")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {DB_NAME}.mono "
                     "(val INT NOT NULL PRIMARY KEY, sts BIGINT, "
                     "node VARCHAR(16), process INT, tb INT)")
        for i in range(8):
            stmts.append(
                f"CREATE TABLE IF NOT EXISTS {DB_NAME}.bank{i} "
                "(id INT NOT NULL PRIMARY KEY, "
                "balance BIGINT NOT NULL)")
            stmts.append(f"INSERT IGNORE INTO {DB_NAME}.bank{i} "
                         "VALUES (0, 10)")
        rows = ",".join(f"({i}, 10)" for i in range(8))
        stmts.append(f"INSERT IGNORE INTO {DB_NAME}.accounts "
                     f"VALUES {rows}")
        for s in stmts:
            control.exec_("mysql", "-h", str(node), "-P",
                          str(SQL_PORT), "-u", "root", "-e", s)

    def teardown(self, test, node):
        logger.info("%s tearing down tidb", node)
        with control.su():
            for d in ("tidb", "tikv", "pd"):
                cu.grepkill(f"{d}-server")
            control.exec_("rm", "-rf", DIR)

    def kill(self, test, node):
        with control.su():
            for d in ("tidb", "tikv", "pd"):
                cu.grepkill(f"{d}-server")
        return "killed"

    def start(self, test, node):
        with control.su():
            self._start_all(test, node)
        return "started"

    def log_files(self, test, node):
        return [f"{DIR}/pd.log", f"{DIR}/tikv.log", f"{DIR}/tidb.log"]


# ---------------------------------------------------------------------------
# mysql transport
# ---------------------------------------------------------------------------

class TidbSql(common.SqlCli):
    """mysql batches against the node's tidb-server (mysql protocol,
    passwordless root)."""

    def __init__(self, test, node, timeout: float = 10.0):
        super().__init__(
            test, node,
            ["mysql", "-h", str(node), "-P", str(SQL_PORT),
             "-u", "root", "-D", DB_NAME, "-N", "-B", "-e"],
            timeout=timeout)


_classify = common.make_classifier([
    r"write conflict", r"deadlock", r"try again later",
    r"can't connect", r"connection refused",
    r"region is unavailable"])


def table_for(k) -> str:
    return f"txn{int(k) % TABLE_COUNT}"


class TidbTxnClient(jclient.Client):
    """Generic micro-op txn client for append AND long-fork mops:
    one BEGIN .. COMMIT batch, tagged SELECTs carrying reads.
    Append values join with ',' like stolon's CONCAT upsert; long-fork
    writes set the lf key."""

    def __init__(self, sql_factory=TidbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = TidbTxnClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def _mop_sql(self, i, f, k, v) -> str:
        if f == "r":
            t = table_for(k)
            return (f"SELECT CONCAT('m{i}=', COALESCE("
                    f"(SELECT val FROM {t} WHERE id = {int(k)}), "
                    f"'~'))")
        if f == "append":
            t = table_for(k)
            return (f"INSERT INTO {t} (id, val) VALUES "
                    f"({int(k)}, '{int(v)}') ON DUPLICATE KEY "
                    f"UPDATE val = CONCAT(val, ',', '{int(v)}')")
        if f == "w":  # long-fork single-key write
            return (f"INSERT INTO lf (k, val) VALUES "
                    f"({int(k)}, {int(v)}) ON DUPLICATE KEY "
                    f"UPDATE val = {int(v)}")
        if f == "r-lf":
            return (f"SELECT CONCAT('m{i}=', COALESCE("
                    f"(SELECT val FROM lf WHERE k = {int(k)}), '~'))")
        raise ValueError(f"unknown mop {f!r}")

    def invoke(self, test, op):
        mops = op.value
        lf = table_is_lf(test)
        stmts = []
        for i, (f, k, v) in enumerate(mops):
            f2 = "r-lf" if lf and f == "r" else f
            stmts.append(self._mop_sql(i, f2, k, v))
        sql = "BEGIN; " + "; ".join(stmts) + "; COMMIT;"
        try:
            out = self.sql.run(sql)
        except RemoteError as e:
            return _classify(op, e)
        reads = {}
        for line in out.splitlines():
            m = re.match(r"m(\d+)=(.*)$", line.strip())
            if m:
                raw = m.group(2)
                reads[int(m.group(1))] = raw
        done = []
        for i, (f, k, v) in enumerate(mops):
            if f == "r":
                raw = reads.get(i)
                if raw is None or raw == "~":
                    done.append(["r", k, None])
                elif lf:
                    done.append(["r", k, int(raw)])
                else:
                    done.append(
                        ["r", k,
                         [int(x) for x in raw.split(",") if x]])
            else:
                done.append([f, k, v])
        return op.copy(type="ok", value=done)


def table_is_lf(test) -> bool:
    """The long-fork workload routes reads at the lf table via the
    test map's 'lf-table' flag."""
    return bool((test or {}).get("lf-table"))


class TidbBankClient(jclient.Client):
    """Bank transfers with the galera-style SQL-variable guard (bank
    conservation under tidb's optimistic txns; tidb/bank.clj)."""

    def __init__(self, sql_factory=TidbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = TidbBankClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.sql.run(
                    "SELECT CONCAT('b=', COALESCE(GROUP_CONCAT("
                    "CONCAT(id, ':', balance) ORDER BY id "
                    "SEPARATOR ','), '')) FROM accounts;")
                m = re.search(r"b=(.*)$", out, re.M)
                if not m:
                    raise ValueError(f"unparseable read: {out!r}")
                balances = {}
                for part in m.group(1).split(","):
                    if part:
                        i, b = part.split(":")
                        balances[int(i)] = int(b)
                return op.copy(type="ok", value=balances)
            if op.f == "transfer":
                v = op.value
                f, t, a = (int(v["from"]), int(v["to"]),
                           int(v["amount"]))
                out = self.sql.run(
                    "BEGIN; "
                    f"SELECT balance INTO @b1 FROM accounts "
                    f"WHERE id = {f} FOR UPDATE; "
                    f"UPDATE accounts SET balance = balance - {a} "
                    f"WHERE id = {f} AND @b1 >= {a}; "
                    f"UPDATE accounts SET balance = balance + {a} "
                    f"WHERE id = {t} AND @b1 >= {a}; "
                    f"SELECT CONCAT('applied=', "
                    f"IF(@b1 >= {a}, 1, 0)); "
                    "COMMIT;")
                m = re.search(r"applied=(\d)", out)
                if not m:
                    raise ValueError(f"unparseable transfer: {out!r}")
                if m.group(1) == "1":
                    return op.copy(type="ok")
                return op.copy(type="fail", error="insufficient funds")
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test (tidb/core.clj:32-60 shape)
# ---------------------------------------------------------------------------

def append_workload(opts: dict) -> dict:
    w = workloads.txn_append.workload(
        {"ops": opts.get("ops", 2000),
         "key-count": opts.get("keys", 6),
         "seed": opts.get("seed"),
         "device": opts.get("device")})
    w["client"] = TidbTxnClient()
    return w


def bank_workload(opts: dict) -> dict:
    from ..workloads import bank

    total = 8 * 10
    return {
        "client": TidbBankClient(),
        "generator": bank.generator(accounts=list(range(8)),
                                    seed=opts.get("seed")),
        "checker": chk.checker(
            lambda test, hist, o: bank.check_fast(
                hist, total, device=opts.get("device"))),
    }


def long_fork_workload(opts: dict) -> dict:
    w = workloads.long_fork.workload({"ops": opts.get("ops", 600)})
    w["client"] = TidbTxnClient()
    w["lf-table"] = True
    return w


class TidbRegisterClient(jclient.Client):
    """Per-key read/write/cas register rows (tidb/register.clj: a
    single-row compare-and-set over the registers table)."""

    def __init__(self, sql_factory=TidbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = TidbRegisterClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        k, v = op.value
        try:
            if op.f == "read":
                out = self.sql.run(
                    "SELECT CONCAT('v=', COALESCE((SELECT val FROM "
                    f"registers WHERE id = {int(k)}), '~'));")
                m = re.search(r"v=(.*)$", out, re.M)
                raw = m.group(1) if m else "~"
                return op.copy(type="ok", value=(
                    k, None if raw == "~" else int(raw)))
            if op.f == "write":
                self.sql.run(
                    f"INSERT INTO registers (id, val) VALUES "
                    f"({int(k)}, {int(v)}) ON DUPLICATE KEY UPDATE "
                    f"val = {int(v)};")
                return op.copy(type="ok")
            old_v, new_v = v
            out = self.sql.run(
                f"UPDATE registers SET val = {int(new_v)} WHERE "
                f"id = {int(k)} AND val = {int(old_v)}; "
                "SELECT CONCAT('n=', ROW_COUNT());")
            m = re.search(r"n=(-?\d+)", out)
            if m and int(m.group(1)) > 0:
                return op.copy(type="ok")
            return op.copy(type="fail", error="cas mismatch")
        except RemoteError as e:
            return _classify(op, e)


class TidbSetClient(jclient.Client):
    """Adds via plain inserts (tidb/set.clj workload) or via CAS
    append on one text blob row (set.clj cas-workload), reads all."""

    def __init__(self, sql_factory=TidbSql, cas: bool = False):
        self.sql_factory = sql_factory
        self.cas = cas
        self.sql = None

    def open(self, test, node):
        c = TidbSetClient(self.sql_factory, self.cas)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "add":
                if self.cas:
                    self.sql.run(
                        "BEGIN; SELECT val INTO @v FROM setcas WHERE "
                        "id = 0 FOR UPDATE; UPDATE setcas SET val = "
                        f"CONCAT(@v, ',', '{int(op.value)}') WHERE "
                        "id = 0; COMMIT;")
                else:
                    self.sql.run("INSERT INTO sets (val) VALUES "
                                 f"({int(op.value)});")
                return op.copy(type="ok")
            if self.cas:
                out = self.sql.run("SELECT CONCAT('s=', val) FROM "
                                   "setcas WHERE id = 0;")
                m = re.search(r"s=(.*)$", out, re.M)
                raw = m.group(1) if m else ""
                vals = sorted(int(x) for x in raw.split(",") if x)
            else:
                out = self.sql.run("SELECT val FROM sets;")
                vals = sorted(int(x) for x in out.split()
                              if x.strip().lstrip('-').isdigit())
            return op.copy(type="ok", value=vals)
        except RemoteError as e:
            return _classify(op, e)


class TidbSequentialClient(jclient.Client):
    """sequential.clj contract: write k inserts each subkey in its own
    txn, read walks them reversed (see workloads.sequential)."""

    def __init__(self, sql_factory=TidbSql, key_count: int = 5):
        self.sql_factory = sql_factory
        self.key_count = key_count
        self.sql = None

    def open(self, test, node):
        c = TidbSequentialClient(self.sql_factory, self.key_count)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        from ..workloads import sequential as seq_wl

        try:
            if op.f == "write":
                for sk in seq_wl.subkeys(self.key_count, op.value):
                    self.sql.run("INSERT IGNORE INTO seq (sk) VALUES "
                                 f"('{sk}');")
                return op.copy(type="ok")
            obs = []
            for sk in reversed(seq_wl.subkeys(self.key_count,
                                              op.value)):
                out = self.sql.run(
                    f"SELECT CONCAT('x=', COUNT(*)) FROM seq "
                    f"WHERE sk = '{sk}';")
                m = re.search(r"x=(\d+)", out)
                obs.append(sk if m and int(m.group(1)) else None)
            return op.copy(type="ok", value=(op.value, obs))
        except RemoteError as e:
            return _classify(op, e)


class TidbMonotonicClient(jclient.Client):
    """monotonic.clj contract: add reads MAX(val), inserts max+1 with
    the txn's commit timestamp (@@tidb_current_ts); final read returns
    rows ordered by sts (see workloads.monotonic)."""

    def __init__(self, sql_factory=TidbSql):
        self.sql_factory = sql_factory
        self.sql = None
        self.node = None

    def open(self, test, node):
        c = TidbMonotonicClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        c.node = node
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "add":
                out = self.sql.run(
                    "BEGIN; SELECT COALESCE(MAX(val), 0) + 1, "
                    "@@tidb_current_ts INTO @v, @ts FROM mono; "
                    "INSERT INTO mono (val, sts, node, process, tb) "
                    f"VALUES (@v, @ts, '{self.node}', "
                    f"{int(op.process)}, 0); "
                    "SELECT CONCAT('row=', @v, ':', @ts); COMMIT;")
                m = re.search(r"row=(\d+):(\d+)", out)
                if not m:
                    raise ValueError(f"unparseable add: {out!r}")
                return op.copy(type="ok", value={
                    "val": int(m.group(1)), "sts": int(m.group(2)),
                    "node": self.node, "process": op.process,
                    "tb": 0})
            out = self.sql.run(
                "SELECT CONCAT('r=', val, ':', sts, ':', node, ':', "
                "process, ':', tb) FROM mono ORDER BY sts, val;")
            rows = []
            for mm in re.finditer(
                    r"r=(\d+):(\d+):([\w.-]+):(\d+):(\d+)", out):
                rows.append({"val": int(mm.group(1)),
                             "sts": int(mm.group(2)),
                             "node": mm.group(3),
                             "process": int(mm.group(4)),
                             "tb": int(mm.group(5))})
            return op.copy(type="ok", value=rows)
        except RemoteError as e:
            return _classify(op, e)


class TidbTableClient(jclient.Client):
    """table.clj client: create-table / insert; an insert hitting
    'doesn't exist' for an acked table is the bug."""

    def __init__(self, sql_factory=TidbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = TidbTableClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "create-table":
                self.sql.run(
                    f"CREATE TABLE IF NOT EXISTS t{int(op.value)} "
                    "(id INT NOT NULL PRIMARY KEY, val INT);")
                return op.copy(type="ok")
            table, k = op.value
            try:
                self.sql.run(f"INSERT INTO t{int(table)} (id) "
                             f"VALUES ({int(k)});")
                return op.copy(type="ok")
            except RemoteError as e:
                msg = str(e)
                if re.search(r"doesn't exist", msg):
                    return op.copy(type="fail", error="doesn't-exist")
                if re.search(r"[Dd]uplicate", msg):
                    return op.copy(type="fail", error="duplicate-key")
                raise
        except RemoteError as e:
            return _classify(op, e)


class _TableGen(gen.Generator):
    """table.clj generator: mostly insert into the last table whose
    create COMPLETED ok; otherwise create the next table id. State
    feeds from completion events via update(), never from probes."""

    __slots__ = ("next_id", "created", "rng_seed", "n")

    def __init__(self, next_id: int = 1, created: int | None = None,
                 rng_seed=None, n: int = 0):
        self.next_id = next_id
        self.created = created
        self.rng_seed = rng_seed
        self.n = n

    def _rng(self):
        return jutil.seeded_rng(
            self.rng_seed if self.rng_seed is not None
            else "tidb-table", self.n)

    def op(self, test, ctx):
        insert = (self.created is not None
                  and self._rng().random() < 0.8)
        if insert:
            m = gen.fill_in_op(
                {"f": "insert",
                 "value": [self.created, self.n]}, ctx)
            if m is gen.PENDING:
                return gen.PENDING, self
            return m, _TableGen(self.next_id, self.created,
                                self.rng_seed, self.n + 1)
        m = gen.fill_in_op(
            {"f": "create-table", "value": self.next_id}, ctx)
        if m is gen.PENDING:
            return gen.PENDING, self
        return m, _TableGen(self.next_id + 1, self.created,
                            self.rng_seed, self.n + 1)

    def update(self, test, ctx, event):
        if (event.type == "ok" and event.f == "create-table"
                and (self.created is None
                     or event.value > self.created)):
            return _TableGen(self.next_id, event.value,
                             self.rng_seed, self.n)
        return self


def check_tables(hist) -> dict:
    """table.clj checker: no insert may fail with doesn't-exist."""
    bad = [op for op in hist
           if op.type == "fail" and op.get("error") == "doesn't-exist"]
    return {"valid?": not bad,
            "errors": [o.to_dict() for o in bad[:8]]}


def register_workload(opts: dict) -> dict:
    w = workloads.register.workload(
        {"keys": opts.get("keys", list(range(8))),
         "ops_per_key": opts.get("ops_per_key", 60),
         "group_size": opts.get("group_size", 5),
         "seed": opts.get("seed"),
         "device": opts.get("device")})
    w["client"] = TidbRegisterClient()
    return w


def set_workload(opts: dict) -> dict:
    w = workloads.sets.workload({"ops": opts.get("ops", 400)})
    w["client"] = TidbSetClient()
    return w


def set_cas_workload(opts: dict) -> dict:
    w = workloads.sets.workload({"ops": opts.get("ops", 400)})
    w["client"] = TidbSetClient(cas=True)
    return w


def sequential_workload(opts: dict) -> dict:
    from ..workloads import sequential as seq_wl

    w = seq_wl.workload(dict(opts))
    w["client"] = TidbSequentialClient(
        key_count=opts.get("key-count", 5))
    return w


def monotonic_workload(opts: dict) -> dict:
    from ..workloads import monotonic as mono_wl

    w = mono_wl.workload(dict(opts))
    w["client"] = TidbMonotonicClient()
    return w


def txn_cycle_workload(opts: dict) -> dict:
    """monotonic.clj txn-workload: elle rw-register cycle search over
    generic read/write txns (the lf table carries single-int cells)."""
    w = workloads.txn_wr.workload(
        {"ops": opts.get("ops", 600), "seed": opts.get("seed"),
         "device": opts.get("device")})
    w["client"] = TidbTxnClient()
    w["lf-table"] = True
    return w


def table_workload(opts: dict) -> dict:
    return {
        "generator": gen.limit(opts.get("ops", 200), _TableGen(
            rng_seed=opts.get("seed"))),
        "checker": chk.checker(
            lambda test, hist, o: check_tables(hist)),
        "client": TidbTableClient(),
    }


class TidbMultiBankClient(jclient.Client):
    """bank.clj multitable-workload: one bankN table per account;
    reads union all tables in ONE statement (one snapshot), transfers
    span two tables under the SQL-variable guard."""

    def __init__(self, sql_factory=TidbSql):
        self.sql_factory = sql_factory
        self.sql = None

    def open(self, test, node):
        c = TidbMultiBankClient(self.sql_factory)
        c.sql = self.sql_factory(test, node)
        return c

    def close(self, test):
        if self.sql is not None:
            self.sql.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                union = " UNION ALL ".join(
                    f"SELECT {i} AS id, balance FROM bank{i} "
                    "WHERE id = 0" for i in range(8))
                out = self.sql.run(
                    "SELECT CONCAT('b=', GROUP_CONCAT(CONCAT(id, "
                    f"':', balance) ORDER BY id SEPARATOR ',')) "
                    f"FROM ({union}) t;")
                m = re.search(r"b=(.*)$", out, re.M)
                if not m:
                    raise ValueError(f"unparseable read: {out!r}")
                balances = {}
                for part in m.group(1).split(","):
                    if part:
                        i, b = part.split(":")
                        balances[int(i)] = int(b)
                return op.copy(type="ok", value=balances)
            v = op.value
            f, t, a = (int(v["from"]), int(v["to"]), int(v["amount"]))
            out = self.sql.run(
                "BEGIN; "
                f"SELECT balance INTO @b1 FROM bank{f} "
                "WHERE id = 0 FOR UPDATE; "
                f"UPDATE bank{f} SET balance = balance - {a} "
                f"WHERE id = 0 AND @b1 >= {a}; "
                f"UPDATE bank{t} SET balance = balance + {a} "
                f"WHERE id = 0 AND @b1 >= {a}; "
                f"SELECT CONCAT('applied=', IF(@b1 >= {a}, 1, 0)); "
                "COMMIT;")
            m = re.search(r"applied=(\d)", out)
            if not m:
                raise ValueError(f"unparseable transfer: {out!r}")
            if m.group(1) == "1":
                return op.copy(type="ok")
            return op.copy(type="fail", error="insufficient funds")
        except RemoteError as e:
            return _classify(op, e)


def bank_multitable_workload(opts: dict) -> dict:
    w = bank_workload(opts)
    w["client"] = TidbMultiBankClient()
    return w


WORKLOADS = {"append": append_workload,
             "bank": bank_workload,
             "bank-multitable": bank_multitable_workload,
             "long-fork": long_fork_workload,
             "monotonic": monotonic_workload,
             "txn-cycle": txn_cycle_workload,
             "register": register_workload,
             "set": set_workload,
             "set-cas": set_cas_workload,
             "sequential": sequential_workload,
             "table": table_workload}


def all_tests(opts: dict):
    """Workload x fault sweep (tidb/core.clj:47-60)."""
    names = ([opts["workload"]] if opts.get("workload")
             else sorted(WORKLOADS))
    fault_options = ([opts["faults"]] if opts.get("faults") is not None
                     else ([], ["partition"], ["kill"]))
    for _ in range(opts.get("test_count") or 1):
        for name in names:
            for faults in fault_options:
                yield tidb_test({**opts, "workload": name,
                                 "faults": list(faults)})


def nemesis_for(opts: dict, db) -> dict:
    """--nemesis faults compose through the package system so 'kill'
    really drives DB.kill/start (etcd's nemesis_for shape); empty =
    the classic partitioner schedule."""
    from ..nemesis import combined

    faults = set(opts.get("faults") or ())
    if not faults:
        return {"nemesis": jnemesis.partition_random_halves(),
                "generator": jnemesis.start_stop_cycle(10.0),
                "final_generator": None}
    pkgs = combined.nemesis_packages(
        {**opts, "db": db, "faults": faults,
         "interval": opts.get("nemesis_interval", 10)})
    return combined.compose_packages(pkgs)


def tidb_test(opts: dict) -> dict:
    name = opts.get("workload") or "append"
    w = WORKLOADS[name](opts)
    db = TidbDB(opts.get("version", VERSION))
    pkg = nemesis_for(opts, db)
    main = gen.time_limit(
        opts.get("time_limit", 30),
        gen.clients(
            gen.stagger(1.0 / opts.get("rate", 20), w["generator"]),
            pkg["generator"]))
    final = pkg.get("final_generator")
    generator = gen.phases(main, gen.nemesis(final)) if final \
        else main
    test = testing.noop_test()
    test.update(
        name=f"tidb-{name}",
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
        generator=generator)
    if w.get("lf-table"):
        test["lf-table"] = True
    return test


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default append). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="tidb community-server version.")
    p.add_argument("--rate", type=float, default=20)
    p.add_argument("--nemesis", dest="faults", default=None,
                   help="Comma-separated fault list for test-all.")
    return p


def _opt_fn(opts: dict) -> dict:
    if opts.get("faults"):
        opts["faults"] = [f.strip()
                          for f in opts["faults"].split(",")
                          if f.strip()]
    return opts


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(tidb_test, parser_fn=_opts,
                                        opt_fn=_opt_fn))
    commands.update(cli.test_all_cmd(all_tests, parser_fn=_opts,
                                     opt_fn=_opt_fn))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
