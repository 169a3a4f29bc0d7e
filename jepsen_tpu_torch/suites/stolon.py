"""Stolon test suite: HA PostgreSQL (keeper/sentinel/proxy over an
etcd store) checked with elle list-append and a double-spend ledger.

Capability reference: stolon/src/jepsen/stolon/db.clj — postgres-12 +
stolon release archive install (45-72), stolonctl with cluster
name/store flags (77-87), initial cluster spec with synchronous
replication (89-108), sentinel/keeper/proxy daemons (110-176,
node->pg-id naming), teardown grepkills postgres and wipes data
(280-295); stolon/append.clj (the elle workload, reused from the
postgres suite's client over the proxy port); stolon/ledger.clj —
transfer inserts a ledger row iff the account total stays non-negative
(57-69), per-account charitable balance check (140-165: indeterminate
deposits count, indeterminate withdrawals don't; the reference flags
any nonzero balance — an artifact of its all-accounts-start-at-zero
generator — while here the documented non-negativity invariant is
checked); stolon/nemesis.clj (partitions + keeper kills).

Clients talk to the stolon-proxy on THEIR OWN node (the reference's
jdbc spec does the same), so a partitioned proxy pointing at a
deposed primary is part of the test surface.

The port's copy of jepsen_tpu/suites/stolon.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import json
import logging
import re

from .. import checker as chk
from .. import cli, client as jclient, control, core, db as jdb
from .. import generator as gen
from .. import testing, util as jutil, workloads
from . import postgres as pg
from ..control import util as cu
from ..control.core import RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

DIR = "/opt/stolon"
DATA_DIR = f"{DIR}/data"
CLUSTER = "jepsen-cluster"
OS_USER = "postgres"
VERSION = "0.16.0"
PROXY_PORT = 25432
KEEPER_PG_PORT = 5433
ETCD_CLIENT_PORT = 2379

SENTINEL = ("stolon-sentinel", f"{DIR}/sentinel.log",
            f"{DIR}/sentinel.pid")
KEEPER = ("stolon-keeper", f"{DIR}/keeper.log", f"{DIR}/keeper.pid")
PROXY = ("stolon-proxy", f"{DIR}/proxy.log", f"{DIR}/proxy.pid")


def cluster_spec(test) -> dict:
    """Initial cluster spec (db.clj:89-108): synchronous replication,
    tight fail/proxy intervals."""
    return {
        "synchronousReplication": True,
        "initMode": "new",
        "sleepInterval": "1s",
        "requestTimeout": "2s",
        "failInterval": "4s",
        "proxyCheckInterval": "1s",
        "proxyTimeout": "3s",
        "deadKeeperRemovalInterval": "48h",
        "maxStandbysPerSender": len(test["nodes"]) - 1,
        "minSynchronousStandbys": 1,
        "maxSynchronousStandbys": 1,
    }


def pg_id(test, node) -> str:
    """node -> pg<i> (db.clj node->pg-id)."""
    return f"pg{list(test['nodes']).index(node) + 1}"


def store_endpoints(node) -> str:
    return f"http://{node}:{ETCD_CLIENT_PORT}"


def store_flags(node) -> list:
    return ["--cluster-name", CLUSTER,
            "--store-backend", "etcdv3",
            "--store-endpoints", store_endpoints(node)]


class StolonDB(jdb.DB):
    """postgres + etcd store + stolon keeper/sentinel/proxy per node
    (db.clj db, 230-295)."""

    supports_kill = True

    def __init__(self, version: str = VERSION, accounts: int = 8,
                 initial_balance: int = 10):
        self.version = version
        self.accounts = accounts
        self.initial_balance = initial_balance

    def setup(self, test, node):
        from . import etcd as etcd_suite

        logger.info("%s installing stolon %s", node, self.version)
        # the cluster store: a plain etcd member on every node
        etcd_suite.EtcdDB().setup(test, node)
        with control.su():
            debian.install(["postgresql-12", "postgresql-client-12"])
            control.exec_("service", "postgresql", "stop", check=False)
            cu.install_archive(
                "https://github.com/sorintlab/stolon/releases/"
                f"download/v{self.version}/stolon-v{self.version}"
                "-linux-amd64.tar.gz", DIR)
            control.exec_("mkdir", "-p", DATA_DIR)
            control.exec_("chown", "-R", f"{OS_USER}:{OS_USER}", DIR)
        self._start_sentinel(test, node)
        self._start_keeper(test, node)
        core.synchronize(test)
        self._start_proxy(test, node)
        core.synchronize(test)
        if node == primary(test):
            self._await_proxy()
            self._init_schema()
        core.synchronize(test)

    def _start_sentinel(self, test, node):
        spec = f"{DIR}/init-spec.json"
        with control.su(OS_USER):
            cu.write_file(json.dumps(cluster_spec(test)), spec)
            cu.start_daemon(
                {"chdir": DIR, "logfile": SENTINEL[1],
                 "pidfile": SENTINEL[2]},
                f"{DIR}/bin/{SENTINEL[0]}", *store_flags(node),
                "--initial-cluster-spec", spec)

    def _start_keeper(self, test, node):
        with control.su(OS_USER):
            cu.start_daemon(
                {"chdir": DIR, "logfile": KEEPER[1],
                 "pidfile": KEEPER[2]},
                f"{DIR}/bin/{KEEPER[0]}", *store_flags(node),
                "--uid", pg_id(test, node),
                "--data-dir", f"{DATA_DIR}/{pg_id(test, node)}",
                "--pg-su-password", pg.USER,
                "--pg-repl-username", "repluser",
                "--pg-repl-password", pg.USER,
                "--pg-listen-address", str(node),
                "--pg-port", str(KEEPER_PG_PORT),
                "--pg-bin-path", "/usr/lib/postgresql/12/bin")

    def _start_proxy(self, test, node):
        with control.su(OS_USER):
            cu.start_daemon(
                {"chdir": DIR, "logfile": PROXY[1],
                 "pidfile": PROXY[2]},
                f"{DIR}/bin/{PROXY[0]}", *store_flags(node),
                "--listen-address", "0.0.0.0",
                "--port", str(PROXY_PORT))

    def _psql_local(self, sql: str, check: bool = True) -> str:
        return control.exec_(
            "psql", "-h", "127.0.0.1", "-p", str(PROXY_PORT),
            "-U", "stolon", "-d", "postgres", "-X", "-q", "-A", "-t",
            "-c", sql, check=check)

    def _await_proxy(self):
        jutil.await_fn(lambda: self._psql_local("SELECT 1"),
                       timeout_secs=120, retry_interval=2,
                       log_message="waiting for stolon proxy")

    def _init_schema(self):
        ddl = [f"CREATE ROLE {pg.USER} LOGIN",
               f"CREATE DATABASE {pg.DBNAME} OWNER {pg.USER}"]
        for stmt in ddl:
            self._psql_local(stmt, check=False)
        tables = []
        for i in range(pg.TABLE_COUNT):
            tables.append(f"CREATE TABLE IF NOT EXISTS txn{i} ("
                          "id int NOT NULL PRIMARY KEY, val text)")
        tables.append("CREATE TABLE IF NOT EXISTS ledger ("
                      "id bigint PRIMARY KEY, account int NOT NULL, "
                      "amount int NOT NULL)")
        tables.append("CREATE INDEX IF NOT EXISTS i_account ON "
                      "ledger (account)")
        for stmt in tables:
            control.exec_(
                "psql", "-h", "127.0.0.1", "-p", str(PROXY_PORT),
                "-U", "stolon", "-d", pg.DBNAME, "-X", "-q", "-c",
                stmt, check=False)
        control.exec_(
            "psql", "-h", "127.0.0.1", "-p", str(PROXY_PORT),
            "-U", "stolon", "-d", pg.DBNAME, "-X", "-q", "-c",
            f"GRANT ALL ON ALL TABLES IN SCHEMA public TO {pg.USER}",
            check=False)

    def teardown(self, test, node):
        from . import etcd as etcd_suite

        logger.info("%s tearing down stolon", node)
        with control.su():
            for name, _log, pid in (PROXY, SENTINEL, KEEPER):
                cu.stop_daemon(name, pid)
            cu.grepkill("postgres")
            control.exec_("rm", "-rf", DATA_DIR)
        etcd_suite.EtcdDB().teardown(test, node)

    def log_files(self, test, node):
        return [SENTINEL[1], KEEPER[1], PROXY[1]]

    # stolon-keeper kills are the suite's signature fault
    # (stolon/nemesis.clj): the sentinel must fail postgres over
    def kill(self, test, node):
        with control.su():
            cu.stop_daemon(KEEPER[0], KEEPER[2])

    def start(self, test, node):
        self._start_keeper(test, node)


class ProxyPsql(pg.Psql):
    """psql against the node-local stolon proxy."""

    def __init__(self, test, node, host=None, timeout: float = 10.0,
                 port: int = PROXY_PORT):
        super().__init__(test, node, "127.0.0.1", timeout=timeout,
                         port=port)


class LedgerClient(jclient.Client):
    """ledger.clj transfer!: deposits insert unconditionally;
    withdrawals first sum the account's OTHER rows and only insert if
    the total stays non-negative — the read-then-insert shape that G2
    breaks into a double-spend. The row id comes from a per-process
    disjoint counter so concurrent inserts never collide."""

    def __init__(self, psql_factory=ProxyPsql,
                 isolation: str = "SERIALIZABLE"):
        self.psql_factory = psql_factory
        self.isolation = isolation
        self.psql = None
        self._next_id = 0

    def open(self, test, node):
        c = LedgerClient(self.psql_factory, self.isolation)
        c.psql = self.psql_factory(test, node)
        return c

    def setup(self, test):
        return self

    def close(self, test):
        if self.psql is not None:
            self.psql.close()

    def _row_id(self, op) -> int:
        # processes are globally unique; stride by 1M per process
        pid = op.process if isinstance(op.process, int) else 0
        self._next_id += 1
        return pid * 1_000_000 + self._next_id

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.psql.run(
                    "SELECT 'a=' || COALESCE(string_agg(account || "
                    "':' || total, ',' ORDER BY account), '') FROM "
                    "(SELECT account, SUM(amount) AS total FROM "
                    "ledger GROUP BY account) t;")
                m = re.search(r"a=(.*)$", out, re.M)
                if not m:
                    raise ValueError(f"unparseable read: {out!r}")
                balances = {}
                for part in m.group(1).split(","):
                    if part:
                        a, b = part.split(":")
                        balances[int(a)] = int(b)
                return op.copy(type="ok", value=balances)
            if op.f == "transfer":
                account, amount = op.value
                rid = self._row_id(op)
                if amount > 0:
                    self.psql.run(
                        f"BEGIN ISOLATION LEVEL {self.isolation}; "
                        f"INSERT INTO ledger VALUES "
                        f"({rid}, {int(account)}, {int(amount)}); "
                        "COMMIT;")
                    return op.copy(type="ok")
                out = self.psql.run(
                    f"BEGIN ISOLATION LEVEL {self.isolation}; "
                    f"SELECT 'bal=' || COALESCE(SUM(amount), 0) "
                    f"FROM ledger WHERE account = {int(account)} "
                    f"AND id != {rid}; "
                    f"INSERT INTO ledger SELECT {rid}, "
                    f"{int(account)}, {int(amount)} WHERE "
                    f"(SELECT COALESCE(SUM(amount), 0) FROM ledger "
                    f"WHERE account = {int(account)} AND id != {rid})"
                    f" + {int(amount)} >= 0; "
                    f"SELECT 'n=' || COUNT(*) FROM ledger WHERE "
                    f"id = {rid}; COMMIT;")
                m = re.search(r"n=(\d+)", out)
                if not m:
                    raise ValueError(f"unparseable transfer: {out!r}")
                if m.group(1) == "1":
                    return op.copy(type="ok")
                return op.copy(type="fail",
                               error="insufficient funds")
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            if op.f == "read":
                return op.copy(type="fail", error=str(e)[:200])
            return pg.classify_error(op, e)


def check_ledger(hist) -> dict:
    """ledger.clj check-account (140-153): per-account, charitable
    interpretation — ok+info deposits count, only ok withdrawals do;
    the resulting balance must be non-negative."""
    accounts: dict = {}
    for op in hist:
        if op.f != "transfer" or op.type not in ("ok", "info"):
            continue
        account, amount = op.value
        if amount > 0 or op.type == "ok":
            accounts[account] = accounts.get(account, 0) + amount
    errors = [{"account": a, "balance": b}
              for a, b in sorted(accounts.items()) if b < 0]
    return {"valid?": not errors, "errors": errors,
            "account-count": len(accounts)}


def ledger_checker() -> chk.Checker:
    return chk.checker(lambda test, hist, opts: check_ledger(hist))


class _LedgerGen(gen.Generator):
    """fund-then-double-spend (ledger.clj:167-175): per account, one
    +10 deposit then a burst of -9 withdrawals racing to double-spend.
    Functional successor; the burst size derives from (seed, account)."""

    def __init__(self, seed=None, account: int = 0, remaining=None):
        self.seed = seed
        self.account = account
        self.remaining = remaining

    def op(self, test, ctx):
        if self.remaining is None:
            rng = jutil.seeded_rng(self.seed, self.account)
            burst = 2 ** rng.randrange(5)
            m = gen.fill_in_op(
                {"f": "transfer", "value": [self.account, 10]}, ctx)
            if m is gen.PENDING:
                return gen.PENDING, self
            return m, _LedgerGen(self.seed, self.account, burst)
        if self.remaining == 0:
            return _LedgerGen(self.seed, self.account + 1).op(
                test, ctx)
        m = gen.fill_in_op(
            {"f": "transfer", "value": [self.account, -9]}, ctx)
        if m is gen.PENDING:
            return gen.PENDING, self
        return m, _LedgerGen(self.seed, self.account,
                             self.remaining - 1)

    def update(self, test, ctx, event):
        return self


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def append_workload(opts: dict) -> dict:
    w = workloads.txn_append.workload(
        {"ops": opts.get("ops", 2000),
         "key-count": opts.get("keys", 6),
         "seed": opts.get("seed"),
         "device": opts.get("device")})
    w["client"] = pg.PgAppendClient(
        psql_factory=ProxyPsql,
        isolation=opts.get("isolation", "SERIALIZABLE"))
    return w


def ledger_workload(opts: dict) -> dict:
    return {
        "client": LedgerClient(
            isolation=opts.get("isolation", "SERIALIZABLE")),
        "generator": gen.limit(opts.get("ops", 400),
                               _LedgerGen(seed=opts.get("seed"))),
        "checker": ledger_checker(),
    }


WORKLOADS = {"append": append_workload, "ledger": ledger_workload}


def nemesis_for(opts: dict, db) -> dict:
    """Partitions + keeper kills through the package system
    (stolon/nemesis.clj's menu); DbNemesis' kill routes to
    StolonDB.kill = stop the keeper, so the sentinel must fail
    postgres over to a standby."""
    from ..nemesis import combined

    faults = set(opts.get("faults") or ("partition", "kill"))
    o = dict(opts)
    o.update(db=db, faults=faults,
             interval=opts.get("nemesis_interval", 10))
    return combined.compose_packages(combined.nemesis_packages(o))


def stolon_test(opts: dict) -> dict:
    name = opts.get("workload") or "append"
    w = WORKLOADS[name](opts)
    db = StolonDB(version=opts.get("version", VERSION))
    pkg = nemesis_for(opts, db)
    test = testing.noop_test()
    test.update(
        name=f"stolon-{name}",
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
    return test


def _suite_generator(opts, w, pkg):
    nemesis_gen = pkg.get("generator")
    client_part = gen.stagger(1.0 / opts.get("rate", 20),
                              w["generator"])
    mix = gen.time_limit(
        opts.get("time_limit", 60),
        gen.clients(client_part, nemesis_gen)
        if nemesis_gen is not None else gen.clients(client_part))
    parts = [mix]
    final_nem = pkg.get("final_generator")
    if final_nem:
        parts.append(gen.nemesis(final_nem))
    final = w.get("final_generator")
    if final is not None:
        parts.append(gen.sleep(opts.get("recovery_time", 10)))
        parts.append(gen.clients(final))
    return parts[0] if len(parts) == 1 else gen.phases(*parts)


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default append). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--rate", type=float, default=20)
    p.add_argument("--version", default=VERSION)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(stolon_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
