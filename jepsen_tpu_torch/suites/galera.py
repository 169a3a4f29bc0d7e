"""MariaDB Galera test suite: multi-master bank transfers and set
inserts, every client talking to its OWN node's mysqld.

Capability reference: galera/src/jepsen/galera.clj — DB: mariadb
repo + debconf root password + package install with a stashed stock
datadir (34-56), jepsen.cnf with the gcomm:// cluster address
(58-72), primary starts --wsrep-new-cluster and the rest join between
synchronize barriers (104-121), jepsen database + grant (93-101),
teardown restores the stock datadir (123-128); bank client: read
balances / read-check-update transfer inside one txn, negative
balances refused client-side (240-303); set client: insert-per-value
+ final read (215-238). The reference's JDBC conn-spec targets the
client's own node (90-96) — Galera is multi-master, which is exactly
what the bank test stresses. Here ops go through `mysql -e` on the
node, one batch per transaction, with SQL variables carrying the
read-check-update logic so the whole transfer stays one atomic
round trip.

The port's copy of jepsen_tpu/suites/galera.py: the same host code, with
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
from .. import testing
from . import common
from ..control import util as cu
from ..control.core import RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

DATA_DIR = "/var/lib/mysql"
STOCK_DIR = "/var/lib/mysql-stock"
CNF = "/etc/mysql/conf.d/jepsen.cnf"
LOGFILE = "/var/log/mysql/error.log"
USER = "jepsen"
PASSWORD = "jepsen"
DB_NAME = "jepsen"

JEPSEN_CNF = """[mysqld]
bind-address=0.0.0.0
wsrep_on=ON
wsrep_provider=/usr/lib/galera/libgalera_smm.so
wsrep_cluster_address={cluster}
wsrep_cluster_name=jepsen
binlog_format=ROW
default_storage_engine=InnoDB
innodb_autoinc_lock_mode=2
"""


def cluster_address(test) -> str:
    """gcomm://n1,n2,... (galera.clj:58-62)."""
    return "gcomm://" + ",".join(str(n) for n in test["nodes"])


class GaleraDB(jdb.DB):
    """mariadb-galera cluster (galera.clj db, 104-128)."""

    def __init__(self, accounts: int = 8, initial_balance: int = 10):
        self.accounts = accounts
        self.initial_balance = initial_balance

    def setup(self, test, node):
        logger.info("%s installing mariadb-galera", node)
        with control.su():
            debian.add_repo(
                "galera",
                "deb http://mirror.mariadb.org/repo/10.0/debian "
                "jessie main",
                "keyserver.ubuntu.com", "0xcbcb082a1bb943db")
            for line in (
                    "mariadb-galera-server-10.0 mysql-server/"
                    f"root_password password {PASSWORD}",
                    "mariadb-galera-server-10.0 mysql-server/"
                    f"root_password_again password {PASSWORD}"):
                control.exec_("sh", "-c",
                              f"echo {line!r} | debconf-set-selections")
            debian.install(["rsync", "mariadb-galera-server"])
            control.exec_("service", "mysql", "stop", check=False)
            # stash pristine data files for teardown restore
            control.exec_("sh", "-c",
                          f"test -d {STOCK_DIR} || "
                          f"cp -rp {DATA_DIR} {STOCK_DIR}")
            cnf = JEPSEN_CNF.format(cluster=cluster_address(test))
            cu.write_file(cnf, CNF)
            if node == primary(test):
                control.exec_("service", "mysql", "start",
                              "--wsrep-new-cluster")
        core.synchronize(test)  # the new cluster exists before joins
        with control.su():
            if node != primary(test):
                control.exec_("service", "mysql", "start")
        core.synchronize(test)
        self._eval(f"CREATE DATABASE IF NOT EXISTS {DB_NAME};")
        self._eval(f"GRANT ALL PRIVILEGES ON {DB_NAME}.* TO "
                   f"'{USER}'@'%' IDENTIFIED BY '{PASSWORD}';")
        if node == primary(test):
            self._eval(
                f"CREATE TABLE IF NOT EXISTS {DB_NAME}.accounts ("
                "id INT NOT NULL PRIMARY KEY, "
                "balance BIGINT NOT NULL);"
                f"CREATE TABLE IF NOT EXISTS {DB_NAME}.sets ("
                "id INT AUTO_INCREMENT PRIMARY KEY, val INT);")
            rows = ",".join(f"({i}, {self.initial_balance})"
                            for i in range(self.accounts))
            self._eval(f"INSERT IGNORE INTO {DB_NAME}.accounts "
                       f"VALUES {rows};")

    def _eval(self, sql: str) -> str:
        """Local root mysql eval (galera.clj eval!, 80-83)."""
        return control.exec_("mysql", "-u", "root",
                             f"--password={PASSWORD}", "-e", sql)

    def teardown(self, test, node):
        logger.info("%s tearing down galera", node)
        with control.su():
            cu.grepkill("mysqld")
            control.exec_("rm", "-rf", DATA_DIR)
            control.exec_("sh", "-c",
                          f"test -d {STOCK_DIR} && "
                          f"cp -rp {STOCK_DIR} {DATA_DIR} || true")

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# mysql CLI transport
# ---------------------------------------------------------------------------

class Mysql(common.SqlCli):
    """Node-local mysql CLI batches (multi-master: each client writes
    to its own node, galera.clj conn-spec)."""

    def __init__(self, test, node, timeout: float = 10.0):
        super().__init__(
            test, node,
            ["mysql", "-u", USER, f"--password={PASSWORD}",
             "-D", DB_NAME, "-N", "-B", "-e"],
            timeout=timeout)


_classify = common.make_classifier([
    r"deadlock", r"lock wait timeout",
    r"wsrep has not yet prepared", r"connection refused",
    r"can't connect", r"unknown mysql server"])


class GaleraBankClient(jclient.Client):
    """Bank transfers, reference semantics (galera.clj BankClient,
    258-303): read both balances, refuse a transfer that would go
    negative, otherwise update both rows — all one transaction, with
    SQL variables standing in for the reference's client-side check."""

    def __init__(self, mysql_factory=Mysql):
        self.mysql_factory = mysql_factory
        self.mysql = None

    def open(self, test, node):
        c = GaleraBankClient(self.mysql_factory)
        c.mysql = self.mysql_factory(test, node)
        return c

    def close(self, test):
        if self.mysql is not None:
            self.mysql.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.mysql.run(
                    # same 1024-byte GROUP_CONCAT truncation guard as
                    # the set client: wide account tables must not be
                    # silently cut into a false loss verdict
                    "SET SESSION group_concat_max_len = 1048576; "
                    "SELECT CONCAT('b=', COALESCE(GROUP_CONCAT("
                    "CONCAT(id, ':', balance) ORDER BY id), '')) "
                    "FROM accounts;")
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
                out = self.mysql.run(
                    "SET SESSION TRANSACTION ISOLATION LEVEL "
                    "SERIALIZABLE; "
                    "START TRANSACTION; "
                    f"SELECT balance INTO @b1 FROM accounts "
                    f"WHERE id = {f}; "
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


class GaleraSetClient(jclient.Client):
    """Insert-a-row-per-element set (galera.clj set-client, 215-238);
    the final read gathers what survived."""

    def __init__(self, mysql_factory=Mysql):
        self.mysql_factory = mysql_factory
        self.mysql = None

    def open(self, test, node):
        c = GaleraSetClient(self.mysql_factory)
        c.mysql = self.mysql_factory(test, node)
        return c

    def close(self, test):
        if self.mysql is not None:
            self.mysql.close()

    def invoke(self, test, op):
        try:
            if op.f == "add":
                self.mysql.run(
                    f"INSERT INTO sets (val) VALUES ({int(op.value)});")
                return op.copy(type="ok")
            if op.f == "read":
                out = self.mysql.run(
                    # mariadb 10.0 truncates GROUP_CONCAT at 1024
                    # bytes by default — silently losing elements and
                    # framing a healthy cluster for data loss
                    "SET SESSION group_concat_max_len = 1048576; "
                    "SELECT CONCAT('s=', COALESCE(GROUP_CONCAT(val), "
                    "'')) FROM sets;")
                m = re.search(r"s=(.*)$", out, re.M)
                if not m:
                    raise ValueError(f"unparseable read: {out!r}")
                vals = [int(x) for x in m.group(1).split(",") if x]
                return op.copy(type="ok", value=sorted(vals))
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def bank_workload(opts: dict) -> dict:
    from ..workloads import bank

    n = opts.get("accounts", 8)
    total = n * opts.get("initial_balance", 10)
    return {
        "client": GaleraBankClient(),
        "generator": bank.generator(accounts=list(range(n)),
                                    seed=opts.get("seed")),
        "checker": chk.checker(
            lambda test, hist, o: bank.check_fast(
                hist, total, device=opts.get("device"))),
    }


def set_workload(opts: dict) -> dict:
    """Adds under faults; the final reads are a SEPARATE phase so the
    test can heal the network first (reading mid-partition would frame
    a healthy cluster for lost elements)."""
    import itertools

    counter = itertools.count()
    return {
        "client": GaleraSetClient(),
        "generator": gen.limit(
            opts.get("ops", 500),
            lambda: {"f": "add", "value": next(counter)}),
        "final_generator": gen.each_thread(gen.once(
            lambda: {"f": "read", "value": None})),
        "checker": chk.set_checker(),
    }


WORKLOADS = {"bank": bank_workload, "set": set_workload}


def galera_test(opts: dict) -> dict:
    name = opts.get("workload") or "bank"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"galera-{name}",
        os=debian.os,
        db=GaleraDB(accounts=opts.get("accounts", 8),
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
        generator=_suite_generator(opts, w))
    return test


def _suite_generator(opts, w):
    """time-limit bounds the op mix + nemesis cycle; any final phase
    (the set workload's reads) runs after an explicit heal + settle."""
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
                   help="Workload (default bank). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(galera_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
