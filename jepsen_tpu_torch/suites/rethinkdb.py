"""RethinkDB test suite: single-document CAS under tunable write-acks
and read-mode, the reference's document workload.

Capability reference: jepsen's rethinkdb test (aphyr/jepsen
rethinkdb/src/jepsen/rethinkdb.clj + document.clj) — apt install +
/etc/rethinkdb/instances.d config with `join` lines and a per-node
server name, a `jepsen.cas` table created from the primary and
reconfigured to the requested write_acks, and a read/write/cas client
over ReQL whose `read_mode`/`write_acks` pair states the consistency
claim (majority/majority is the linearizable configuration; anything
weaker is expected to — and does, in the reference's findings — lose
the linearizability check under partitions).

The reference drives ReQL through the JVM driver; here ops run a small
query helper (QUERY_SCRIPT, uploaded at setup) with the python driver
installed on the node — the same node-side CLI transport pattern as
the raftis/disque suites, so tests stub the transport with a scripted
in-memory document.

The port's copy of jepsen_tpu/suites/rethinkdb.py: the same host code, with
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

VERSION = "2.4.4"
CLIENT_PORT = 28015
CLUSTER_PORT = 29015
CONF = "/etc/rethinkdb/instances.d/jepsen.conf"
DATA_DIR = "/var/lib/rethinkdb/jepsen"
LOGFILE = "/var/log/rethinkdb.log"
QUERY = "/opt/jepsen/rethink_query.py"
DB = "jepsen"
TABLE = "cas"
DOC_ID = 0

# The node-side query helper: one op per invocation, one reply line on
# stdout. Speaking a fixed little protocol (VAL/NONE/OK/CAS n/ERR msg)
# keeps the client's classification independent of driver versions.
QUERY_SCRIPT = '''\
import sys
try:
    from rethinkdb import r
except ImportError:
    import rethinkdb as r
op = sys.argv[1]
read_mode, write_acks = sys.argv[2], sys.argv[3]
try:
    conn = r.connect("localhost", {client_port})
    t = r.db("{db}").table("{table}", read_mode=read_mode)
    if op == "setup":
        try:
            r.db_create("{db}").run(conn)
        except Exception:
            pass
        try:
            r.db("{db}").table_create(
                "{table}", replicas=int(sys.argv[4])).run(conn)
        except Exception:
            pass
        r.db("{db}").table("{table}").config().update(
            {{"write_acks": write_acks}}).run(conn)
        r.db("{db}").table("{table}").wait().run(conn)
        print("OK")
    elif op == "read":
        row = t.get({doc_id}).run(conn)
        print("NONE" if row is None else "VAL %d" % row["val"])
    elif op == "write":
        res = t.insert({{"id": {doc_id}, "val": int(sys.argv[4])}},
                       conflict="replace").run(conn)
        if res.get("errors"):
            print("ERR %s" % res.get("first_error", "write error"))
        else:
            print("OK")
    elif op == "cas":
        old, new = int(sys.argv[4]), int(sys.argv[5])
        res = t.get({doc_id}).update(
            lambda row: r.branch(row["val"].eq(old),
                                 {{"val": new}}, r.error("abort")),
            return_changes=False).run(conn)
        if res.get("errors"):
            err = res.get("first_error", "")
            # only OUR precondition abort is a definite no-apply; any
            # other update error (ack/contact failures) may have
            # applied and must classify as indeterminate, not CAS 0
            if "abort" in err:
                print("CAS 0")
            else:
                print("ERR %s" % (err or "cas error"))
        else:
            print("CAS %d" % res.get("replaced", 0))
    else:
        print("ERR unknown op %s" % op)
except Exception as e:
    print("ERR %s" % e)
'''.format(client_port=CLIENT_PORT, db=DB, table=TABLE, doc_id=DOC_ID)


def conf_body(test, node) -> str:
    """The instance config (rethinkdb.clj db setup): bind everywhere,
    a stable server name, and a join line per peer."""
    lines = ["bind=all",
             f"server-name={str(node).replace('.', '_')}",
             f"directory={DATA_DIR}",
             f"log-file={LOGFILE}",
             f"driver-port={CLIENT_PORT}",
             f"cluster-port={CLUSTER_PORT}"]
    lines += [f"join={n}:{CLUSTER_PORT}" for n in test["nodes"]
              if str(n) != str(node)]
    return "\n".join(lines) + "\n"


class RethinkDB(jdb.DB):
    """apt install + instance config + service, table setup from the
    primary (rethinkdb.clj db, document.clj table create)."""

    supports_kill = True
    supports_primaries = True

    def __init__(self, version: str = VERSION,
                 write_acks: str = "majority",
                 read_mode: str = "majority"):
        self.version = version
        self.write_acks = write_acks
        self.read_mode = read_mode

    def setup(self, test, node):
        logger.info("%s installing rethinkdb %s", node, self.version)
        with control.su():
            debian.install(["rethinkdb", "python3-pip"])
            # the query helper's driver, node-side only (the control
            # process never imports it)
            control.exec_("pip3", "install", "-q", "rethinkdb")
            control.exec_("mkdir", "-p", "/opt/jepsen")
            cu.write_file(QUERY_SCRIPT, QUERY)
            control.exec_("mkdir", "-p", DATA_DIR.rsplit("/", 1)[0])
            cu.write_file(conf_body(test, node), CONF)
            control.exec_("service", "rethinkdb", "restart")
        cu.await_tcp_port(CLIENT_PORT, timeout_secs=120)

    def setup_primary(self, test, node):
        """Creates the db/table with one replica per node and the
        requested write_acks (document.clj:25-40)."""
        with control.with_session(test, node):
            control.exec_("python3", QUERY, "setup", self.read_mode,
                          self.write_acks,
                          str(len(test["nodes"])), timeout=120.0)

    def teardown(self, test, node):
        logger.info("%s tearing down rethinkdb", node)
        with control.su():
            try:
                control.exec_("service", "rethinkdb", "stop")
            except RemoteError:
                pass
            control.exec_("rm", "-rf", DATA_DIR, CONF)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("rethinkdb")
        return "killed"

    def start(self, test, node):
        with control.su():
            control.exec_("service", "rethinkdb", "restart")
        return "started"

    def primaries(self, test):
        """Nodes hosting the table's primary replica, via the table
        status on the first reachable node (rethinkdb.clj primaries)."""
        for node in test["nodes"]:
            try:
                with control.with_session(test, node):
                    out = control.exec_(
                        "python3", "-c",
                        "from rethinkdb import r; "
                        f"c=r.connect('localhost',{CLIENT_PORT}); "
                        f"print(r.db('{DB}').table('{TABLE}')"
                        ".status()['shards'][0]['primary_replicas']"
                        ".run(c))", timeout=30.0)
                import re as _re

                # exact-token match: 'n1' must not match inside
                # "['n10']" (server names are dot-mangled node names)
                toks = set(_re.findall(r"[A-Za-z0-9_.-]+", out))
                return [n for n in test["nodes"]
                        if str(n).replace(".", "_") in toks]
            except RemoteError:
                continue
        return []

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# Query transport
# ---------------------------------------------------------------------------

class RethinkCli:
    """One query-helper invocation on the node. Split out so tests can
    stub `run`. Non-retrying session: a CAS whose connection dropped
    after the broker applied it must surface as indeterminate, not be
    silently re-run (the raftis RedisCli rationale)."""

    def __init__(self, test, node, timeout: float = 10.0):
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
            return control.exec_("python3", QUERY, *args,
                                 timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


# Error messages proving the op was definitely NOT applied
# (document.clj maps "lost contact with primary" to :fail).
_DEFINITE = ("cannot perform read", "cannot perform write",
             "lost contact with primary", "primary replica",
             "table.*does not exist", "connection refused")


class _ErrReply(Exception):
    pass


def _reply(out: str) -> str:
    s = out.strip()
    if s.startswith("ERR"):
        raise _ErrReply(s[3:].strip())
    return s


def _classify(op, e: Exception):
    import re as _re

    msg = f"{e} {getattr(e, 'err', '')} {getattr(e, 'out', '')}" \
        .strip().lower()
    if op.f == "read":
        # an unanswered read changed nothing: always a definite fail
        return op.copy(type="fail", error=msg[:200])
    if isinstance(e, _ErrReply) and any(
            _re.search(m, msg) for m in _DEFINITE):
        return op.copy(type="fail", error=msg[:200])
    return op.copy(type="info", error=msg[:200])


class RethinkCasClient(jclient.Client):
    """read/write/cas on the single document (document.clj client).
    The read_mode/write_acks pair rides on every query — it IS the
    consistency configuration under test."""

    def __init__(self, cli_factory=RethinkCli,
                 read_mode: str = "majority",
                 write_acks: str = "majority"):
        self.cli_factory = cli_factory
        self.read_mode = read_mode
        self.write_acks = write_acks
        self.cli = None

    def open(self, test, node):
        c = RethinkCasClient(self.cli_factory, self.read_mode,
                             self.write_acks)
        c.cli = self.cli_factory(test, node)
        return c

    def close(self, test):
        if self.cli is not None:
            self.cli.close()

    def _run(self, *args) -> str:
        return _reply(self.cli.run(*args))

    def invoke(self, test, op):
        modes = (self.read_mode, self.write_acks)
        try:
            if op.f == "read":
                out = self._run("read", *modes)
                if out == "NONE":
                    return op.copy(type="ok", value=None)
                if out.startswith("VAL "):
                    return op.copy(type="ok", value=int(out[4:]))
                raise RemoteError("unexpected read reply", exit=0,
                                  out=out, err="", cmd="read",
                                  node=None)
            if op.f == "write":
                out = self._run("write", *modes, str(op.value))
                if out != "OK":
                    raise RemoteError("unexpected write reply",
                                      exit=0, out=out, err="",
                                      cmd="write", node=None)
                return op.copy(type="ok")
            if op.f == "cas":
                old, new = op.value
                out = self._run("cas", *modes, str(old), str(new))
                if out == "CAS 1":
                    return op.copy(type="ok")
                if out == "CAS 0":
                    return op.copy(type="fail",
                                   error="precondition failed")
                raise RemoteError("unexpected cas reply", exit=0,
                                  out=out, err="", cmd="cas",
                                  node=None)
            raise ValueError(f"unknown f {op.f!r}")
        except (RemoteError, _ErrReply) as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    """The document CAS register: the reference's r/w/cas mix checked
    for linearizability (document.clj workload)."""
    from ..workloads.register import cas_op_mix

    rng = random.Random(opts.get("seed"))
    return {
        "client": RethinkCasClient(
            read_mode=opts.get("read_mode", "majority"),
            write_acks=opts.get("write_acks", "majority")),
        "generator": gen.limit(opts.get("ops", 500),
                               lambda: cas_op_mix(rng)),
        "checker": chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")}),
    }


WORKLOADS = {"register": register_workload}


def rethinkdb_test(opts: dict) -> dict:
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"rethinkdb-{name}",
        os=debian.os,
        db=RethinkDB(opts.get("version", VERSION),
                     write_acks=opts.get("write_acks", "majority"),
                     read_mode=opts.get("read_mode", "majority")),
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
                   help="rethinkdb version to install.")
    p.add_argument("--write-acks", dest="write_acks",
                   default="majority", choices=["single", "majority"],
                   help="Table write-acks mode under test.")
    p.add_argument("--read-mode", dest="read_mode",
                   default="majority",
                   choices=["single", "majority", "outdated"],
                   help="Per-read consistency mode under test.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(rethinkdb_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    commands.update(cli.coverage_cmd(list(WORKLOADS)))
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
