"""MongoDB test suite: document compare-and-set against a replica set,
with majority write concern and linearizable reads.

Capability reference: mongodb-smartos/src/jepsen/mongodb_smartos/ —
core.clj (tarball install + mongod --replSet, replica-set-initiate
with the need-all-members-up retry at 128-146, await-primary 228-232,
join! driven from the jepsen primary 261-281) and document_cas.clj
(document register: read / upsert write / query-guarded cas update
checking the modified count, 40-83; reads idempotent -> :fail in
with-errors). The reference links the monger/Java driver into the
JVM; here every op is one `mongosh --quiet --eval JSON.stringify(
db.runCommand(...))` on the client's node against the replica-set
connection string — the same driver-free control-plane transport as
the zookeeper/postgres/rabbitmq suites.

The port's copy of jepsen_tpu/suites/mongodb.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import json
import logging
import random

from .. import checker as chk
from .. import cli, client as jclient, control, core, db as jdb
from .. import generator as gen
from .. import independent
from .. import nemesis as jnemesis
from .. import testing
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "7.0.14"
DIR = "/opt/mongodb"
MONGOD = f"{DIR}/bin/mongod"
MONGOSH = f"{DIR}/mongosh/bin/mongosh"
MONGOSH_VERSION = "2.3.1"
DATA_DIR = "/var/lib/mongodb"
LOGFILE = "/var/log/mongodb/mongod.log"
PIDFILE = "/var/run/mongod.pid"
PORT = 27017
REPL_SET = "rs0"
DB_NAME = "jepsen"
COLL = "jepsen"


def conn_string(test) -> str:
    hosts = ",".join(f"{n}:{PORT}" for n in test["nodes"])
    return f"mongodb://{hosts}/{DB_NAME}?replicaSet={REPL_SET}"


# ---------------------------------------------------------------------------
# mongosh transport
# ---------------------------------------------------------------------------

class MongoShell:
    """One runCommand per mongosh invocation on the client's node.
    `direct=True` targets the local mongod (for replica-set admin
    before a primary exists); otherwise the replica-set connection
    string routes to the current primary. Split out so tests can stub
    `run_command`."""

    def __init__(self, test, node, direct: bool = False,
                 timeout: float = 10.0):
        self.test = test
        self.node = node
        self.url = (f"mongodb://{node}:{PORT}/{DB_NAME}" if direct
                    else conn_string(test))
        self.timeout = timeout
        self.sess = control.session(test, node)

    def run_command(self, command: dict, admin: bool = False) -> dict:
        target = "db.getSiblingDB('admin')" if admin else "db"
        script = (f"JSON.stringify({target}.runCommand("
                  f"{json.dumps(command)}))")
        with control.with_session(self.test, self.node, self.sess):
            out = control.exec_(MONGOSH, "--quiet", self.url,
                                "--eval", script,
                                timeout=self.timeout)
        # mongosh may print connection banners despite --quiet; the
        # payload is the last JSON line
        for line in reversed(out.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                return json.loads(line)
        raise ValueError(f"no JSON in mongosh output: {out!r}")

    def close(self):
        control.disconnect(self.sess)



class MongoDB(jdb.DB):
    """Tarball-installed mongod in one replica set; the test primary
    initiates and awaits election (core.clj join!, 261-281)."""

    supports_kill = True

    def __init__(self, version: str = VERSION,
                 shell_factory=MongoShell):
        self.version = version
        # injectable for clusterless tests; None skips the initiate/
        # await phase that needs a live server
        self.shell_factory = shell_factory

    def setup(self, test, node):
        logger.info("%s installing mongodb %s", node, self.version)
        with control.su():
            url = (f"https://fastdl.mongodb.org/linux/mongodb-linux-"
                   f"x86_64-debian11-{self.version}.tgz")
            cu.install_archive(url, DIR)
            # the server tarball ships no shell; fetch mongosh beside
            # it for the suite's transport
            cu.install_archive(
                f"https://downloads.mongodb.com/compass/"
                f"mongosh-{MONGOSH_VERSION}-linux-x64.tgz",
                f"{DIR}/mongosh")
            control.exec_("mkdir", "-p", DATA_DIR,
                          "/var/log/mongodb")
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                MONGOD,
                "--replSet", REPL_SET,
                "--bind_ip_all",
                "--port", str(PORT),
                "--dbpath", DATA_DIR,
                "--logpath", LOGFILE)
        cu.await_tcp_port(PORT, timeout_secs=120)
        core.synchronize(test)  # all mongods up before initiate
        if node == primary(test) and self.shell_factory is not None:
            shell = self.shell_factory(test, node, direct=True)
            try:
                self._initiate(test, shell)
                self._await_primary(shell)
            finally:
                shell.close()
        core.synchronize(test)

    def _initiate(self, test, shell):
        """replSetInitiate, retrying while members are still coming up
        (core.clj replica-set-initiate!, 128-146)."""
        from .. import util

        members = [{"_id": i, "host": f"{n}:{PORT}"}
                   for i, n in enumerate(test["nodes"])]
        cfg = {"_id": REPL_SET, "members": members}

        def attempt():
            res = shell.run_command(
                {"replSetInitiate": cfg}, admin=True)
            if res.get("ok") != 1 and "already initialized" not in str(
                    res.get("errmsg", "")):
                raise RuntimeError(f"initiate failed: {res}")

        util.await_fn(attempt, timeout_secs=120,
                      log_message="waiting for replSetInitiate")

    def _await_primary(self, shell):
        """Block until an elected primary is visible
        (core.clj await-primary, 228-232)."""
        from .. import util

        def check():
            res = shell.run_command({"hello": 1}, admin=True)
            if not res.get("isWritablePrimary") and not res.get(
                    "primary"):
                raise RuntimeError("no primary yet")

        util.await_fn(check, timeout_secs=120,
                      log_message="waiting for mongo election")

    def teardown(self, test, node):
        logger.info("%s wiping mongodb", node)
        with control.su():
            cu.stop_daemon(MONGOD, PIDFILE)
            control.exec_("rm", "-rf", DATA_DIR, LOGFILE)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("mongod")
        return "killed"

    def start(self, test, node):
        with control.su():
            control.exec_("mkdir", "-p", DATA_DIR, "/var/log/mongodb")
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                MONGOD, "--replSet", REPL_SET, "--bind_ip_all",
                "--port", str(PORT), "--dbpath", DATA_DIR,
                "--logpath", LOGFILE)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


_DEFINITE_MARKERS = ("connection refused", "notwritableprimary",
                     "not master", "no primary", "notprimary")


def _classify(op, e: Exception):
    msg = f"{getattr(e, 'err', '')} {getattr(e, 'out', '')} {e}".lower()
    if op.f == "read" or any(m in msg for m in _DEFINITE_MARKERS):
        return op.copy(type="fail", error=msg.strip()[:200])
    return op.copy(type="info", error=msg.strip()[:200])


def _update_reply_problem(res: dict):
    """Mongo can answer ok:1 while the update itself failed: per-document
    errors ride in writeErrors (definite — the write did not apply, e.g.
    E11000 from a concurrent upsert race) and unmet durability rides in
    writeConcernError (indefinite — applied locally, replication unknown).
    Returns ("fail"|"info", msg) or (None, None)."""
    we = res.get("writeErrors")
    if we:
        return "fail", str(we)[:200]
    wce = res.get("writeConcernError")
    if wce:
        return "info", str(wce)[:200]
    return None, None


class MongoCasClient(jclient.Client):
    """Per-key document register (document_cas.clj Client, 40-83):
    write is an upsert, cas a query-guarded update judged by the
    modified count, read a linearizable-read-concern find."""

    def __init__(self, shell_factory=MongoShell,
                 write_concern: str = "majority",
                 read_concern: str = "linearizable"):
        self.shell_factory = shell_factory
        self.write_concern = write_concern
        self.read_concern = read_concern
        self.shell = None

    def open(self, test, node):
        c = MongoCasClient(self.shell_factory, self.write_concern,
                           self.read_concern)
        c.shell = self.shell_factory(test, node)
        return c

    def close(self, test):
        if self.shell is not None:
            self.shell.close()

    def _wc(self) -> dict:
        w = self.write_concern
        return {"w": int(w)} if str(w).isdigit() else {"w": w}

    def invoke(self, test, op):
        if op.f not in ("read", "write", "cas"):
            raise ValueError(f"unknown f {op.f!r}")
        k, v = independent.key_(op.value), independent.value_(op.value)
        try:
            if op.f == "read":
                res = self.shell.run_command({
                    "find": COLL, "filter": {"_id": k}, "limit": 1,
                    "readConcern": {"level": self.read_concern}})
                if res.get("ok") != 1:
                    return op.copy(type="fail",
                                   error=str(res.get("errmsg")))
                docs = res.get("cursor", {}).get("firstBatch", [])
                val = docs[0].get("value") if docs else None
                return op.copy(type="ok",
                               value=independent.ktuple(k, val))
            if op.f == "write":
                res = self.shell.run_command({
                    "update": COLL,
                    "updates": [{"q": {"_id": k},
                                 "u": {"_id": k, "value": v},
                                 "upsert": True}],
                    "writeConcern": self._wc()})
                if res.get("ok") != 1:
                    raise RuntimeError(str(res.get("errmsg")))
                kind, msg = _update_reply_problem(res)
                if kind is not None:
                    return op.copy(type=kind, error=msg)
                if res.get("n", 0) < 1:
                    return op.copy(type="fail", error="upsert matched 0")
                return op.copy(type="ok")
            if op.f == "cas":
                old, new = v
                res = self.shell.run_command({
                    "update": COLL,
                    "updates": [{"q": {"_id": k, "value": old},
                                 "u": {"$set": {"value": new}}}],
                    "writeConcern": self._wc()})
                if res.get("ok") != 1:
                    raise RuntimeError(str(res.get("errmsg")))
                kind, msg = _update_reply_problem(res)
                if kind is not None:
                    return op.copy(type=kind, error=msg)
                n = res.get("nModified", res.get("n", 0))
                if n == 0:
                    return op.copy(type="fail")
                if n == 1:
                    return op.copy(type="ok")
                raise RuntimeError(f"cas touched {n} documents")
        except (RemoteError, RuntimeError) as e:
            # parse corruption (ValueError) deliberately propagates:
            # mangled output is evidence, not a clean network :fail
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def cas_workload(opts: dict) -> dict:
    """Linearizable per-key document registers; mix weights cas double
    like the reference's std mix [r w cas cas]."""
    rng = random.Random(opts.get("seed"))

    def r(_rng):
        return {"f": "read", "value": None}

    def w(rng):
        return {"f": "write", "value": rng.randrange(5)}

    def cas(rng):
        return {"f": "cas",
                "value": [rng.randrange(5), rng.randrange(5)]}

    keys = list(range(opts.get("keys", 3)))
    return {
        "client": MongoCasClient(
            write_concern=opts.get("write_concern", "majority"),
            read_concern=opts.get("read_concern", "linearizable")),
        "generator": independent.concurrent_generator(
            opts["concurrency"], keys,
            lambda k: gen.limit(
                opts.get("ops_per_key", 200),
                gen.mix([lambda: r(rng), lambda: w(rng),
                         lambda: cas(rng), lambda: cas(rng)]))),
        "checker": independent.checker(chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")})),
    }


WORKLOADS = {"cas": cas_workload}


def mongodb_test(opts: dict) -> dict:
    name = opts.get("workload", "cas")
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"mongodb-{name}",
        os=debian.os,
        db=MongoDB(opts.get("version", VERSION)),
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
    p.add_argument("--workload", default="cas",
                   help="Workload. " + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="mongodb version tarball to install.")
    p.add_argument("--rate", type=float, default=20)
    p.add_argument("--write-concern", dest="write_concern",
                   default="majority",
                   help='w value: "majority" or an int ack count.')
    p.add_argument("--read-concern", dest="read_concern",
                   default="linearizable",
                   choices=["local", "majority", "linearizable"])
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(mongodb_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
