"""Aerospike test suite: a linearizable CAS register over the `aql`
CLI client.

Capability reference: jepsen's aerospike test (aphyr/jepsen
aerospike/src/aerospike/core.clj) — .deb install of
aerospike-server-community + aerospike-tools, a mesh-heartbeat
aerospike.conf naming every peer, and a read/write/cas register in the
`test` namespace checked for linearizability under partitions (the
reference's headline finding). The reference drives the Java client;
here ops run `aql` on the node over the control plane — reads/writes
as AQL statements, CAS as a record UDF (jepsen.lua, registered at
setup) so the compare-and-set executes atomically inside the server —
the same node-side CLI transport pattern as the raftis/rethinkdb/
disque suites, so tests stub the transport with a scripted in-memory
register.

The port's copy of jepsen_tpu/suites/aerospike.py: the same host code, with
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
from .. import testing
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "3.5.4"
SERVICE_PORT = 3000
FABRIC_PORT = 3001
HEARTBEAT_PORT = 3002
CONF = "/etc/aerospike/aerospike.conf"
UDF = "/opt/jepsen/jepsen.lua"
LOGFILE = "/var/log/aerospike/aerospike.log"
NAMESPACE = "test"
SET = "jepsen"
KEY = "r"

# The record UDF behind cas/write: runs atomically on the record
# inside the server (the reference uses the Java client's
# generation-check writes; a record UDF is the CLI-reachable
# equivalent). cas returns 1 only when the precondition held.
UDF_BODY = """\
function cas(rec, old, new)
    if aerospike:exists(rec) and rec['v'] == old then
        rec['v'] = new
        aerospike:update(rec)
        return 1
    end
    return 0
end

function put(rec, v)
    rec['v'] = v
    if aerospike:exists(rec) then
        aerospike:update(rec)
    else
        aerospike:create(rec)
    end
    return 1
end
"""


def conf_body(test, node) -> str:
    """aerospike.conf with mesh heartbeat seeds for every peer and an
    in-memory `test` namespace replicated across the cluster
    (aerospike core.clj configure!)."""
    seeds = "\n".join(
        f"        mesh-seed-address-port {n} {HEARTBEAT_PORT}"
        for n in test["nodes"] if str(n) != str(node))
    return f"""\
service {{
    user root
    group root
    paxos-single-replica-limit 1
    pidfile /var/run/aerospike/asd.pid
    service-threads 4
    transaction-queues 4
    transaction-threads-per-queue 4
    proto-fd-max 1024
}}
logging {{
    file {LOGFILE} {{
        context any info
    }}
}}
network {{
    service {{
        address any
        port {SERVICE_PORT}
    }}
    heartbeat {{
        mode mesh
        port {HEARTBEAT_PORT}
{seeds}
        interval 150
        timeout 10
    }}
    fabric {{
        port {FABRIC_PORT}
    }}
}}
namespace {NAMESPACE} {{
    replication-factor {len(test["nodes"])}
    memory-size 1G
    default-ttl 0
    storage-engine memory
}}
"""


class AerospikeDB(jdb.DB):
    """.deb install + mesh config + asd service + UDF registration
    (aerospike core.clj db)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        logger.info("%s installing aerospike %s", node, self.version)
        with control.su():
            url = ("https://www.aerospike.com/artifacts/"
                   "aerospike-server-community/"
                   f"{self.version}/aerospike-server-community-"
                   f"{self.version}-debian8.tgz")
            d = cu.install_archive(url, "/opt/aerospike-install")
            control.exec_("sh", "-c",
                          f"dpkg -i {d}/aerospike-server-*.deb "
                          f"{d}/aerospike-tools-*.deb")
            control.exec_("mkdir", "-p", "/var/log/aerospike",
                          "/opt/jepsen")
            cu.write_file(conf_body(test, node), CONF)
            cu.write_file(UDF_BODY, UDF)
            control.exec_("service", "aerospike", "restart")
        cu.await_tcp_port(SERVICE_PORT, timeout_secs=120)
        # the CAS/put UDF must exist before the first client op
        control.exec_("aql", "-h", str(node), "-c",
                      f"REGISTER MODULE '{UDF}'", timeout=30.0)

    def teardown(self, test, node):
        logger.info("%s tearing down aerospike", node)
        with control.su():
            try:
                control.exec_("service", "aerospike", "stop")
            except RemoteError:
                pass
            control.exec_("rm", "-rf", "/opt/aerospike-install",
                          "/opt/jepsen", CONF)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("asd")
        return "killed"

    def start(self, test, node):
        with control.su():
            control.exec_("service", "aerospike", "restart")
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# aql transport
# ---------------------------------------------------------------------------

class AqlCli:
    """One `aql -c` statement on the node. Split out so tests can stub
    `run`. Non-retrying session: INSERT/EXECUTE are not idempotent — a
    transport retry after the server applied one double-applies a
    write the history records once (the raftis RedisCli rationale)."""

    def __init__(self, test, node, timeout: float = 5.0):
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

    def run(self, statement: str) -> str:
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_("aql", "-h", str(self.node), "-c",
                                 statement, timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


# error markers proving the statement definitely did NOT apply
_DEFINITE = ("aerospike_err_cluster", "not authenticated",
             "invalid namespace", "connection refused",
             "could not connect", "failed to connect",
             "unavailable")

_CELL = re.compile(r"^\|\s*(-?\d+)\s*\|$")


class _ErrReply(Exception):
    """aql reported an error line — the server rejected or never saw
    the statement."""


def parse_cells(out: str) -> list[int]:
    """Integer cells out of aql's box-drawing table output (one value
    column). 'Error: (n) ...' lines raise; '0 rows in set' yields
    []."""
    vals = []
    for line in out.splitlines():
        s = line.strip()
        if s.lower().startswith("error"):
            raise _ErrReply(s)
        m = _CELL.match(s)
        if m:
            vals.append(int(m.group(1)))
    return vals


def _classify(op, e: Exception):
    msg = f"{e} {getattr(e, 'err', '')} {getattr(e, 'out', '')}" \
        .strip().lower()
    if op.f == "read":
        # an unanswered read changed nothing: always a definite fail
        return op.copy(type="fail", error=msg[:200])
    if isinstance(e, _ErrReply) and any(m in msg for m in _DEFINITE):
        return op.copy(type="fail", error=msg[:200])
    # timeouts and everything else may have applied: indeterminate
    return op.copy(type="info", error=msg[:200])


class AerospikeCasClient(jclient.Client):
    """read/write/cas register at PK 'r' (aerospike core.clj
    cas-register client). Reads are AQL SELECTs; write/cas execute the
    jepsen.lua record UDF so the compare runs atomically server-side.
    A CAS whose UDF returns 0 definitely did not apply (:fail); a lost
    reply is indeterminate (:info)."""

    def __init__(self, cli_factory=AqlCli):
        self.cli_factory = cli_factory
        self.cli = None

    def open(self, test, node):
        c = AerospikeCasClient(self.cli_factory)
        c.cli = self.cli_factory(test, node)
        return c

    def close(self, test):
        if self.cli is not None:
            self.cli.close()

    def invoke(self, test, op):
        try:
            if op.f == "read":
                cells = parse_cells(self.cli.run(
                    f"SELECT v FROM {NAMESPACE}.{SET} WHERE "
                    f"PK='{KEY}'"))
                return op.copy(type="ok",
                               value=cells[0] if cells else None)
            if op.f == "write":
                cells = parse_cells(self.cli.run(
                    f"EXECUTE jepsen.put({int(op.value)}) ON "
                    f"{NAMESPACE}.{SET} WHERE PK='{KEY}'"))
                if cells != [1]:
                    raise RemoteError("unexpected put reply", exit=0,
                                      out=str(cells), err="",
                                      cmd="aql", node=None)
                return op.copy(type="ok")
            if op.f == "cas":
                old, new = op.value
                cells = parse_cells(self.cli.run(
                    f"EXECUTE jepsen.cas({int(old)}, {int(new)}) ON "
                    f"{NAMESPACE}.{SET} WHERE PK='{KEY}'"))
                if cells == [1]:
                    return op.copy(type="ok")
                if cells == [0]:
                    # the UDF's precondition check said no: definite
                    return op.copy(type="fail",
                                   error="cas precondition failed")
                raise RemoteError("unexpected cas reply", exit=0,
                                  out=str(cells), err="", cmd="aql",
                                  node=None)
            raise ValueError(f"unknown f {op.f!r}")
        except (RemoteError, _ErrReply) as e:
            return _classify(op, e)


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    """The reference's cas-register workload: mixed read/write/cas
    against one key, checked linearizable against CASRegister."""
    rng = random.Random(opts.get("seed"))

    def one():
        roll = rng.random()
        if roll < 0.5:
            return {"f": "read", "value": None}
        if roll < 0.75:
            return {"f": "write", "value": rng.randrange(5)}
        return {"f": "cas", "value": [rng.randrange(5),
                                      rng.randrange(5)]}

    return {
        "client": AerospikeCasClient(),
        "generator": gen.limit(opts.get("ops", 500), one),
        "checker": chk.linearizable({"model": models.cas_register(),
                                     "device": opts.get("device")}),
    }


WORKLOADS = {"register": register_workload}


def aerospike_test(opts: dict) -> dict:
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"aerospike-{name}",
        os=debian.os,
        db=AerospikeDB(opts.get("version", VERSION)),
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
                   help="aerospike-server-community version to "
                        "install.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(aerospike_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    commands.update(cli.coverage_cmd(list(WORKLOADS)))
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
