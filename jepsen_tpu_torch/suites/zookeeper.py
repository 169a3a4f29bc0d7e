"""ZooKeeper test suite: a linearizable compare-and-set register over
a zk ensemble, driven entirely through the control plane.

Capability reference: zookeeper/src/jepsen/zookeeper.clj (the
reference's tutorial-grade suite, 145 LoC): node-id/myid + zoo.cfg
server-list construction (19-37), apt install + service restart DB
(40-72), a cas-register client (78-110: read / write / cas with
:info on timeout), and the test bundle with partitions + linearizable
checking (112-137). The reference talks to zk through a JVM client
library; here ops go through `zkCli.sh` on the node itself using the
3.4 dialect matching the pinned package: `get` prints the stat
(dataVersion) after the value, and `set path data version` is the
version-guarded write that gives cas. The suite needs no zk driver on
the control host.

The port's copy of jepsen_tpu/suites/zookeeper.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging
import re

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing
from ..checker import models
from ..control import util as cu
from ..control.core import Lit, RemoteError
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "3.4.13-2"
CONF = "/etc/zookeeper/conf"
CLI = "/usr/share/zookeeper/bin/zkCli.sh"
LOG = "/var/log/zookeeper/zookeeper.log"
PORT = 2181
NODE_PATH = "/jepsen"

ZOO_CFG = """tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
"""


def node_ids(test) -> dict:
    """node name -> zk server id (zookeeper.clj:19-30)."""
    return {node: i for i, node in enumerate(test["nodes"])}


def zoo_cfg_servers(test) -> str:
    return "\n".join(f"server.{i}={node}:2888:3888"
                     for node, i in node_ids(test).items())


class ZkDB(jdb.DB):
    """apt-installed zookeeperd with a generated ensemble config
    (zookeeper.clj db, 40-72)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        logger.info("%s installing ZK %s", node, self.version)
        with control.su():
            debian.install({"zookeeper": self.version,
                            "zookeeperd": self.version})
            control.exec_("sh", "-c",
                          f"echo {node_ids(test)[node]} > {CONF}/myid")
            cfg = ZOO_CFG + zoo_cfg_servers(test) + "\n"
            cu.write_file(cfg, f"{CONF}/zoo.cfg")
            logger.info("%s ZK restarting", node)
            control.exec_("service", "zookeeper", "stop", check=False)
            control.exec_("service", "zookeeper", "start")
        cu.await_tcp_port(PORT, timeout_secs=60)
        logger.info("%s ZK ready", node)

    def teardown(self, test, node):
        logger.info("%s tearing down ZK", node)
        with control.su():
            control.exec_("service", "zookeeper", "stop", check=False)
            control.exec_("rm", "-rf",
                          Lit("/var/lib/zookeeper/version-*"),
                          Lit("/var/log/zookeeper/*"))

    def log_files(self, test, node):
        return [LOG]


_VALUE_RE = re.compile(r"^(\d+)\s*$", re.M)
_VERSION_RE = re.compile(r"dataVersion\s*=\s*(\d+)")


class ZkCasClient(jclient.Client):
    """CAS register at /jepsen via zkCli on the node: reads parse the
    value + dataVersion, cas re-writes with the read version as the
    positional guard (3.4 zkCli: `set path data version`) — optimistic
    concurrency, the zkCli analog of avout swap!!
    (zookeeper.clj:78-110)."""

    def __init__(self):
        self.node = None
        self.sess = None

    def open(self, test, node):
        c = ZkCasClient()
        c.node = node
        c.sess = control.session(test, node)
        return c

    def close(self, test):
        if self.sess is not None:
            control.disconnect(self.sess)

    def _cli(self, test, *cmd) -> str:
        with control.with_session(test, self.node, self.sess):
            return control.exec_(CLI, "-server",
                                 f"localhost:{PORT}", " ".join(cmd),
                                 timeout=10.0)

    def _read(self, test):
        """(value, dataVersion); creates the node on first touch. Only
        a definite NoNode triggers the create — any other error (e.g.
        a timeout mid-partition) propagates instead of burning two
        more zkCli launches."""
        try:
            out = self._cli(test, "get", NODE_PATH)
        except RemoteError as e:
            err = f"{e.err or ''} {e.out or ''}".lower()
            if "nonode" not in err:
                raise
            self._cli(test, "create", NODE_PATH, "0")
            out = self._cli(test, "get", NODE_PATH)
        vm = _VALUE_RE.search(out)
        ver = _VERSION_RE.search(out)
        return (int(vm.group(1)) if vm else None,
                int(ver.group(1)) if ver else None)

    def invoke(self, test, op):
        try:
            if op.f == "read":
                v, _ = self._read(test)
                return op.copy(type="ok", value=v)
            if op.f == "write":
                try:
                    self._cli(test, "set", NODE_PATH, str(op.value))
                except RemoteError:
                    self._cli(test, "create", NODE_PATH, str(op.value))
                return op.copy(type="ok")
            if op.f == "cas":
                old, new = op.value
                v, ver = self._read(test)
                if v != old or ver is None:
                    return op.copy(type="fail")
                try:
                    self._cli(test, "set", NODE_PATH, str(new),
                              str(ver))
                    return op.copy(type="ok")
                except RemoteError as e:
                    # Only the specific keeper error proves the write
                    # definitely did not happen; zkCli logs a
                    # "zookeeper.version=..." banner on every run, so
                    # substring-matching the whole message would turn
                    # indeterminate failures into false :fail
                    err = f"{e.err or ''} {e.out or ''}".lower()
                    if "badversion" in err:
                        return op.copy(type="fail")  # lost the race
                    raise
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:  # noqa: BLE001
            if op.f == "read":
                # reads are side-effect free: a failed read is a
                # definite :fail, keeping the search space tight
                return op.copy(type="fail", error=repr(e))
            return op.copy(type="info", error=repr(e))


def zk_test(opts: dict) -> dict:
    """Test map from CLI options (zookeeper.clj zk-test, 112-137)."""
    import random

    from ..workloads import register as register_wl

    rng = random.Random(opts.get("seed"))

    test = testing.noop_test()
    test.update(
        name="zookeeper",
        os=debian.os,
        db=ZkDB(opts.get("version", VERSION)),
        ssh=opts.get("ssh", {}),
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=ZkCasClient(),
        nemesis=jnemesis.partition_random_halves(),
        checker=chk.compose({
            "perf": chk.perf(),
            # the client creates /jepsen as 0 on first touch, so the
            # register's initial value is 0 (the reference's zk-atom
            # is likewise seeded with 0)
            "linear": chk.linearizable(
                {"model": models.cas_register(0),
                 "device": opts.get("device")})}),
        # time-limit wraps the WHOLE generator (client + nemesis), as
        # the reference does — limiting only the client side leaves
        # the infinite nemesis cycle running forever
        generator=gen.time_limit(
            opts.get("time_limit", 15),
            gen.clients(
                gen.stagger(1.0,
                            lambda: register_wl.cas_op_mix(rng)),
                jnemesis.start_stop_cycle(5.0))))
    return test


def _opts(p):
    p.add_argument("--version", default=VERSION,
                   help="zookeeper package version to install.")
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(zk_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
