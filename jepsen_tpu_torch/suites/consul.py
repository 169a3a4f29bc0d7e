"""Consul test suite: a linearizable register per independent key over
the HTTP KV API, with index-based compare-and-set.

Capability reference: consul/src/jepsen/consul/db.clj (zip-binary
install + agent daemon with -bootstrap on the primary and -retry-join
everywhere else, await catalog convergence), consul/client.clj (KV
reads return base64 values + ModifyIndex; CAS is index-based: read the
index, then PUT ?cas=<index>; with-errors maps 404/403/500), and
consul/register.clj (independent-key register workload with a reserved
read pool). Consistency levels ("stale"/"consistent"/default) thread
through every request as query params, as the reference's
--consistency flag does.

The port's copy of jepsen_tpu/suites/consul.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import base64
import json
import logging
import random
import urllib.error
import urllib.parse
import urllib.request

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb, independent
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import net, testing
from ..checker import models
from ..control import util as cu
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "1.6.1"
DIR = "/opt"
BINARY = f"{DIR}/consul"
PIDFILE = "/var/run/consul.pid"
LOGFILE = "/var/log/consul.log"
DATA_DIR = "/var/lib/consul"
HTTP_PORT = 8500
RETRY_INTERVAL = "5s"

CONSISTENCY_LEVELS = {"stale", "consistent"}


# ---------------------------------------------------------------------------
# HTTP KV client
# ---------------------------------------------------------------------------

class ConsulHttp:
    """Minimal consul KV driver (consul/client.clj). Split out so
    tests can stub `request`."""

    def __init__(self, node, consistency: str | None = None,
                 timeout: float = 5.0):
        self.base = f"http://{node}:{HTTP_PORT}"
        self.consistency = consistency
        self.timeout = timeout

    def request(self, method: str, path: str, params: dict | None = None,
                body: str | None = None) -> tuple[int, str]:
        """(status, body). 404 comes back as a status, not an
        exception; other HTTP errors raise."""
        url = self.base + path
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: ("" if v is None else v) for k, v in params.items()})
        req = urllib.request.Request(
            url, method=method,
            data=body.encode() if body is not None else None)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return 404, ""
            raise

    def _params(self, extra: dict | None = None) -> dict:
        p = dict(extra or {})
        if self.consistency:
            p[self.consistency] = None
        return p

    def get(self, key: str):
        """(value, modify_index) or (None, None) for a missing key.
        Values arrive base64-encoded (consul/client.clj parse-body)."""
        status, out = self.request("GET", f"/v1/kv/{key}",
                                   self._params())
        if status == 404 or not out:
            return None, None
        entry = json.loads(out)[0]
        raw = entry.get("Value")
        value = (base64.b64decode(raw).decode()
                 if raw is not None else None)
        return value, int(entry.get("ModifyIndex", 0))

    def put(self, key: str, value: str) -> None:
        self.request("PUT", f"/v1/kv/{key}", self._params(), value)

    def cas(self, key: str, old: str, new: str) -> bool:
        """Index-based CAS: read the current value + ModifyIndex, then
        PUT ?cas=<index> iff the value matched
        (consul/client.clj cas!, 64-90)."""
        value, index = self.get(key)
        if value != old or index is None:
            return False
        _status, out = self.request(
            "PUT", f"/v1/kv/{key}", self._params({"cas": index}), new)
        return out.strip() == "true"

    def catalog_nodes(self) -> list:
        _status, out = self.request("GET", "/v1/catalog/nodes")
        return json.loads(out) if out else []


def await_cluster_ready(http: ConsulHttp, n_nodes: int,
                        timeout_secs: float = 60.0) -> None:
    """Blocks until the catalog lists every node
    (consul/client.clj await-cluster-ready)."""
    from .. import util

    def check():
        n = len(http.catalog_nodes())
        if n < n_nodes:
            raise RuntimeError(
                f"only {n}/{n_nodes} nodes in consul catalog")

    util.await_fn(check, timeout_secs=timeout_secs,
                  log_message="waiting for consul catalog")



class ConsulDB(jdb.DB):
    """Installs the consul binary and runs the server agent
    (consul/db.clj:23-92): the primary bootstraps, the rest
    retry-join it."""

    supports_kill = True

    def __init__(self, version: str = VERSION,
                 http_factory=ConsulHttp):
        self.version = version
        # injectable for clusterless tests; None skips the catalog
        # await (the tcp-port await already gates liveness)
        self.http_factory = http_factory

    def _start_agent(self, test, node, bootstrap: bool):
        """One flag list for every start path. Fresh setup bootstraps
        on the primary; restarts always rejoin (a killed primary's
        peers already hold the raft state)."""
        args = [BINARY, "agent", "-server",
                "-log-level", "debug",
                "-client", "0.0.0.0",
                "-bind", net.ip(node),
                "-data-dir", DATA_DIR,
                "-node", str(node),
                "-retry-interval", RETRY_INTERVAL]
        if bootstrap:
            args += ["-bootstrap"]
        else:
            args += ["-retry-join", net.ip(primary(test))]
        cu.start_daemon({"logfile": LOGFILE, "pidfile": PIDFILE,
                         "chdir": DIR}, *args)

    def setup(self, test, node):
        logger.info("%s installing consul %s", node, self.version)
        with control.su():
            url = (f"https://releases.hashicorp.com/consul/"
                   f"{self.version}/consul_{self.version}"
                   f"_linux_amd64.zip")
            cu.install_archive(url, BINARY)
            self._start_agent(test, node, node == primary(test))
        cu.await_tcp_port(HTTP_PORT, timeout_secs=60)
        if self.http_factory is not None:
            await_cluster_ready(self.http_factory(node),
                                len(test["nodes"]))

    def teardown(self, test, node):
        logger.info("%s tearing down consul", node)
        with control.su():
            cu.stop_daemon(BINARY, PIDFILE)
            control.exec_("rm", "-rf", PIDFILE, LOGFILE, DATA_DIR,
                          BINARY)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("consul")
        return "killed"

    def start(self, test, node):
        with control.su():
            self._start_agent(test, node, bootstrap=False)
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------

class ConsulRegisterClient(jclient.Client):
    """Independent-key register ops over the KV API
    (consul/register.clj Client). Reads of a missing key are None (the
    register's initial state); read failures are definite :fail (reads
    are side-effect free), write/cas failures :info unless the
    connection was refused outright."""

    def __init__(self, http_factory=ConsulHttp,
                 consistency: str | None = None):
        self.http_factory = http_factory
        self.consistency = consistency
        self.http = None

    def open(self, test, node):
        c = ConsulRegisterClient(self.http_factory, self.consistency)
        c.http = self.http_factory(node, consistency=self.consistency)
        return c

    def invoke(self, test, op):
        k, v = independent.key_(op.value), independent.value_(op.value)
        key = f"register/{k}"
        try:
            if op.f == "read":
                raw, _idx = self.http.get(key)
            elif op.f == "write":
                self.http.put(key, str(v))
                return op.copy(type="ok")
            elif op.f == "cas":
                old, new = v
                ok = self.http.cas(key, str(old), str(new))
                return op.copy(type="ok" if ok else "fail")
            else:
                raise ValueError(f"unknown f {op.f!r}")
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            if op.f == "read" or jclient.definite_http_failure(e):
                return op.copy(type="fail", error=repr(e))
            return op.copy(type="info", error=repr(e))
        # Parse OUTSIDE the network-error net: a corrupt value is
        # evidence, not a clean network :fail — let it crash the op
        # (the interpreter records :info with the exception)
        return op.copy(type="ok", value=independent.ktuple(
            k, None if raw is None else int(raw)))


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    """Linearizable reads/writes/cas on independent keys, with a
    reserved read pool like the reference
    (consul/register.clj workload: reserve 5 r over mix [w cas])."""
    rng = random.Random(opts.get("seed"))

    def r(_rng):
        return {"f": "read", "value": None}

    def w(rng):
        return {"f": "write", "value": rng.randrange(5)}

    def cas(rng):
        return {"f": "cas",
                "value": [rng.randrange(5), rng.randrange(5)]}

    keys = list(range(opts.get("keys", 4)))
    # Reserve a read pool like the reference, but never ALL threads:
    # at concurrency 1 a reserved reader would starve the write/cas
    # mix and the test would vacuously pass on a never-written register
    reserved = min(5, opts["concurrency"] // 2)

    def key_gen(k):
        if reserved:
            body = gen.reserve(reserved, lambda: r(rng),
                               gen.mix([lambda: w(rng),
                                        lambda: cas(rng)]))
        else:
            body = gen.mix([lambda: r(rng), lambda: w(rng),
                            lambda: cas(rng)])
        return gen.limit(opts.get("ops_per_key", 200), body)

    return {
        "client": ConsulRegisterClient(
            consistency=opts.get("consistency")),
        "generator": independent.concurrent_generator(
            opts["concurrency"], keys, key_gen),
        "checker": independent.checker(chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")})),
    }


WORKLOADS = {"register": register_workload}


def consul_test(opts: dict) -> dict:
    """Test map from CLI options (jepsen.consul/consul-test)."""
    name = opts.get("workload", "register")
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"consul-{name}",
        os=debian.os,
        db=ConsulDB(opts.get("version", VERSION)),
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        nemesis=jnemesis.partition_random_halves(),
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=gen.phases(
            gen.time_limit(
                opts.get("time_limit", 30),
                gen.clients(
                    gen.stagger(1.0 / opts.get("rate", 10),
                                w["generator"]),
                    jnemesis.start_stop_cycle(10.0))),
            # heal and let the cluster settle before final analysis
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(opts.get("recovery_time", 10))))
    return test


def _opts(p):
    p.add_argument("--workload", default="register",
                   help="Workload. " + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="consul version to install.")
    p.add_argument("--rate", type=float, default=10)
    p.add_argument("--consistency", default=None,
                   choices=sorted(CONSISTENCY_LEVELS),
                   help="KV request consistency level "
                        "(default: consul's default).")
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(consul_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
