"""Elasticsearch test suite: dirty-read hunting and set conservation
over the HTTP API.

Capability reference: elasticsearch/src/jepsen/elasticsearch/ —
core.clj (tarball install, cluster config with unicast discovery,
dedicated non-root user), dirty_read.clj (index-create writes, get-
by-id reads, refresh-until-all-shards, search-everything strong
reads; the rw generator and checker live in
workloads/dirty_read.py), sets.clj (insert-a-doc-per-element + final
search). The reference links the ES transport client into the JVM;
here ops go over the HTTP JSON API from the control host (the same
transport stance as etcd/consul).

The port's copy of jepsen_tpu/suites/elasticsearch.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing, workloads
from ..control import util as cu
from ..control.core import RemoteError
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "7.17.23"
DIR = "/opt/elasticsearch"
ES_USER = "elasticsearch"
DATA_DIR = "/var/lib/elasticsearch"
LOGFILE = f"{DIR}/logs/jepsen.log"
PIDFILE = "/var/run/elasticsearch.pid"
HTTP_PORT = 9200
INDEX = "dirty_read"
SET_INDEX = "sets"

ES_YML = """cluster.name: jepsen
node.name: {node}
network.host: 0.0.0.0
http.port: {port}
path.data: {data}
discovery.seed_hosts: [{hosts}]
cluster.initial_master_nodes: [{hosts}]
"""


class ElasticsearchDB(jdb.DB):
    """Tarball install running as a dedicated non-root user (ES
    refuses root), unicast discovery across the cluster
    (elasticsearch/core.clj db)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        logger.info("%s installing elasticsearch %s", node,
                    self.version)
        hosts = ", ".join(f'"{n}"' for n in test["nodes"])
        with control.su():
            url = (f"https://artifacts.elastic.co/downloads/"
                   f"elasticsearch/elasticsearch-{self.version}"
                   f"-linux-x86_64.tar.gz")
            cu.install_archive(url, DIR)
            cu.ensure_user(ES_USER)
            control.exec_("mkdir", "-p", DATA_DIR)
            cu.write_file(
                ES_YML.format(node=node, port=HTTP_PORT,
                              data=DATA_DIR, hosts=hosts),
                f"{DIR}/config/elasticsearch.yml")
            control.exec_("chown", "-R", f"{ES_USER}:{ES_USER}",
                          DIR, DATA_DIR)
        with control.su(ES_USER):
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                f"{DIR}/bin/elasticsearch")
        cu.await_tcp_port(HTTP_PORT, timeout_secs=180)

    def teardown(self, test, node):
        logger.info("%s tearing down elasticsearch", node)
        with control.su():
            cu.stop_daemon(f"{DIR}/bin/elasticsearch", PIDFILE)
            control.exec_("rm", "-rf", DATA_DIR, DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("elasticsearch")
        return "killed"

    def start(self, test, node):
        with control.su(ES_USER):
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                f"{DIR}/bin/elasticsearch")
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# HTTP driver
# ---------------------------------------------------------------------------

class EsHttp:
    """Minimal ES JSON driver. Split out so tests can stub
    `request`."""

    def __init__(self, node, timeout: float = 8.0):
        self.base = f"http://{node}:{HTTP_PORT}"
        self.timeout = timeout

    def request(self, method: str, path: str,
                body: dict | None = None) -> tuple[int, dict]:
        req = urllib.request.Request(
            self.base + path, method=method,
            data=json.dumps(body).encode() if body is not None
            else None,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            payload = e.read().decode() or "{}"
            try:
                return e.code, json.loads(payload)
            except ValueError:
                return e.code, {"raw": payload}

    def create_index(self, index: str) -> None:
        status, out = self.request("PUT", f"/{index}")
        if status not in (200, 400):  # 400: already exists
            raise RuntimeError(f"create index {index}: {out}")

    def index_doc(self, index: str, doc_id) -> bool:
        """True when the write is acknowledged as created."""
        status, out = self.request(
            "PUT", f"/{index}/_doc/{doc_id}?op_type=create",
            {"id": doc_id})
        if status == 409:
            return True  # already created: an earlier try landed
        if status not in (200, 201):
            raise RuntimeError(f"index {doc_id}: {out}")
        return out.get("result") in ("created", "updated")

    def get_doc(self, index: str, doc_id) -> bool:
        status, out = self.request("GET", f"/{index}/_doc/{doc_id}")
        return status == 200 and bool(out.get("found"))

    def refresh(self, index: str) -> bool:
        """True iff the refresh touched every shard
        (dirty_read.clj's all-shards-successful retry condition)."""
        _status, out = self.request("POST", f"/{index}/_refresh")
        sh = out.get("_shards") or {}
        return (sh.get("total", 0) > 0
                and sh.get("successful") == sh.get("total"))

    def search_ids(self, index: str) -> list:
        """Every doc id, paging with search_after — a bare size-10000
        search silently truncates larger indices and would frame a
        healthy cluster for losing the excess."""
        ids: list = []
        after = None
        while True:
            body = {"size": 10000, "query": {"match_all": {}},
                    "_source": False, "sort": [{"_id": "asc"}]}
            if after is not None:
                body["search_after"] = after
            _status, out = self.request(
                "POST", f"/{index}/_search", body)
            hits = (out.get("hits") or {}).get("hits") or []
            if not hits:
                return ids
            ids.extend(h["_id"] for h in hits)
            last = hits[-1]
            after = last.get("sort", [last["_id"]])


def _definite(e: Exception) -> bool:
    return jclient.definite_http_failure(e)


def _await_full_refresh(http: EsHttp, index: str,
                        timeout_secs: float = 120) -> None:
    """Retries until a refresh touches EVERY shard (dirty_read.clj's
    all-shards-successful loop): a partial refresh would hide acked
    docs from the following search and fake a loss."""
    from .. import util

    def check():
        if not http.refresh(index):
            raise RuntimeError("refresh incomplete")

    util.await_fn(check, timeout_secs=timeout_secs,
                  log_message="refresh incomplete; retrying")


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------

class EsDirtyReadClient(jclient.Client):
    """dirty_read.clj client over HTTP: writes index a doc by id,
    reads are get-by-id (a miss is a definite fail), refresh retries
    until all shards answer, strong reads search everything."""

    def __init__(self, http_factory=EsHttp):
        self.http_factory = http_factory
        self.http = None

    def open(self, test, node):
        c = EsDirtyReadClient(self.http_factory)
        c.http = self.http_factory(node)
        return c

    def setup(self, test):
        try:
            self.http.create_index(INDEX)
        except Exception:  # noqa: BLE001 — another client won the race
            pass
        return self

    def invoke(self, test, op):
        try:
            if op.f == "write":
                ok = self.http.index_doc(INDEX, str(op.value))
                return op.copy(type="ok" if ok else "info")
            if op.f == "read":
                found = self.http.get_doc(INDEX, str(op.value))
                return op.copy(type="ok" if found else "fail")
            if op.f == "refresh":
                _await_full_refresh(self.http, INDEX)
                return op.copy(type="ok")
            if op.f == "strong-read":
                ids = self.http.search_ids(INDEX)
                return op.copy(type="ok",
                               value=sorted(int(i) for i in ids))
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:  # noqa: BLE001
            if op.f == "read" or _definite(e):
                return op.copy(type="fail", error=repr(e)[:200])
            return op.copy(type="info", error=repr(e)[:200])


class EsSetClient(jclient.Client):
    """sets.clj client: one doc per element, final read = refresh +
    search."""

    def __init__(self, http_factory=EsHttp):
        self.http_factory = http_factory
        self.http = None

    def open(self, test, node):
        c = EsSetClient(self.http_factory)
        c.http = self.http_factory(node)
        return c

    def setup(self, test):
        try:
            self.http.create_index(SET_INDEX)
        except Exception:  # noqa: BLE001
            pass
        return self

    def invoke(self, test, op):
        try:
            if op.f == "add":
                ok = self.http.index_doc(SET_INDEX, str(op.value))
                return op.copy(type="ok" if ok else "info")
            if op.f == "read":
                _await_full_refresh(self.http, SET_INDEX)
                ids = self.http.search_ids(SET_INDEX)
                return op.copy(type="ok",
                               value=sorted(int(i) for i in ids))
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:  # noqa: BLE001
            if op.f == "read" or _definite(e):
                return op.copy(type="fail", error=repr(e)[:200])
            return op.copy(type="info", error=repr(e)[:200])


# ---------------------------------------------------------------------------
# Workloads / test
# ---------------------------------------------------------------------------

def dirty_read_workload(opts: dict) -> dict:
    w = workloads.dirty_read.workload(
        {"ops": opts.get("ops", 1000),
         "concurrency": opts["concurrency"],
         "seed": opts.get("seed")})
    w["client"] = EsDirtyReadClient()
    return w


def set_workload(opts: dict) -> dict:
    import itertools

    counter = itertools.count()
    return {
        "client": EsSetClient(),
        "generator": gen.limit(
            opts.get("ops", 500),
            lambda: {"f": "add", "value": next(counter)}),
        "final_generator": gen.each_thread(gen.once(
            lambda: {"f": "read", "value": None})),
        "checker": chk.set_checker(),
    }


WORKLOADS = {"dirty-read": dirty_read_workload, "set": set_workload}


def elasticsearch_test(opts: dict) -> dict:
    name = opts.get("workload") or "dirty-read"
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"elasticsearch-{name}",
        os=debian.os,
        db=ElasticsearchDB(opts.get("version", VERSION)),
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
        gen.sleep(opts.get("recovery_time", 10)),
        gen.clients(final))


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default dirty-read). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="elasticsearch version to install.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(elasticsearch_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
