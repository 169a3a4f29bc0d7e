"""etcd test suite: install/start/stop etcd, drive it over its HTTP v3
gateway, check registers (linearizable) and list-append (elle).

Capability reference: the reference's canonical tutorial suite
(doc/tutorial/index.md:13-20; DB install/daemon flow in
doc/tutorial/02-db.md: /opt/etcd install-archive + start-stop-daemon
with --initial-cluster flags; client and checker shape in 03-client.md,
04-checker.md; zookeeper/src/jepsen/zookeeper.clj is the size model).

Run clusterless against the dummy remote in CI (command emission is
tested), or for real: python -m jepsen_tpu_torch.suites.etcd test
--nodes ... --username root.

The port's copy of jepsen_tpu/suites/etcd.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import base64
import json
import logging
import random
import urllib.request

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb, independent
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing, workloads
from ..nemesis import membership
from ..checker import models
from ..control import util as cu
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "v3.5.15"
DIR = "/opt/etcd"
BINARY = f"{DIR}/etcd"
LOGFILE = f"{DIR}/etcd.log"
PIDFILE = f"{DIR}/etcd.pid"

CLIENT_PORT = 2379
PEER_PORT = 2380


def node_url(node, port) -> str:
    return f"http://{node}:{port}"


def peer_url(node) -> str:
    return node_url(node, PEER_PORT)


def client_url(node) -> str:
    return node_url(node, CLIENT_PORT)


def initial_cluster(test) -> str:
    """node1=http://node1:2380,... (tutorial 02-db.md
    initial-cluster)."""
    return ",".join(f"{n}={peer_url(n)}" for n in test["nodes"])


class EtcdDB(jdb.DB):
    """Installs and runs an etcd node (tutorial 02-db.md)."""

    supports_kill = True
    supports_pause = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def _daemon_args(self, test, node, cluster_state: str,
                     cluster: str | None = None):
        """One flag list for every start path; restarts say
        'existing' (a fresh 'new' after kill was a bootstrap bug the
        round-2 advisor flagged), and membership joins pass the
        current cluster string."""
        return (
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            BINARY,
            "--log-outputs", "stderr",
            "--name", str(node),
            "--listen-peer-urls", peer_url(node),
            "--listen-client-urls", f"http://0.0.0.0:{CLIENT_PORT}",
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", cluster_state,
            "--initial-advertise-peer-urls", peer_url(node),
            "--initial-cluster", cluster or initial_cluster(test))

    def setup(self, test, node):
        logger.info("%s installing etcd %s", node, self.version)
        with control.su():
            url = (f"https://storage.googleapis.com/etcd/{self.version}"
                   f"/etcd-{self.version}-linux-amd64.tar.gz")
            cu.install_archive(url, DIR)
            cu.start_daemon(*self._daemon_args(test, node, "new"))
        cu.await_tcp_port(CLIENT_PORT, timeout_secs=60)

    def teardown(self, test, node):
        logger.info("%s tearing down etcd", node)
        with control.su():
            cu.stop_daemon(BINARY, PIDFILE)
            control.exec_("rm", "-rf", DIR)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("etcd")
        return "killed"

    def start(self, test, node):
        self.setup_daemon_only(test, node, cluster_state="existing")
        return "started"

    def setup_daemon_only(self, test, node, cluster_state: str = "new",
                          cluster: str | None = None):
        with control.su():
            cu.start_daemon(*self._daemon_args(test, node,
                                               cluster_state, cluster))

    def pause(self, test, node):
        with control.su():
            cu.grepkill("etcd", "stop")
        return "paused"

    def resume(self, test, node):
        with control.su():
            cu.grepkill("etcd", "cont")
        return "resumed"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# Client over the v3 HTTP/JSON gateway
# ---------------------------------------------------------------------------

def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _unb64(s: str) -> str:
    return base64.b64decode(s).decode()


class EtcdHttp:
    """Minimal etcd v3 JSON-gateway driver (kv/range, kv/put, kv/txn).
    Split out so tests can stub `post`."""

    def __init__(self, node, timeout: float = 5.0):
        self.base = client_url(node)
        self.timeout = timeout

    def post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    def get(self, key: str):
        """(value, mod_revision) or (None, None)."""
        out = self.post("/v3/kv/range", {"key": _b64(key)})
        kvs = out.get("kvs") or []
        if not kvs:
            return None, None
        return (_unb64(kvs[0].get("value", "")),
                int(kvs[0].get("mod_revision", 0)))

    def put(self, key: str, value: str) -> None:
        self.post("/v3/kv/put", {"key": _b64(key), "value": _b64(value)})

    def cas(self, key: str, old: str, new: str) -> bool:
        """Atomic value-equality compare-and-set via kv/txn."""
        out = self.post("/v3/kv/txn", {
            "compare": [{"key": _b64(key), "target": "VALUE",
                         "value": _b64(old), "result": "EQUAL"}],
            "success": [{"requestPut": {"key": _b64(key),
                                        "value": _b64(new)}}]})
        return bool(out.get("succeeded"))

    def cas_create(self, key: str, new: str) -> bool:
        """Create iff absent (create_revision == 0)."""
        out = self.post("/v3/kv/txn", {
            "compare": [{"key": _b64(key), "target": "CREATE",
                         "create_revision": "0"}],
            "success": [{"requestPut": {"key": _b64(key),
                                        "value": _b64(new)}}]})
        return bool(out.get("succeeded"))

    def txn_rw(self, guards, puts) -> bool:
        """One atomic kv/txn: every (key, mod_revision) guard must
        still hold, then all (key, value) puts apply. Missing keys
        guard with revision 0."""
        out = self.post("/v3/kv/txn", {
            "compare": [{"key": _b64(k), "target": "MOD",
                         "mod_revision": str(rev or 0),
                         "result": "EQUAL"} for k, rev in guards],
            "success": [{"requestPut": {"key": _b64(k),
                                        "value": _b64(v)}}
                        for k, v in puts]})
        return bool(out.get("succeeded"))

    # -- cluster membership (v3/cluster gateway) --------------------------

    def members(self) -> list[dict]:
        out = self.post("/v3/cluster/member/list", {})
        return out.get("members") or []

    def member_add(self, peer: str) -> dict:
        return self.post("/v3/cluster/member/add", {"peerURLs": [peer]})

    def member_remove(self, member_id) -> dict:
        return self.post("/v3/cluster/member/remove",
                         {"ID": member_id})


_definite = jclient.definite_http_failure


class EtcdRegisterClient(jclient.Client):
    """Per-key register ops (read/write/cas) over independent-key
    tuples (tutorial 03-client.md)."""

    def __init__(self, http_factory=EtcdHttp):
        self.http_factory = http_factory
        self.http = None

    def open(self, test, node):
        c = EtcdRegisterClient(self.http_factory)
        c.http = self.http_factory(node)
        return c

    def invoke(self, test, op):
        k, v = independent.key_(op.value), independent.value_(op.value)
        key = f"/register/{k}"
        try:
            if op.f == "read":
                val, _ = self.http.get(key)
                val = None if val is None else int(val)
                return op.copy(type="ok",
                               value=independent.ktuple(k, val))
            if op.f == "write":
                self.http.put(key, str(v))
                return op.copy(type="ok")
            if op.f == "cas":
                old, new = v
                ok = self.http.cas(key, str(old), str(new))
                return op.copy(type="ok" if ok else "fail")
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:  # noqa: BLE001
            if _definite(e):
                return op.copy(type="fail", error=repr(e))
            return op.copy(type="info", error=repr(e))


class EtcdAppendClient(jclient.Client):
    """Elle list-append transactions, executed ATOMICALLY: snapshot
    reads of every touched key, then one kv/txn guarded on all their
    mod_revisions applying every append — so the recorded txn really is
    one serializable unit and the checker can't flag healthy etcd for
    interleavings between micro-ops (round-2 advisor finding). Guard
    conflicts retry with a fresh snapshot."""

    def __init__(self, http_factory=EtcdHttp, retries: int = 8):
        self.http_factory = http_factory
        self.retries = retries
        self.http = None

    def open(self, test, node):
        c = EtcdAppendClient(self.http_factory, self.retries)
        c.http = self.http_factory(node)
        return c

    def _attempt(self, mops):
        keys = {k for _f, k, _v in mops}
        snap = {k: self.http.get(f"/append/{k}") for k in keys}
        lists = {k: (json.loads(v) if v else [])
                 for k, (v, _r) in snap.items()}
        seen_empty = {k for k, (v, _r) in snap.items() if v is None}
        out = []
        dirty = set()
        for f, k, v in mops:
            if f == "r":
                cur = lists[k]
                out.append(["r", k,
                            None if (k in seen_empty and k not in dirty
                                     and not cur) else list(cur)])
            else:
                lists[k].append(v)
                dirty.add(k)
                out.append(["append", k, v])
        guards = [(f"/append/{k}", snap[k][1]) for k in sorted(keys)]
        puts = [(f"/append/{k}", json.dumps(lists[k]))
                for k in sorted(dirty)]
        if not puts and len(keys) <= 1:
            return out  # a single-key read is atomic by itself
        if self.http.txn_rw(guards, puts):
            return out
        return None

    def invoke(self, test, op):
        try:
            for _ in range(self.retries):
                out = self._attempt(op.value)
                if out is not None:
                    return op.copy(type="ok", value=out)
            # every attempt's guard failed BEFORE any put applied:
            # provably nothing committed, so this is a definite :fail
            return op.copy(type="fail",
                           error="txn contention exhausted retries")
        except Exception as e:  # noqa: BLE001
            if _definite(e):
                return op.copy(type="fail", error=repr(e))
            return op.copy(type="info", error=repr(e))


# ---------------------------------------------------------------------------
# Membership
# ---------------------------------------------------------------------------

class EtcdMembership(membership.MembershipState):
    """Join/remove etcd members through the v3 cluster gateway
    (exercises nemesis/membership.clj's state-machine shape against a
    real member API). Views are frozensets of member names; a name->id
    map is kept for removals."""

    def __init__(self, http_factory=EtcdHttp, db: EtcdDB | None = None,
                 seed=None):
        super().__init__()
        self.http_factory = http_factory
        self.db = db
        self.member_ids: dict = {}
        self.rng = random.Random(seed)

    def node_view(self, test, node):
        try:
            members = self.http_factory(node).members()
        except Exception:  # noqa: BLE001 — node down: view unknown
            return None
        names = set()
        for m in members:
            name = m.get("name") or f"id:{m.get('ID')}"
            names.add(name)
            if m.get("ID") is not None:
                self.member_ids[name] = m["ID"]
        return frozenset(names)

    def merge_views(self, test):
        """Majority view wins; ties go to the largest view (prefer
        believing a node exists over not)."""
        views = list(self.node_views.values())
        if not views:
            return None
        counts: dict = {}
        for v in views:
            counts[v] = counts.get(v, 0) + 1
        return max(counts, key=lambda v: (counts[v], len(v)))

    def fs(self):
        return {"add-member", "remove-member"}

    def op(self, test):
        from .. import generator as gen

        if self.view is None or self.pending:
            return gen.PENDING
        nodes = set(map(str, test.get("nodes", ())))
        active = set(self.view) & nodes
        removed = nodes - set(self.view)
        # shrink while strictly above the majority floor, then grow
        # back — never create a quorum-less (useless) cluster state
        # (membership.clj principle 1). Random targets so churn
        # covers every node over a run, not one fixed victim.
        if active and len(active) > (len(nodes) // 2) + 1:
            return {"type": "info", "f": "remove-member",
                    "value": self.rng.choice(sorted(active))}
        if removed:
            return {"type": "info", "f": "add-member",
                    "value": self.rng.choice(sorted(removed))}
        return gen.PENDING

    def _any_http(self, test, exclude=None):
        for n_ in test.get("nodes", ()):
            if str(n_) != exclude and str(n_) in (self.view or ()):
                return self.http_factory(n_)
        return self.http_factory(test["nodes"][0])

    def invoke(self, test, op):
        target = op.value
        try:
            if op.f == "remove-member":
                mid = self.member_ids.get(target)
                if mid is None:
                    return op.copy(value=[target, "unknown-member"])
                self._any_http(test, exclude=target).member_remove(mid)
                return op.copy(value=[target, "removed"])
            if op.f == "add-member":
                self._any_http(test).member_add(peer_url(target))
                if self.db is not None:
                    cluster = ",".join(
                        f"{m}={peer_url(m)}"
                        for m in sorted(set(self.view) | {target}))
                    with control.with_session(test, target):
                        with control.su():
                            # a removed member's stale data dir makes
                            # etcd restart with its old (permanently
                            # removed) identity and get rejected by
                            # peers; rejoin must start clean
                            control.exec_("rm", "-rf",
                                          f"{DIR}/{target}.etcd")
                        self.db.setup_daemon_only(
                            test, target, cluster_state="existing",
                            cluster=cluster)
                return op.copy(value=[target, "added"])
            raise ValueError(f"unknown membership f {op.f!r}")
        except Exception as e:  # noqa: BLE001
            return op.copy(value=[target, f"error: {e!r}"])

    def resolve_op(self, test, pair):
        _inv, done = pair
        d = dict(done)
        f, val = d.get("f"), d.get("value")
        if not isinstance(val, tuple) or len(val) != 2:
            return True  # malformed/errored: nothing to wait for
        target, status = val
        if isinstance(status, str) and status.startswith("error"):
            return True
        if self.view is None:
            return False
        if f == "remove-member":
            return target not in self.view
        if f == "add-member":
            return target in self.view
        return True


def membership_package(opts: dict) -> dict | None:
    """An etcd membership package for nemesis composition. Without an
    explicit membership db, the test's db is used so re-added members
    actually get their daemon started (a voting member added via the
    API but never started would hold the nemesis pending forever and
    put quorum one failure away)."""
    o = dict(opts)
    mopts = dict(o.get("membership") or {})
    mopts.setdefault("state", EtcdMembership(
        http_factory=mopts.pop("http_factory", EtcdHttp),
        db=mopts.pop("db", o.get("db")),
        seed=mopts.pop("seed", None)))
    o["membership"] = mopts
    return membership.package(o)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def r(rng):
    return {"f": "read", "value": None}


def w(rng):
    return {"f": "write", "value": rng.randrange(5)}


def cas(rng):
    return {"f": "cas", "value": [rng.randrange(5), rng.randrange(5)]}


def register_workload(opts: dict) -> dict:
    rng = random.Random(opts.get("seed"))
    keys = list(range(opts.get("keys", 4)))
    return {
        "client": EtcdRegisterClient(),
        "generator": independent.concurrent_generator(
            opts["concurrency"], keys,
            lambda k: gen.limit(opts.get("ops_per_key", 200),
                                lambda: rng.choice([r, w, cas])(rng))),
        "checker": independent.checker(chk.linearizable(
            {"model": models.cas_register(),
             "device": opts.get("device")})),
    }


def append_workload(opts: dict) -> dict:
    w = workloads.txn_append.workload(
        {"ops": opts.get("ops", 1000), "seed": opts.get("seed"),
         "device": opts.get("device")})
    w["client"] = EtcdAppendClient()
    return w


WORKLOADS = {"register": register_workload, "append": append_workload}


def nemesis_for(opts: dict, db) -> dict:
    """A composed nemesis package from --nemesis faults (the
    reference's suites expose nemesis menus the same way,
    combined.clj nemesis-package). Membership wires through
    membership_package so its http_factory/seed/db sub-options apply;
    an empty fault set gives the classic partitioner schedule. Never
    mutates the caller's opts (a test-count sweep re-invokes the test
    fn with the same dict, and a reused membership state machine would
    carry the previous cluster's view)."""
    from ..nemesis import combined

    faults = set(opts.get("faults") or ())
    if not faults:
        return {"nemesis": jnemesis.partition_random_halves(),
                "generator": jnemesis.start_stop_cycle(5.0),
                "final_generator": None}
    o = dict(opts)
    o["membership"] = dict(opts.get("membership") or {})
    o.update(db=db, interval=opts.get("nemesis_interval", 10))
    pkgs = combined.nemesis_packages(
        {**o, "faults": faults - {"membership"}})
    if "membership" in faults:
        mp = membership_package({**o, "faults": {"membership"}})
        if mp is not None:
            pkgs.append(mp)
    return combined.compose_packages(pkgs)


def etcd_test(opts: dict) -> dict:
    """Constructs an etcd test map from CLI options (the tutorial's
    etcd-test / zookeeper.clj zk-test shape). opts["faults"] selects
    the nemesis menu (partition/packet/kill/pause/clock/
    file-corruption/membership); empty = classic partitioner."""
    name = opts.get("workload") or "register"
    w = WORKLOADS[name](opts)
    db = EtcdDB(opts.get("version", VERSION))
    pkg = nemesis_for(opts, db)
    test = testing.noop_test()
    test.update(
        name=f"etcd-{name}",
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
        generator=_suite_generator(opts, w["generator"], pkg))
    return test


def _suite_generator(opts, client_gen, pkg):
    """time-limit bounds client AND nemesis streams together (an
    unbounded nemesis cycle would keep the run alive forever); the
    package's final generator runs AFTER the limit so faults heal
    before teardown (combined.clj final-generator)."""
    client_part = gen.stagger(1.0 / opts.get("rate", 50), client_gen)
    nemesis_gen = pkg.get("generator")
    main = gen.time_limit(
        opts.get("time_limit", 30),
        gen.clients(client_part, nemesis_gen)
        if nemesis_gen is not None else gen.clients(client_part))
    final = pkg.get("final_generator")
    if final:
        return gen.phases(main, gen.nemesis(final))
    return main


def _workload_opt(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default register; test-all sweeps "
                        "all when omitted). " + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="etcd version tag to install.")
    p.add_argument("--rate", type=float, default=50)
    p.add_argument("--nemesis", dest="faults", default=None,
                   help="Comma-separated faults: partition,packet,"
                        "kill,pause,clock,file-corruption,membership. "
                        "Default: the classic partitioner schedule.")
    return p


def _opt_fn(opts: dict) -> dict:
    """single_test_cmd hands opt_fn the already-normalized opts dict
    (calling test_opt_fn again here was a TypeError — the --nemesis
    flag never worked from the real CLI)."""
    if opts.get("faults"):
        opts["faults"] = [f.strip()
                          for f in opts["faults"].split(",")
                          if f.strip()]
    return opts


FAULT_OPTIONS = ([], ["partition"], ["kill"], ["pause"], ["clock"],
                 ["partition", "kill"], ["membership"])


def all_tests(opts: dict):
    """The workload x fault sweep for test-all (the canonical suite
    shape: tidb/src/tidb/core.clj:47-60 workload-options). --workload
    and --nemesis narrow the matrix to the given values, and each
    combination repeats --test-count times, like the reference."""
    workloads = ([opts["workload"]] if opts.get("workload")
                 else sorted(WORKLOADS))
    fault_options = ([opts["faults"]] if opts.get("faults") is not None
                     else FAULT_OPTIONS)
    for _ in range(opts.get("test_count") or 1):
        for wname in workloads:
            for faults in fault_options:
                yield etcd_test({**opts, "workload": wname,
                                 "faults": list(faults)})


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(etcd_test,
                                        parser_fn=_workload_opt,
                                        opt_fn=_opt_fn))
    commands.update(cli.test_all_cmd(all_tests,
                                     parser_fn=_workload_opt,
                                     opt_fn=_opt_fn))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
