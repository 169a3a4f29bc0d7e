"""Dgraph test suite: upsert uniqueness, indexed deletes, linearizable
registers, sets, sequential consistency, bank, long-fork, and elle
rw-register against a zero+alpha cluster, with per-op trace spans.

Capability reference: dgraph/src/jepsen/dgraph/
  core.clj:28-40    — the workload map this suite mirrors
  support.clj       — /opt/dgraph layout, zero/alpha daemons + ports
                      (23-50), node-idx raft ids, --peer/--zero wiring
  client.clj        — txn lifecycle with conflict-as-fail; upsert =
                      query-then-insert-unless-exists
  upsert.clj        — at most one ok upsert per key; reads see <= 1 uid
  delete.clj        — upsert/delete/read per key; index must never
                      show more than one record
  linearizable_register.clj, set.clj, sequential.clj, bank.clj,
  long_fork.clj, wr.clj — workload semantics (generators + checkers
                      live in jepsen_tpu_torch.workloads)
  trace.clj         — per-op tracing spans (here: a jsonl span log
                      in the store dir instead of a jaeger exporter)

Transport: dgraph's public HTTP API on the alpha (mutate with upsert
blocks and conditional mutations, query, and the startTs/commit txn
protocol), driven through `curl` on each node. Clients depend only on
the semantic DgraphHTTP interface, so the clusterless tests substitute
an in-memory implementation with real txn-conflict behavior.

The port's copy of jepsen_tpu/suites/dgraph.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import json
import logging
import time

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import independent, testing
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..os_setup import debian
from ..workloads import bank as bank_wl
from ..workloads import long_fork as lf_wl
from ..workloads import sequential as seq_wl
from ..workloads import sets as sets_wl
from ..workloads import txn_wr as wr_wl
from ..workloads import upsert as upsert_wl

logger = logging.getLogger(__name__)

DIR = "/opt/dgraph"
VERSION = "23.1.0"
URL = ("https://github.com/dgraph-io/dgraph/releases/download/"
       f"v{VERSION}/dgraph-linux-amd64.tar.gz")
ZERO_PORT = 5080
ZERO_HTTP = 6080
ALPHA_INTERNAL = 7080
ALPHA_HTTP = 8080
ZERO = (f"{DIR}/zero.log", f"{DIR}/zero.pid")
ALPHA = (f"{DIR}/alpha.log", f"{DIR}/alpha.pid")


def node_idx(test, node) -> int:
    """1-based raft index (support.clj node-idx)."""
    return test["nodes"].index(node) + 1


class DgraphDB(jdb.DB):
    """Installs and runs a zero+alpha per node (support.clj db)."""

    supports_kill = True

    def __init__(self, version: str = VERSION, replicas: int = 3):
        self.version = version
        self.replicas = replicas

    def setup(self, test, node):
        with control.su():
            cu.install_archive(URL, DIR)
        self._start_zero(test, node)
        time.sleep(2)
        self._start_alpha(test, node)
        cu.await_tcp_port(ALPHA_HTTP, timeout_secs=120)

    def _start_zero(self, test, node):
        idx = node_idx(test, node)
        peer = [] if idx == 1 else \
            ["--peer", f"{test['nodes'][0]}:{ZERO_PORT}"]
        with control.su():
            cu.start_daemon(
                {"chdir": DIR, "logfile": ZERO[0], "pidfile": ZERO[1]},
                f"{DIR}/dgraph", "zero", "--raft",
                f"idx={idx}", "--my", f"{node}:{ZERO_PORT}",
                "--replicas", str(self.replicas), *peer)

    def _start_alpha(self, test, node):
        with control.su():
            cu.start_daemon(
                {"chdir": DIR, "logfile": ALPHA[0],
                 "pidfile": ALPHA[1]},
                f"{DIR}/dgraph", "alpha", "--my",
                f"{node}:{ALPHA_INTERNAL}", "--zero",
                f"{test['nodes'][0]}:{ZERO_PORT}",
                "--security", "whitelist=0.0.0.0/0")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", f"{DIR}/p", f"{DIR}/w",
                          f"{DIR}/zw", ZERO[0], ALPHA[0], check=False)

    def log_files(self, test, node):
        return [ZERO[0], ALPHA[0]]

    def kill(self, test, node):
        with control.su():
            cu.grepkill("dgraph")
            control.exec_("rm", "-rf", ZERO[1], ALPHA[1], check=False)

    def start(self, test, node):
        self._start_zero(test, node)
        self._start_alpha(test, node)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------


class TxnConflict(Exception):
    """Commit-time conflict (client.clj with-conflict-as-fail)."""


class DgraphHTTP:
    """Semantic operations over the alpha HTTP API. Real transport is
    curl on the node; the clusterless tests swap this class out."""

    def __init__(self, test, node, timeout: float = 10.0):
        self.node = node
        self.base = f"http://localhost:{ALPHA_HTTP}"
        self.timeout = timeout

    def _post(self, path: str, body: str,
              content_type: str = "application/json") -> dict:
        out = control.exec_(
            "curl", "-sf", "--max-time", str(int(self.timeout)),
            "-XPOST", f"{self.base}{path}",
            "-H", f"Content-Type: {content_type}", "-d", body)
        resp = json.loads(out)
        errors = resp.get("errors")
        if errors:
            msg = json.dumps(errors)
            if "conflict" in msg.lower() or "aborted" in msg.lower():
                raise TxnConflict(msg)
            raise RemoteError("dgraph error", exit=1, out=out, err=msg,
                              cmd=path, node=self.node)
        return resp

    def alter_schema(self, schema: str) -> None:
        # /alter takes the raw schema text as its body
        self._post("/alter", schema, "application/dql")

    def _upsert_block(self, query: str, mutations: list[tuple]) -> str:
        """The textual upsert-block format application/rdf implies:
        upsert { query {...} mutation @if(...) { set/delete {...} } }
        (one mutation clause per (cond, verb, nquads) tuple)."""
        parts = [f"upsert {{\n  query {query}\n"]
        for cond, verb, nquads in mutations:
            cond_s = f" {cond}" if cond else ""
            parts.append(
                f"  mutation{cond_s} {{ {verb} {{ {nquads} }} }}\n")
        parts.append("}")
        return "".join(parts)

    def upsert_unless_exists(self, pred: str, key, extra: dict
                             ) -> str | None:
        """Insert-unless-exists via an upsert block with a conditional
        mutation (client.clj upsert!): returns the created uid, or
        None when a record already existed."""
        nquads = " ".join(
            f'_:u <{p}> "{v}" .' for p, v in
            dict(extra, **{pred: key}).items())
        body = self._upsert_block(
            f'{{ q(func: eq({pred}, "{key}")) {{ v as uid }} }}',
            [("@if(eq(len(v), 0))", "set", nquads)])
        resp = self._post("/mutate?commitNow=true", body,
                          "application/rdf")
        uids = resp.get("data", {}).get("uids") or {}
        return next(iter(uids.values()), None)

    def delete_where(self, pred: str, key) -> int:
        """Delete every record matching pred=key (delete.clj)."""
        body = self._upsert_block(
            f'{{ q(func: eq({pred}, "{key}")) {{ v as uid }} }}',
            [(None, "delete", "uid(v) * * .")])
        resp = self._post("/mutate?commitNow=true", body,
                          "application/rdf")
        return len(resp.get("data", {}).get("uids") or {})

    def query_eq(self, pred: str, key, want=("uid",)) -> list[dict]:
        fields = "\n".join(want)
        q = f'{{ q(func: eq({pred}, "{key}")) {{ {fields} }} }}'
        resp = self._post("/query", q, "application/dql")
        return resp.get("data", {}).get("q", [])

    def write_value(self, pred: str, key, vpred: str, value) -> None:
        """Upsert pred=key record and set vpred=value on it, in one
        atomic upsert block (linearizable_register.clj write). Two
        conditional mutations: update-in-place when the record exists,
        create only when it doesn't — an unconditional _:new would
        accumulate a duplicate record on EVERY write."""
        body = self._upsert_block(
            f'{{ q(func: eq({pred}, "{key}")) {{ v as uid }} }}',
            [("@if(gt(len(v), 0))", "set",
              f'uid(v) <{vpred}> "{value}" .'),
             ("@if(eq(len(v), 0))", "set",
              f'_:new <{pred}> "{key}" . '
              f'_:new <{vpred}> "{value}" .')])
        self._post("/mutate?commitNow=true", body, "application/rdf")

    # -- explicit transactions (startTs/commit protocol) ---------------

    def txn_begin(self) -> dict:
        return {"start_ts": None, "keys": [], "preds": []}

    def _merge_ctx(self, txn: dict, resp: dict) -> None:
        ext = resp.get("extensions", {}).get("txn", {})
        if ext.get("start_ts"):
            txn["start_ts"] = ext["start_ts"]
        txn["keys"] += ext.get("keys", [])
        txn["preds"] += ext.get("preds", [])

    def txn_query(self, txn: dict, pred: str, key,
                  want=("uid",)) -> list[dict]:
        ts = f"?startTs={txn['start_ts']}" if txn["start_ts"] else ""
        fields = "\n".join(want)
        q = f'{{ q(func: eq({pred}, "{key}")) {{ {fields} }} }}'
        resp = self._post(f"/query{ts}", q, "application/dql")
        self._merge_ctx(txn, resp)
        return resp.get("data", {}).get("q", [])

    def txn_set(self, txn: dict, nquads: str) -> None:
        ts = f"?startTs={txn['start_ts']}" if txn["start_ts"] else ""
        resp = self._post(f"/mutate{ts}",
                          f"{{ set {{ {nquads} }} }}",
                          "application/rdf")
        self._merge_ctx(txn, resp)

    def txn_commit(self, txn: dict) -> None:
        if txn["start_ts"] is None:
            return
        self._post(f"/commit?startTs={txn['start_ts']}",
                   json.dumps({"keys": txn["keys"],
                               "preds": txn["preds"]}))


# ---------------------------------------------------------------------------
# Per-op tracing (trace.clj analog)
# ---------------------------------------------------------------------------


class TraceClient(jclient.Client):
    """Wraps a client, appending one span per invocation (name, node,
    wall-clock start/end, result type) to <store_dir>/trace.jsonl —
    the role trace.clj's jaeger spans play for the reference."""

    def __init__(self, inner: jclient.Client, path=None):
        self.inner = inner
        self.path = path
        self.node = None

    def open(self, test, node):
        path = self.path
        if path is None and isinstance(test, dict) \
                and test.get("store_dir"):
            path = f"{test['store_dir']}/trace.jsonl"
        c = TraceClient(self.inner.open(test, node), path)
        c.node = node
        return c

    def setup(self, test):
        self.inner.setup(test)
        return self

    def close(self, test):
        self.inner.close(test)

    def invoke(self, test, op):
        t0 = time.time()
        out = self.inner.invoke(test, op)
        if self.path:
            span = {"f": op.f, "node": self.node,
                    "process": op.process, "start": t0,
                    "end": time.time(),
                    "type": getattr(out, "type", None)}
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(span) + "\n")
            except OSError:
                pass
        return out


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------


class _DgClient(jclient.Client):
    http_factory = DgraphHTTP
    schema = None

    def __init__(self, http_factory=None):
        if http_factory is not None:
            self.http_factory = http_factory
        self.http = None

    def open(self, test, node):
        c = type(self)(self.http_factory)
        c.http = self.http_factory(test, node)
        return c

    def setup(self, test):
        if self.schema and self.http is not None:
            self.http.alter_schema(self.schema)
        return self

    def close(self, test):
        self.http = None

    def _guard(self, op, fn, indeterminate=("upsert", "delete",
                                            "write", "transfer")):
        try:
            return fn()
        except TxnConflict as e:
            return op.copy(type="fail", error=f"conflict: {e}")
        except RemoteError as e:
            t = "info" if op.f in indeterminate else "fail"
            return op.copy(type=t, error=str(e))


class UpsertClient(_DgClient):
    """upsert.clj client: upsert by indexed email; ok iff created."""

    schema = "email: string @index(exact) @upsert ."

    def invoke(self, test, op):
        k, _v = op.value

        def go():
            if op.f == "upsert":
                uid = self.http.upsert_unless_exists("email", k, {})
                if uid is None:
                    return op.copy(type="fail", error="present")
                return op.copy(type="ok", value=(k, uid))
            uids = sorted(r["uid"] for r in
                          self.http.query_eq("email", k))
            return op.copy(type="ok", value=(k, uids))

        return self._guard(op, go)


class DeleteClient(_DgClient):
    """delete.clj client: upsert/delete/read one indexed key."""

    schema = "key: int @index(int) @upsert ."

    def invoke(self, test, op):
        k, _v = op.value

        def go():
            if op.f == "upsert":
                uid = self.http.upsert_unless_exists("key", k, {})
                if uid is None:
                    return op.copy(type="fail", error="present")
                return op.copy(type="ok", value=(k, uid))
            if op.f == "delete":
                n = self.http.delete_where("key", k)
                return op.copy(type="ok" if n else "fail",
                               value=(k, n))
            rows = self.http.query_eq("key", k, want=("uid", "key"))
            return op.copy(type="ok", value=(k, rows))

        return self._guard(op, go)


class RegisterClient(_DgClient):
    """linearizable_register.clj client over independent keys:
    read/write (cas unsupported by the reference client either)."""

    schema = ("key: int @index(int) @upsert .\n"
              "val: int .")

    def invoke(self, test, op):
        k, v = op.value

        def go():
            if op.f == "read":
                rows = self.http.query_eq("key", k,
                                          want=("uid", "val"))
                vals = [r.get("val") for r in rows if "val" in r]
                return op.copy(type="ok",
                               value=(k, vals[0] if vals else None))
            self.http.write_value("key", k, "val", v)
            return op.copy(type="ok")

        return self._guard(op, go)


class SetClient(_DgClient):
    """set.clj client: add unique ints, read them all back."""

    schema = ("type: string @index(exact) .\n"
              "value: int @index(int) .")

    def invoke(self, test, op):
        def go():
            if op.f == "add":
                self.http.upsert_unless_exists(
                    "value", op.value, {"type": "element"})
                return op.copy(type="ok")
            rows = self.http.query_eq("type", "element",
                                      want=("value",))
            return op.copy(type="ok", value=sorted(
                int(r["value"]) for r in rows if "value" in r))

        return self._guard(op, go, indeterminate=("add",))


class SequentialClient(_DgClient):
    """sequential.clj client: each subkey insert is its own txn;
    reads walk the subkeys in reverse (workloads.sequential)."""

    schema = "skey: string @index(exact) ."

    def __init__(self, http_factory=None, key_count: int = 5):
        super().__init__(http_factory)
        self.key_count = key_count

    def open(self, test, node):
        c = super().open(test, node)
        c.key_count = self.key_count
        return c

    def invoke(self, test, op):
        key_count = self.key_count

        def go():
            if op.f == "write":
                for sk in seq_wl.subkeys(key_count, op.value):
                    self.http.upsert_unless_exists("skey", sk, {})
                return op.copy(type="ok")
            obs = []
            for sk in reversed(seq_wl.subkeys(key_count, op.value)):
                rows = self.http.query_eq("skey", sk)
                obs.append(sk if rows else None)
            return op.copy(type="ok", value=(op.value, obs))

        return self._guard(op, go, indeterminate=("write",))


class BankClient(_DgClient):
    """bank.clj client: accounts are records keyed by account id;
    transfer moves amount inside one explicit txn (conflict=fail)."""

    schema = ("acct: int @index(int) @upsert .\n"
              "amount: int .")
    accounts = tuple(range(8))
    initial = 10

    def setup(self, test):
        super().setup(test)
        if self.http is not None:
            for a in self.accounts:
                try:
                    self.http.upsert_unless_exists(
                        "acct", a, {"amount": self.initial})
                except (TxnConflict, RemoteError):
                    pass
        return self

    def _balances(self, txn=None) -> dict:
        out = {}
        for a in self.accounts:
            rows = (self.http.txn_query(txn, "acct", a,
                                        want=("uid", "amount"))
                    if txn is not None else
                    self.http.query_eq("acct", a,
                                       want=("uid", "amount")))
            if rows:
                out[a] = int(rows[0].get("amount", 0))
        return out

    def invoke(self, test, op):
        def go():
            if op.f == "read":
                # startTs-pinned txn: 8 per-account queries at ONE
                # timestamp, not 8 independent snapshots
                txn = self.http.txn_begin()
                return op.copy(type="ok", value=self._balances(txn))
            frm, to, amt = (op.value["from"], op.value["to"],
                            op.value["amount"])
            txn = self.http.txn_begin()
            bal = self._balances(txn)
            if bal.get(frm, 0) - amt < 0:
                return op.copy(type="fail", error="insufficient")
            if to not in bal:
                # destination record absent (setup raced a fault):
                # definite no-op, not a crash
                return op.copy(type="fail", error="no such account")
            rows_f = self.http.txn_query(txn, "acct", frm,
                                         want=("uid",))
            rows_t = self.http.txn_query(txn, "acct", to,
                                         want=("uid",))
            if not rows_f or not rows_t:
                return op.copy(type="fail", error="no such account")
            self.http.txn_set(
                txn,
                f'<{rows_f[0]["uid"]}> <amount> '
                f'"{bal[frm] - amt}" .\n'
                f'<{rows_t[0]["uid"]}> <amount> '
                f'"{bal[to] + amt}" .')
            self.http.txn_commit(txn)
            return op.copy(type="ok")

        return self._guard(op, go)


class TxnClient(_DgClient):
    """wr.clj / long_fork.clj client: [f, k, v] micro-ops in one
    explicit txn; reads fill in values, conflicts fail the txn."""

    schema = ("tkey: int @index(int) @upsert .\n"
              "tval: int .")

    def invoke(self, test, op):
        def go():
            txn = self.http.txn_begin()
            out = []
            wrote = False
            for f, k, v in op.value:
                if f == "r":
                    rows = self.http.txn_query(
                        txn, "tkey", k, want=("uid", "tval"))
                    vals = [r["tval"] for r in rows if "tval" in r]
                    out.append([f, k, vals[0] if vals else None])
                else:  # w
                    rows = self.http.txn_query(txn, "tkey", k,
                                               want=("uid",))
                    if rows:
                        self.http.txn_set(
                            txn, f'<{rows[0]["uid"]}> <tval> "{v}" .')
                    else:
                        self.http.txn_set(
                            txn, f'_:n <tkey> "{k}" .\n'
                                 f'_:n <tval> "{v}" .')
                    wrote = True
                    out.append([f, k, v])
            self.http.txn_commit(txn)
            return op.copy(type="ok", value=out)

        try:
            return go()
        except TxnConflict as e:
            return op.copy(type="fail", error=f"conflict: {e}")
        except RemoteError as e:
            return op.copy(type="info", error=str(e))


# ---------------------------------------------------------------------------
# Workloads (core.clj:28-40)
# ---------------------------------------------------------------------------


def _with_client(w: dict, client) -> dict:
    w["client"] = client
    return w


def upsert(opts):
    return _with_client(upsert_wl.workload(opts), UpsertClient())


def delete(opts):
    """upsert/delete/read per independent key; no read may ever see
    more than one record for a key (delete.clj checker)."""
    o = dict(opts or {})
    keys = o.get("keys", list(range(o.get("key_count", 8))))

    def check(test, hist, copts):
        bad = [op for op in hist
               if op.type == "ok" and op.f == "read"
               and isinstance(op.value, (list, tuple))
               and len(op.value) > 1]
        return {"valid?": not bad,
                "bad-reads": [o_.to_dict() for o_ in bad[:8]]}

    def key_gen(k, kopts):
        import random as _r

        rng = _r.Random(None if o.get("seed") is None
                        else repr((o.get("seed"), k)))

        def one():
            f = rng.choice(["upsert", "delete", "read"])
            return {"f": f, "value": None}

        return gen.limit(o.get("ops_per_key", 30), one)

    return {
        "generator": independent.concurrent_generator(
            o.get("group_size", 3), keys, lambda k: key_gen(k, o)),
        "checker": independent.checker(chk.checker(check)),
        "client": DeleteClient(),
    }


def linearizable_register(opts):
    o = dict(opts or {})
    from ..workloads import register as register_wl

    w = register_wl.workload(dict(o, initial=None))
    # dgraph's reference client has no cas; restrict the mix
    keys = o.get("keys", list(range(8)))

    def key_gen(k):
        import random as _r

        rng = _r.Random(None if o.get("seed") is None
                        else repr((o.get("seed"), k)))

        def one():
            if rng.random() < 0.5:
                return {"f": "read", "value": None}
            return {"f": "write", "value": rng.randrange(5)}

        return gen.limit(o.get("ops_per_key", 60), one)

    w["generator"] = independent.concurrent_generator(
        o.get("group_size", 4), keys, key_gen)
    return _with_client(w, RegisterClient())


def set_workload(opts):
    return _with_client(sets_wl.workload(opts), SetClient())


def sequential(opts):
    o = dict(opts or {})
    return _with_client(
        seq_wl.workload(o),
        SequentialClient(key_count=o.get("key-count", 5)))


def bank(opts):
    return _with_client(bank_wl.workload(opts), BankClient())


def long_fork(opts):
    return _with_client(lf_wl.workload(opts), TxnClient())


def wr(opts):
    return _with_client(wr_wl.workload(opts), TxnClient())


WORKLOADS = {
    "upsert": upsert,
    "delete": delete,
    "linearizable-register": linearizable_register,
    "set": set_workload,
    "sequential": sequential,
    "bank": bank,
    "long-fork": long_fork,
    "wr": wr,
}


def nemesis_for(opts: dict, db) -> dict:
    from ..nemesis import combined

    faults = set(opts.get("faults") or ("partition", "kill"))
    o = dict(opts)
    o.update(db=db, faults=faults,
             interval=opts.get("nemesis_interval", 15))
    return combined.compose_packages(combined.nemesis_packages(o))


def dgraph_test(opts: dict) -> dict:
    name = opts.get("workload") or "upsert"
    w = WORKLOADS[name](opts)
    db = DgraphDB(version=opts.get("version", VERSION),
                  replicas=opts.get("replicas", 3))
    pkg = nemesis_for(opts, db)
    client = w["client"]
    if opts.get("trace"):
        client = TraceClient(client)
    test = testing.noop_test()
    test.update(
        name=f"dgraph-{name}",
        os=debian.os,
        db=db,
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=client,
        nemesis=pkg["nemesis"],
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=_suite_generator(opts, w, pkg))
    for extra in ("total-amount", "accounts"):
        if extra in w:
            test[extra] = w[extra]
    return test


def _suite_generator(opts, w, pkg):
    nemesis_gen = pkg.get("generator")
    client_part = gen.stagger(1.0 / opts.get("rate", 15),
                              w["generator"])
    mix = gen.time_limit(
        opts.get("time_limit", 60),
        gen.clients(client_part, nemesis_gen)
        if nemesis_gen is not None else gen.clients(client_part))
    parts = [mix]
    final = w.get("final_generator")
    if final is not None:
        parts.append(gen.sleep(opts.get("recovery_time", 10)))
        parts.append(gen.clients(final))
    return parts[0] if len(parts) == 1 else gen.phases(*parts)


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default upsert). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--rate", type=float, default=15)
    p.add_argument("--version", default=VERSION)
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--trace", action="store_true",
                   help="per-op trace spans to store/trace.jsonl")
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(dgraph_test, parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
