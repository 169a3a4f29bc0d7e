"""The port's suite registry (jepsen_tpu_torch/suites/__init__.py) against
the JAX package's, and the helpers the other tests/test_torch_suites_*.py
files share.

- SUITES has the JAX package's 21 names in the same order; `load` of each
  name returns the port's module (all 21 are ported: the A10a suites and
  ROADMAP A10b's eight), an unknown name raises KeyError with the JAX
  package's message.
- The helpers drive one package's suite (`root` "jepsen_tpu" or
  "jepsen_tpu_torch") against the in-memory fakes of the JAX suite tests
  (tests/test_<suite>.py): each package's clients see their own
  package's Result and RemoteError, so a fake's replies are rebuilt per
  package, and the JAX test files stay as they are.
- Command streams are the DB's actions on the dummy remote per node:
  command, stdin, sudo user, directory and uploads.
- A whole run records its history on one package's interpreter; the
  history goes through both packages' checkers (rebuilt through dicts)
  and the two results must be equal, with the JAX analyzer names read
  as the port's.
- A stored run of one package is analysed by each package's
  resume.analyze_run with its own suite's builder; the results must be
  equal untimed.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import random
import re
import shutil

import pytest

import chip_smoke as cs

PORT, JAX = "jepsen_tpu_torch", "jepsen_tpu"
ROOTS = (JAX, PORT)
RENAME = {"tpu": "gpu", "tpu-segmented": "gpu-segmented",
          "tpu-extend": "gpu-extend",
          "tpu+host-fallback": "gpu+host-fallback"}
PORTED = ("aerospike", "cockroach", "consul", "crate", "dgraph", "disque",
          "elasticsearch", "etcd", "galera", "hazelcast", "mongodb",
          "postgres", "rabbitmq", "raftis", "redis-sentinel", "rethinkdb",
          "stolon", "tidb", "voltdb", "yugabyte", "zookeeper")
# ROADMAP A10b: the suites chip_smoke runs in phase 28
A10B = ("cockroach", "dgraph", "disque", "elasticsearch", "hazelcast",
        "rabbitmq", "tidb", "yugabyte")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def suite(root, name):
    return mod(root, f"suites.{name}")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    """net's module-level address cache, cleared in both packages around
    each test (a test that resolved n1 elsewhere on the worker would
    otherwise answer for these tests' dummy remotes)."""
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


def device_opts(root, opts: dict) -> dict:
    """opts with device "cpu" for the port (its checkers run on the card
    unless asked)."""
    return dict(opts, device="cpu") if root == PORT else dict(opts)


# ---------------------------------------------------------------------------
# the dummy remote and command streams
# ---------------------------------------------------------------------------

def as_result(root, r):
    """A fake's reply (None, text, or a JAX Result) for root's dummy
    remote: a Result becomes root's own Result."""
    if r is None or isinstance(r, str):
        return r
    return mod(root, "control.core").Result(exit=r.exit, out=r.out,
                                            err=r.err, cmd=r.cmd)


def responder_for(root, responder):
    if responder is None:
        return None
    return lambda node, action: as_result(root, responder(node, action))


def make_test(root, responder=None, nodes=("n1", "n2", "n3"),
              prepare=False, **kw):
    """root's noop test on a dummy remote with a session a node;
    prepare: through core.prepare_test (its barrier for
    core.synchronize)."""
    remote = mod(root, "control.dummy").DummyRemote(
        responder_for(root, responder))
    t = mod(root, "testing").noop_test()
    t.update(nodes=list(nodes), remote=remote,
             sessions={n: remote.connect({"host": n}) for n in nodes},
             **kw)
    return mod(root, "core").prepare_test(t) if prepare else t


# control.util's temporary names (tmp_dir, tmp_file) draw a random int
TMP = re.compile(r"(/tmp/jepsen/)\d+")


def _tmp(x):
    return TMP.sub(r"\1<tmp>", x) if isinstance(x, str) else x


def stream(root, test) -> dict:
    """Each node's actions on the test's dummy sessions, in order, with
    the random part of temporary names masked."""
    return log_stream(root, test["sessions"])


def log_stream(root, sessions: dict) -> dict:
    Action = mod(root, "control.core").Action
    out = {}
    for node, sess in sessions.items():
        acts = []
        for a in sess.log:
            if isinstance(a, Action):
                acts.append(("exec", _tmp(a.cmd), a.stdin, a.sudo,
                             _tmp(a.dir)))
            else:
                acts.append((a[0], _tmp(a[2])))
        out[node] = acts
    return out


def db_stream(root, name, make_db, calls, responder=None,
              nodes=("n1", "n2", "n3"), **kw) -> dict:
    """The command stream of root's DB: `calls` is a list of (method,
    node or None); None runs the method on every node at once, through
    control.on_nodes, as core.run does."""
    control = mod(root, "control")
    test = make_test(root, responder, nodes, **kw)
    db = make_db(suite(root, name), root)
    for method, node in calls:
        if node is None:
            control.on_nodes(test, lambda t, n, m=method:
                             getattr(db, m)(t, n))
        else:
            with control.with_session(test, node):
                getattr(db, method)(test, node)
    return stream(root, test)


def both_streams(name, make_db, calls, responder=None, **kw):
    """The two packages' streams, held equal; returns the port's."""
    port = db_stream(PORT, name, make_db, calls, responder, **kw)
    jax = db_stream(JAX, name, make_db, calls, responder, **kw)
    assert port == jax
    assert any(port.values())
    return port


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def op(root, f, value=None, process=0):
    return mod(root, "history").Op(index=0, time=0, type="invoke",
                                   process=process, f=f, value=value)


def outcome(o) -> tuple:
    return (o.type, o.f, o.value, o.get("error") if hasattr(o, "get")
            else getattr(o, "error", None))


def drive(root, client, script, test=None) -> list:
    """Invokes each (f, value) of script on an opened client; returns
    the completions' (type, f, value, error)."""
    test = test if test is not None else {"nodes": ["n1"]}
    out = []
    for f, value in script:
        out.append(outcome(client.invoke(test, op(root, f, value))))
    return out


def remote_error(root, msg="failed", **kw):
    kw.setdefault("exit", 1)
    kw.setdefault("out", "")
    kw.setdefault("err", msg)
    kw.setdefault("cmd", "cmd")
    kw.setdefault("node", "n1")
    return mod(root, "control.core").RemoteError(msg, **kw)


class Raising:
    """A transport factory whose every call raises what make(root)
    builds."""

    def __init__(self, root, make):
        self.root, self.make = root, make

    def __call__(self, *_a, **_kw):
        outer = self

        class _T:
            def _raise(self, *_a, **_kw):
                raise outer.make(outer.root)

            run = stmt = run_command = get = put = cas = _raise
            cas_create = txn_rw = request = cmd = _raise
            upsert_unless_exists = delete_where = query_eq = _raise
            write_value = txn_query = txn_set = txn_commit = _raise
            alter_schema = _raise

            def forget_master(self):
                pass

            def txn_begin(self):
                return {"start_ts": None, "keys": [], "preds": []}

            def close(self):
                pass

        return _T()


# ---------------------------------------------------------------------------
# whole runs and their checks
# ---------------------------------------------------------------------------

def norm(x):
    """A result tree in plain data (chip_smoke's _norm), with the JAX
    analyzer names read as the port's."""
    x = cs._norm(x)

    def walk(v):
        if isinstance(v, dict):
            return {k: (RENAME.get(w, w) if k == "analyzer"
                        and isinstance(w, str) else walk(w))
                    for k, w in v.items()}
        if isinstance(v, list):
            return [walk(w) for w in v]
        return v

    return walk(x)


def run_workload(root, name, workload, opts, attr, factory, nodes=("n1",
                 "n2"), concurrency=4, stagger=0.0004, limit=None,
                 final=False, extra=()):
    """core.run of root's suite workload (a function's name, or
    workload(suite module, opts)) over the noop test, its client's
    transport `attr` set to factory(root); returns the test. limit
    bounds the generator; final runs the workload's
    final generator after it, on every thread; extra names the
    workload's keys the test map carries (tidb's "lf-table", the bank's
    "total-amount" and "accounts")."""
    s = suite(root, name)
    gen = mod(root, "generator")
    w = built(s, workload, device_opts(root, opts))
    setattr(w["client"], attr, factory(root))
    g = w["generator"] if "generator" in w else w["mix"]
    if limit is not None:
        g = gen.limit(limit, g)
    g = gen.clients(gen.stagger(stagger, g))
    if final:
        g = gen.phases(g, gen.clients(w.get("final_generator",
                                            w.get("drain"))))
    test = mod(root, "testing").noop_test()
    test.update(nodes=list(nodes), concurrency=concurrency,
                client=w["client"], checker=w["checker"], generator=g,
                **{k: w[k] for k in extra if k in w})
    return mod(root, "core").run(test)


def built(s, workload, opts) -> dict:
    """Suite module s's workload: a function's name, or a function of
    (s, opts)."""
    if callable(workload):
        return workload(s, opts)
    return getattr(s, workload)(opts)


def workload_checker(name, workload, opts):
    """make_checker for check_both: the suite workload's checker on a
    package."""
    return lambda root: built(suite(root, name), workload,
                              device_opts(root, opts))["checker"]


def check_both(make_checker, test) -> tuple[dict, dict]:
    """The recorded history through both packages' checkers
    (make_checker(root)), each over its own package's ops rebuilt
    through dicts; returns (port's result, JAX's)."""
    dicts = [o.to_dict() for o in test["history"]]
    out = []
    for root in (PORT, JAX):
        hist = mod(root, "history").History(dicts, assign_indices=False)
        t = {k: v for k, v in test.items()
             if k not in ("history", "results", "checker", "client",
                          "generator", "remote", "sessions")}
        out.append(mod(root, "checker").check(make_checker(root), t, hist))
    return out[0], out[1]


def held_by_both(test, make_checker, want_valid) -> dict:
    """A whole run's verdict want_valid, and its history checked by both
    packages with equal results; returns the port's result."""
    assert test["results"]["valid?"] is want_valid, test["results"]
    port, jax = check_both(make_checker, test)
    assert norm(port) == norm(jax)
    assert port["valid?"] is want_valid
    return port


def run_checked_by_both(root, name, workload, opts, attr, factory,
                        want_valid, **kw) -> dict:
    """A whole run of a suite workload on root's package, held by both
    packages' checkers; returns the port's result."""
    test = run_workload(root, name, workload, opts, attr, factory, **kw)
    return held_by_both(test, workload_checker(name, workload, opts),
                        want_valid)


def failing_keys(res: dict):
    if "failures" in res:
        return sorted(res["failures"], key=str)
    return sorted(res.get("anomaly-types", []))


# ---------------------------------------------------------------------------
# builders, command lines, stored runs
# ---------------------------------------------------------------------------

def shape(test: dict) -> dict:
    """What a builder decides: the test's name, the classes of its DB,
    client and nemesis, and its checker stack's keys (and its workload
    checker's class)."""
    ck = test["checker"]
    cmap = getattr(ck, "checker_map", {})
    return {"name": test["name"], "db": type(test["db"]).__name__,
            "client": type(test["client"]).__name__,
            "nemesis": type(test["nemesis"]).__name__,
            "nodes": test["nodes"], "concurrency": test["concurrency"],
            "checker": sorted(cmap),
            "workload": {k: type(v).__name__ for k, v in cmap.items()}}


def help_options(root, name) -> list:
    """The option strings `main(["test", "--help"])` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        with pytest.raises(SystemExit):
            suite(root, name).main(["test", "--help"])
    return sorted(w.rstrip(",") for ln in out.getvalue().splitlines()
                  for w in ln.split() if w.startswith("--"))


def parsed(root, name, argv) -> dict:
    """The opts a suite's `test` subcommand hands its test function."""
    cli = mod(root, "cli")
    spec = {}
    real = cli.run_test_n_times

    def capture(test_fn, opts):
        spec.update(opts)
        return 0

    cli.run_test_n_times = capture
    try:
        with pytest.raises(SystemExit) as e:
            suite(root, name).main(["test"] + argv)
    finally:
        cli.run_test_n_times = real
    assert e.value.code == 0
    return spec


def suite_run_test(root, spec, base, device="cpu") -> dict:
    """chip_smoke's phase-27 or phase-28 test of spec on root's package.
    The port's is the phase's own; the JAX suite's is built by its own
    builder and put on the same in-memory database, its dummy remote
    answering with JAX Results, consul's and elasticsearch's clients on
    the JAX package's ConsulHttp and EsHttp."""
    if root == PORT:
        return cs.suite_test(spec, base, device=device)[0]
    s = suite(JAX, spec["suite"])
    opts = dict(spec["opts"], device=None)
    test = getattr(s, spec["builder"])(dict(opts))
    fake = cs.rig_suite(test, spec)
    test["remote"] = mod(JAX, "control.dummy").DummyRemote(
        responder_for(JAX, test["remote"].responder))
    if spec["suite"] == "consul":
        test["client"].http_factory = test["db"].http_factory = \
            fake.factory(s)
    if spec["suite"] == "elasticsearch":
        test["client"].http_factory = fake.factory(s)
    if spec["suite"] not in cs.OWN_GENERATOR:
        test["generator"] = jax_client_generator(s, spec, opts)
    test.update(store_base=str(base),
                spec={"workload": spec["workload"], "opts": opts})
    return test


def jax_client_generator(s, spec, opts):
    """chip_smoke.client_generator on the JAX package."""
    g = mod(JAX, "generator")
    final = None
    if spec["suite"] == "zookeeper":
        rng = random.Random(opts["seed"])
        mix = mod(JAX, "workloads.register").cas_op_mix
        ops = g.limit(opts.get("ops", cs.ZK_OPS), lambda: mix(rng))
    else:
        w = s.WORKLOADS[spec["workload"]](dict(opts))
        ops = w["generator"] if "generator" in w else w["mix"]
        final = w.get("final_generator", w.get("drain"))
        if "ops" in opts and (spec["suite"], spec["workload"]) not in \
                cs.DRAINED_WORKLOADS:
            ops = g.limit(opts["ops"], ops)
    main = g.time_limit(opts["time_limit"], g.clients(
        g.stagger(1.0 / opts["rate"], ops)))
    return main if final is None else g.phases(main, g.clients(final))


def stored_run(root, spec, base, device="cpu"):
    """chip_smoke's phase-27 or phase-28 run on root's suite, stored
    under base;
    returns (the run, its directory)."""
    out = mod(root, "core").run(suite_run_test(root, spec, base, device))
    return out, mod(root, "store").path(out)


def analyzed(root, spec, d) -> dict:
    """resume.analyze_run of stored run d by root's package with its
    suite's builder: the results untimed, d in paths read as <store>."""
    kw = {"device": "cpu"} if root == PORT else {}
    s = suite(root, spec["suite"])
    res = mod(root, "resume").analyze_run(
        d, test_fn=getattr(s, spec["builder"]), **kw)["results"]
    return in_store(norm({k: v for k, v in res.items()
                          if k not in cs.CLI_MEASURED + ("watchdog",)}), d)


def in_store(x, d):
    if isinstance(x, dict):
        return {k: in_store(v, d) for k, v in x.items()}
    if isinstance(x, list):
        return [in_store(v, d) for v in x]
    if isinstance(x, str):
        return x.replace(str(d), "<store>")
    return x


def stored_across(writer, spec, tmp_path) -> None:
    """A run stored by writer, analysed by both packages (each on its
    own copy) with equal results, the run's own verdict."""
    out, d = stored_run(writer, spec, tmp_path / writer)
    twin = d.parent / (d.name + "-twin")
    shutil.copytree(d, twin)
    mine = analyzed(writer, spec, d)
    other = analyzed(PORT if writer == JAX else JAX, spec, twin)
    assert other == mine
    key = cs.suite_checker_key(spec)
    assert mine[key]["valid?"] is (not spec["twin"])
    assert in_store(norm(out["results"][key]), d) == mine[key]


# ~40 cas a run: with fewer, every cas of a run can fail, and the stats
# checker then calls the run invalid (ROADMAP C12). etcd's runs last 5 s
# (its nemesis cycle's first sleep).
SMALL = {"time_limit": 1, "rate": 5000, "ops": 150, "ops_per_key": 60,
         "keys": 2, "concurrency": 4, "append_time_limit": 2,
         "append_rate": 5000, "big_txns": 200, "big_time_limit": 2}
# phase 28's suites at a small size: the same cuts but `keys`, which
# several A10b workloads read as a list of keys, not a count, and at 6
# threads, which yugabyte's multi-key ACID groups of 3 divide
SMALL_A10B = dict({k: v for k, v in SMALL.items() if k != "keys"},
                  concurrency=6)


def small_specs(suites_=None) -> dict:
    """Phases 27's and 28's runs at SMALL (SMALL_A10B for phase 28's
    suites), by name, for the suites named."""
    return {s["name"]: s
            for sizes in (SMALL, SMALL_A10B)
            for s in cs.suite_runs(dict(cs.SUITE_SIZES, **sizes))
            if (suites_ is None or s["suite"] in suites_)
            and (s["phase"] == 28) == (sizes is SMALL_A10B)}


def phase_27(suites_, monkeypatch, phase: int = 27) -> dict:
    """chip_smoke's phase 27 (or 28) on the CPU at SMALL (SMALL_A10B)
    over the suites named."""
    import torch

    orig = cs.suite_runs
    monkeypatch.setattr(cs, "suite_runs", lambda sizes: [
        s for s in orig(sizes) if s["suite"] in suites_])
    return cs.suites_path(torch.device("cpu"), False,
                          SMALL if phase == 27 else SMALL_A10B, phase)


def phase_28(suites_, monkeypatch) -> dict:
    """chip_smoke's phase 28 on the CPU at SMALL_A10B over the suites
    named."""
    return phase_27(suites_, monkeypatch, phase=28)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_suite_names_in_the_jax_order():
    assert list(mod(PORT, "suites").SUITES) == \
        list(mod(JAX, "suites").SUITES)
    assert sorted(PORTED) == sorted(mod(JAX, "suites").SUITES)
    # the refusal of A10b's names went with the last of them
    assert not hasattr(mod(PORT, "suites"), "UNPORTED")
    assert not hasattr(mod(PORT, "suites"), "UNPORTED_REFUSAL")


def test_module_paths_name_the_port():
    for name, path in mod(PORT, "suites").SUITES.items():
        assert path == mod(JAX, "suites").SUITES[name].replace(
            "jepsen_tpu.", "jepsen_tpu_torch.", 1)


@pytest.mark.parametrize("name", PORTED)
def test_ported_suite_loads_the_port_module(name):
    m = mod(PORT, "suites").load(name)
    assert m.__name__ == mod(PORT, "suites").SUITES[name]
    assert m is importlib.import_module(m.__name__)
    assert callable(m.main)


def test_unknown_suite_raises_keyerror_as_jax():
    msgs = []
    for root in ROOTS:
        with pytest.raises(KeyError) as e:
            mod(root, "suites").load("nosuch")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_common_classifier_equal():
    """common.make_classifier: reads and definite rejections fail, the
    rest is indeterminate, in both packages."""
    pats = [r"deadlock", r"duplicate entry"]
    cases = [("read", "timeout"), ("write", "Deadlock found"),
             ("write", "timed out"), ("cas", "Duplicate entry '1'")]
    got = {}
    for root in ROOTS:
        c = suite(root, "common").make_classifier(pats)
        got[root] = [outcome(c(op(root, f), remote_error(root, msg)))
                     for f, msg in cases]
    assert got[PORT] == got[JAX]
    assert [g[0] for g in got[PORT]] == ["fail", "fail", "info", "fail"]


def test_common_sqlcli_stream_equal():
    streams = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: "1" if "SELECT" in a.cmd
                         else None)
        c = suite(root, "common").SqlCli(test, "n2", ["mysql", "-e"])
        assert c.run("SELECT 1") == "1"
        c.close()
        streams[root] = stream(root, test)
    assert streams[PORT] == streams[JAX]


def test_no_suite_module_imports_jax():
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / PORT / "suites"
    files = sorted(root.glob("*.py"))
    assert len(files) == 23
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jepsen_tpu"), (f, n)


def test_suite_runs_of_phase_27_cover_every_ported_suite():
    specs = cs.suite_runs(dict(cs.SUITE_SIZES))
    assert {cs.SUITE_KEYS[s["suite"]] for s in specs} == set(PORTED)
    # phase 28 runs A10b's eight, phase 27 the other 13, in that order
    assert {cs.SUITE_KEYS[s["suite"]] for s in specs
            if s["phase"] == 28} == set(A10B)
    assert [s["phase"] for s in specs] == sorted(s["phase"] for s in specs)
    assert [s["name"] for s in specs if s["twin"]] == [
        "consul-register-twin", "postgres-append-twin",
        "cockroach-register-twin", "yugabyte-ysql-append-twin"]
    big = [s for s in specs if s["suite"] in ("postgres", "yugabyte")
           and s["workload"] in cs.APPEND_WORKLOADS]
    assert len(big) == 4
    assert all(s["opts"]["ops"] == s["txns"] == 10_000 for s in big)
    # every other run at its suite's ops and key count
    for s in specs:
        cut = set(cs.SUITE_CUTS) & set(s["opts"])
        assert cut == ({"ops"} if s in big else set()), s["name"]
    assert {s["suite"]: s["txns"] for s in specs if "txns" in s
            and s not in big} == {"stolon": 2000, "etcd": 1000,
                                  "tidb": 2000}
    # each suite's default workload once (etcd's append, dgraph's
    # linearizable-register and yugabyte's multi-key ACID besides)
    assert {(s["suite"], s["workload"]) for s in specs
            if not s["twin"]} == {
        (m, w) for m, (_b, wl) in cs.SUITE_BUILDERS.items()
        for w in (wl,) + cs.EXTRA_WORKLOADS.get(m, ())}
    assert {s["name"] for s in specs if cs.linearizable_run(s)
            and s["phase"] == 28} == {
        "hazelcast-lock", "cockroach-register", "cockroach-register-twin",
        "dgraph-linearizable-register", "yugabyte-ysql-multi-key-acid"}
    # 6 threads but dgraph's 8 (its key groups of 4, ROADMAP C13)
    assert {s["opts"]["concurrency"] for s in specs
            if s["suite"] != "dgraph"} == {6}
    assert {s["opts"]["concurrency"] for s in specs
            if s["suite"] == "dgraph"} == {8}



def drained(root, spec) -> list:
    """The ops of root's suite builder's own generator (client and
    nemesis streams, final phases) at 500 ops/s within 30 s (the nemesis
    cycles fire; galera's bank, bounded by time alone, stays ~15,000
    ops) simulated with no cluster: each op
    completes ok 10 ns after its invocation, a sleep after its seconds.
    The global random module is seeded first (the nemesis packages draw
    their targets from it)."""
    s = suite(root, spec["suite"])
    ts = mod(root, "generator.test_support")
    opts = device_opts(root, dict(spec["opts"], time_limit=30, rate=500))
    test = getattr(s, spec["builder"])(opts)
    random.seed(cs.SUITE_SEED)

    def complete(_ctx, inv):
        dt = int(inv.value * 1e9) if inv.type == "sleep" else 10
        return inv.copy(type="ok", time=inv.time + dt)

    ops = ts.simulate(test["generator"], complete,
                      ctx=ts.n_plus_nemesis_context(opts["concurrency"]),
                      test=test)
    return [(o.type, o.process, o.f, repr(o.value), o.time) for o in ops]


DRAINED = [s for s in cs.suite_runs(dict(cs.SUITE_SIZES)) if not s["twin"]]


@pytest.mark.parametrize("spec", DRAINED, ids=[s["name"] for s in DRAINED])
def test_builder_generator_drains_equal(spec):
    """Each phase-27 and phase-28 run's builder generator yields the
    same ops in both packages; an append run invokes the txns its phase
    expects (the suite's default, postgres' and yugabyte's 10,000)."""
    port = drained(PORT, spec)
    assert port == drained(JAX, spec)
    clients = [o for o in port if o[0] == "invoke" and o[1] != "nemesis"]
    assert clients
    assert any(o[1] == "nemesis" and o[2] for o in port)
    if "txns" in spec:
        assert len(clients) == spec["txns"]


@pytest.mark.parametrize("faults", [
    f for f in mod(PORT, "suites.etcd").FAULT_OPTIONS
    if f and "membership" not in f], ids=lambda f: "+".join(f))
def test_etcd_generator_under_faults_drains_equal(faults):
    """etcd's generator with each nemesis menu of test-all (the composed
    packages and their final generators) in both packages. Membership's
    generator waits on its state machine's view of a live cluster, which
    a simulation has not (tests/test_torch_membership.py drives it)."""
    spec = next(s for s in DRAINED if s["name"] == "etcd-register")
    spec = dict(spec, opts=dict(spec["opts"], faults=list(faults)))
    port = drained(PORT, spec)
    assert port == drained(JAX, spec)
    assert {o[2] for o in port if o[1] == "nemesis"} - {None}


@pytest.mark.parametrize("name", PORTED)
def test_suite_test_without_a_card_exits_before_any_run(name, tmp_path,
                                                        monkeypatch):
    """A suite's `test` asked for the card (the default) without one exits
    255 with device.resolve_device's message and starts no run: no
    fallback to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    m = mod(PORT, "suites").load(name)
    cli = mod(PORT, "cli")
    ran = []
    monkeypatch.setattr(cli, "run_test_n_times",
                        lambda *a, **kw: ran.append(a) or 0)
    with pytest.raises(SystemExit) as e:
        m.main(["test", "--no-ssh", "--nodes", "n1", "--time-limit", "1"])
    assert e.value.code == 255
    assert not ran and not (tmp_path / "store").exists()
