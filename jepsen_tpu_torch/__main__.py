"""Built-in runner: `python -m jepsen_tpu_torch <test|test-all|serve|
analyze|fleet|...> ...` (the port's copy of jepsen_tpu/__main__.py).

Drives the bundled workloads (workloads.REGISTRY) against the
in-memory databases in testing.py when --no-ssh is given — the
clusterless analog of each suite's core.clj -main (e.g.
tidb/src/tidb/core.clj:47-60) — or against real nodes over SSH. The
workloads' checkers run on the card; `--device cpu` runs the kernels'
plain PyTorch versions (cli.py). Every test composes the perf plots
(checker.perf), which draw with matplotlib: on a machine without it
their sub-result is valid? "unknown" and a valid run exits 2, as the
JAX package's does there.
"""

from __future__ import annotations

from . import checker as chk
from . import cli, nodeprobe, testing, workloads
from . import generator as gen
from . import nemesis as jnemesis

# the synthetic DB log every clusterless demo node "writes" — the node
# probe tails it and tags seeded election/OOM lines, so demo runs
# exercise the full node-plane path (nodeprobe.py)
DEMO_LOG = "/var/log/db.log"

# --nemesis packages for clusterless demo runs: the faults fire
# against the dummy control plane (commands logged, nothing disturbed,
# activations recorded), so every run honestly exercises its
# fault × workload × anomaly coverage cells — including the explicit
# "fault fired, anomaly checked, none found" negatives the atlas
# needs (coverage.py).
NEMESES = {
    "none": None,
    "partition": jnemesis.partition_random_halves,
    "partition-node": jnemesis.partition_random_node,
    "partition-ring": jnemesis.partition_majorities_ring,
    "hammer": lambda: jnemesis.hammer_time("demo-daemon"),
}


def _make_demo_responder():
    """A demo responder: answers the partitioner's discovery commands
    (getent node-IP resolution, ip-link device discovery — so faults
    fire against the dummy control plane instead of crashing the
    nemesis process) and the node probe's compound /proc + log-tail
    command with seeded synthetic node state. Each test built by
    make_test gets its OWN instance, so a second run in the same
    process re-seeds tick counters and the synthetic log instead of
    re-tailing the previous run's content at stale timestamps."""
    synth = nodeprobe.synthetic_responder()

    def respond(node, action):
        cmd = action.cmd
        if cmd.startswith("getent ahostsv4"):
            host = cmd.split()[-1]
            digits = "".join(ch for ch in str(host) if ch.isdigit())
            n = int(digits) % 250 + 1 if digits else \
                sum(str(host).encode()) % 250 + 1
            return f"10.0.0.{n}   STREAM {host}"
        if cmd == "ip -o link show":
            return ("1: lo: <LOOPBACK,UP> mtu 65536\n"
                    "2: eth0: <BROADCAST,MULTICAST,UP> mtu 1500")
        return synth(node, action)

    return respond


# module-level instance for direct importers (tests that just need
# the discovery answers); make_test builds a fresh one per test
_demo_responder = _make_demo_responder()

# workload name -> in-memory client factory (testing.py fixtures)
CLIENTS = {
    "register": lambda: testing.KVClient(testing.KVState()),
    "bank": lambda: testing.BankClient(
        testing.BankState(list(range(8)))),
    "set": lambda: testing.SetClient(),
    "set-full": lambda: testing.SetClient(),
    "queue": lambda: testing.QueueClient(),
    "counter": lambda: testing.CounterClient(),
    "dirty-read": lambda: testing.DirtyReadClient(),
    "unique-ids": lambda: testing.UniqueIdsClient(),
    "long-fork": lambda: testing.TxnClient(),
    "monotonic": lambda: testing.MonotonicClient(),
    "sequential": lambda: testing.SequentialClient(),
    "append": lambda: testing.TxnClient(),
    "wr": lambda: testing.TxnClient(),
    "kafka": lambda: testing.KafkaClient(),
    "causal": lambda: testing.CausalClient(),
    "causal-reverse": lambda: testing.PerKeySetClient(),
    "adya-g2": lambda: testing.G2Client(),
    "lock": lambda: testing.LockClient(fences=False),
    "owner-lock": lambda: testing.LockClient(fences=False),
    "fenced-lock": lambda: testing.LockClient(),
    "reentrant-lock": lambda: testing.LockClient(reentrant_limit=2),
    "semaphore": lambda: testing.LockClient(
        testing.LockState(permits=2), semaphore=True),
    "upsert": lambda: testing.UpsertClient(),
    "run-coverage": lambda: testing.SchedulerClient(),
    "pages": lambda: testing.PagesClient(),
    "multimonotonic": lambda: testing.MultiRegClient(),
    "lost-updates": lambda: testing.VersionedSetClient(),
    "version-divergence": lambda: testing.VersionRegClient(),
}


def _workload_opts(name: str, opts: dict) -> dict:
    """Per-workload option scoping: only the knobs each workload
    actually reads, so a CLI default can't silently reshape unrelated
    workloads (e.g. long-fork's read-group size or adya's key count)."""
    ops = opts.get("ops", 500)
    wopts = {"ops": ops}
    if opts.get("device") is not None:
        # the checkers' device: "cuda" (the card) or "cpu"
        wopts["device"] = opts["device"]
    if name == "register":
        # all threads share one key group; keys rotate sequentially
        wopts.update({"group-size": opts["concurrency"],
                      "ops_per_key": ops // 8 or 1})
    elif name == "causal-reverse":
        wopts.update({"per-key-limit": ops // 4 or 1})
    elif name == "dirty-read":
        wopts.update({"concurrency": opts["concurrency"]})
    elif name == "sequential":
        # reserve() would otherwise hand every thread to the writers,
        # leaving zero readers (valid? unknown)
        wopts.update({"writers": workloads.sequential.default_writers(
            opts["concurrency"])})
    elif name == "multimonotonic":
        # half the threads write (one key each), half read
        wopts.update({"writers": max(1, opts["concurrency"] // 2)})
    elif name == "run-coverage":
        wopts.update({"jobs": min(ops, 50)})
    elif name in ("upsert", "pages", "lost-updates",
                  "version-divergence"):
        # independent-key groups must divide the thread count; budget
        # ops per key so every key reaches its final-read phase inside
        # the time limit (an unread key is an honest 'unknown').
        # pages' atomic insert size is its own knob (elements_per_add),
        # NOT group_size — thread count must never resize the groups.
        wopts.update({"group_size": opts["concurrency"],
                      "ops_per_key": max(ops // 8, 1)})
    return wopts


# workloads whose concurrent generator uses fixed thread pairs
_PAIRED = {"adya-g2", "causal-reverse"}


def make_test(opts: dict) -> dict:
    name = opts.get("workload", "register")
    if name not in workloads.REGISTRY:
        raise SystemExit(f"unknown workload {name!r}; "
                         + cli.one_of(workloads.REGISTRY))
    w = workloads.REGISTRY[name](_workload_opts(name, opts))
    if name in _PAIRED and opts["concurrency"] % 2:
        # pair-based generators need an even thread count; park the
        # last thread instead of failing the divisibility assert
        usable = set(range(opts["concurrency"] - 1))
        w = dict(w)
        w["generator"] = gen.on_threads(usable, w["generator"])
    test = testing.noop_test()
    test.update(
        name=f"{name}-demo",
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        ssh=opts["ssh"],
        time_limit=opts.get("time_limit"),
        client=CLIENTS[name](),
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=_generator(opts, w))
    if opts.get("trace"):
        # per-op causal tracing (optrace.jsonl + anomaly provenance)
        test["trace?"] = True
    if opts.get("quarantine"):
        # per-node circuit breakers: a dead node degrades the run
        # instead of aborting it (control/health.py)
        test["quarantine?"] = True
    if opts.get("xla_trace"):
        # a torch.profiler trace of the analysis phase into the run's
        # store dir (<run>/xla-trace; core.analyze, util.profile_trace)
        test["xla-trace?"] = True
    if not opts.get("no_nodeprobe"):
        # the node observability plane is on by default: per-node
        # resource/clock/log sampling into nodes.jsonl, clusterless
        # demo nodes answering with seeded synthetic /proc data
        test["nodeprobe?"] = True
        if opts.get("nodeprobe_interval"):
            test["nodeprobe_interval_s"] = float(
                opts["nodeprobe_interval"])
        if (opts.get("ssh") or {}).get("dummy"):
            test["node_log_files"] = [DEMO_LOG]
    nem_name = opts.get("nemesis") or "none"
    if nem_name not in NEMESES:
        raise SystemExit(f"unknown nemesis {nem_name!r}; "
                         + cli.one_of(NEMESES))
    if nem_name != "none":
        test["nemesis"] = NEMESES[nem_name]()
    if (opts.get("ssh") or {}).get("dummy") and not test.get("remote"):
        # the demo responder answers BOTH the partitioner's discovery
        # commands and the node probe's compound /proc probe; a fresh
        # instance per test keeps synthetic node state run-scoped
        from .control.dummy import DummyRemote

        test["remote"] = DummyRemote(_make_demo_responder())
    for k, v in w.items():
        if k not in ("generator", "checker", "final_generator"):
            test[k] = v
    # crash-safety knobs (resume.py): the reconstructible spec
    # lets `analyze <run-dir>` rebuild this exact checker stack after a
    # control-process crash; persistent wgl segment checkpoints make
    # that re-analysis resume instead of re-search.
    test["spec"] = {"workload": name, "opts": _spec_opts(opts)}
    test.setdefault("checkpoint?", True)
    return test


def _spec_opts(opts: dict) -> dict:
    """The JSON-representable subset of the option map — everything
    make_test needs to rebuild the same test (store.save_spec writes
    it as spec.json)."""
    def plain(v):
        if isinstance(v, (str, int, float, bool, type(None))):
            return True
        if isinstance(v, (list, tuple)):
            return all(plain(x) for x in v)
        if isinstance(v, dict):
            return all(isinstance(k, str) and plain(x)
                       for k, x in v.items())
        return False

    return {k: v for k, v in opts.items() if plain(v)}


def _generator(opts: dict, w: dict):
    client_gen = gen.stagger(1.0 / opts.get("rate", 100),
                             w["generator"])
    nem_name = opts.get("nemesis") or "none"
    if nem_name != "none":
        # the canonical sleep/start/sleep/stop cycle on the nemesis
        # thread, bounded by the same time limit as the clients
        main = gen.time_limit(
            opts.get("time_limit", 60),
            gen.clients(client_gen,
                        jnemesis.start_stop_cycle(
                            opts.get("nemesis_interval", 5.0))))
    else:
        main = gen.clients(
            gen.time_limit(opts.get("time_limit", 60), client_gen))
    final = w.get("final_generator")
    if final is None:
        return main
    # a workload's final phase (e.g. monotonic's reads) runs after the
    # time limit, like the suites' heal-then-read shape
    return gen.phases(main, gen.clients(final))


def make_all_tests(opts: dict):
    names = (opts.get("workload") or "").split(",") if \
        opts.get("workload") else list(CLIENTS)
    for name in names:
        o = dict(opts)
        o["workload"] = name
        yield make_test(o)


def _workload_opt(p):
    p.add_argument("--workload", default="register",
                   help="Workload name. " + cli.one_of(CLIENTS))
    p.add_argument("--ops", type=int, default=500,
                   help="Rough op budget for the workload generator.")
    p.add_argument("--rate", type=float, default=100,
                   help="Target ops/sec across all workers.")
    p.add_argument("--trace", action="store_true",
                   help="Record the per-op causal trace "
                        "(optrace.jsonl; see tracing.py).")
    p.add_argument("--quarantine", action="store_true",
                   help="Quarantine persistently unreachable nodes "
                        "and continue the run :degraded instead of "
                        "aborting (control/health.py).")
    p.add_argument("--xla-trace", action="store_true",
                   help="Drop a torch.profiler trace of the analysis "
                        "phase into the run's store dir "
                        "(<run>/xla-trace, Chrome-trace JSON).")
    p.add_argument("--no-nodeprobe", action="store_true",
                   help="Disable the node observability plane "
                        "(per-node resource/clock/log sampling into "
                        "nodes.jsonl; see nodeprobe.py).")
    p.add_argument("--nodeprobe-interval", type=float, default=None,
                   metavar="SECS",
                   help="Node probe tick interval (default 1s).")
    p.add_argument("--nemesis", default="none",
                   help="Fault package to run against the workload "
                        "(coverage atlas column). " + cli.one_of(
                            NEMESES))
    p.add_argument("--nemesis-interval", type=float, default=5.0,
                   help="Seconds between nemesis start/stop phases.")
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(make_test,
                                        parser_fn=_workload_opt))
    commands.update(cli.test_all_cmd(make_all_tests,
                                     parser_fn=_workload_opt))
    commands.update(cli.serve_cmd())
    commands.update(cli.telemetry_cmd())
    commands.update(cli.profile_cmd())
    commands.update(cli.nodes_cmd())
    commands.update(cli.trace_cmd())
    commands.update(cli.certify_cmd())
    commands.update(cli.analyze_cmd(make_test))
    commands.update(cli.coverage_cmd(list(workloads.REGISTRY)))
    commands.update(cli.lint_cmd())
    commands.update(cli.fleet_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
