"""Command-line runner harness (the port's copy of jepsen_tpu/cli.py).

Capability reference: jepsen/src/jepsen/cli.clj — test-opt-spec
standard flags (64-206: --node/--nodes/--nodes-file/--username/
--password/--concurrency "2n" syntax/--test-count/--time-limit/
--no-ssh/--leave-db-running), test-opt-fn option normalization
(230-255), run! subcommand dispatcher with exit codes (258-335),
serve-cmd (336-354), single-test-cmd (355-442), test-all run/summary/
exit (443-530).

Exit codes mirror the reference: 0 pass, 1 invalid, 2 unknown,
254 usage error, 255 crash.

Every command line of the JAX package parses here under the same
options. The port adds one: `--device` (default `cuda`, the card; `cpu`
runs every kernel's plain PyTorch version) on `test`, `test-all`,
`analyze` and `fleet serve`. Each of them resolves the device before
anything of the run starts, so without a card and without
`--device cpu` the command exits 255 with device.resolve_device's
message and writes no run directory. `--compile-cache DIR` sets
JEPSEN_TPU_COMPILE_CACHE as in the JAX package; in the port it names the
kernel build cache (gpu/kernels/build.py: the CUDA libraries are built
into and loaded from DIR; "0" turns the cache off). `lint` runs the
port's static analysis (jepsen_tpu_torch.analysis) under the JAX
package's options and exit codes.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Callable

from . import util
from .device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]


def one_of(coll) -> str:
    names = sorted(coll.keys() if isinstance(coll, dict) else coll)
    return "Must be one of " + ", ".join(str(n) for n in names)


def _concurrency(s: str) -> str:
    import re

    if not re.fullmatch(r"\d+n?", s):
        raise argparse.ArgumentTypeError(
            "Must be an integer, optionally followed by n.")
    return s


def add_test_opts(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The standard test flags (cli.clj test-opt-spec, 64-206)."""
    p.add_argument("-n", "--node", action="append", dest="node",
                   metavar="HOSTNAME", default=None,
                   help="Node to run the test on; repeatable.")
    p.add_argument("--nodes", metavar="NODE_LIST",
                   help="Comma-separated list of node hostnames.")
    p.add_argument("--nodes-file", metavar="FILENAME",
                   help="File of node hostnames, one per line.")
    p.add_argument("--username", default="root",
                   help="Username for logins")
    p.add_argument("--password", default="root",
                   help="Password for sudo access")
    p.add_argument("--strict-host-key-checking", action="store_true",
                   help="Whether to check host keys")
    p.add_argument("--no-ssh", action="store_true",
                   help="Don't establish SSH connections (dummy remote).")
    p.add_argument("--ssh-private-key", metavar="FILE",
                   help="Path to an SSH identity file")
    p.add_argument("--concurrency", default="1n", type=_concurrency,
                   help="Worker count; an integer, optionally followed "
                        "by n to multiply by the node count (e.g. 3n).")
    p.add_argument("--leave-db-running", action="store_true",
                   help="Leave the database running after the test.")
    p.add_argument("--test-count", type=int, default=1,
                   help="How many times to repeat the test.")
    p.add_argument("--time-limit", type=int, default=60,
                   help="Test duration excluding setup/teardown, secs.")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="Kernel build cache directory (or 0 to "
                        "disable). Defaults to jepsen_tpu_torch/gpu/"
                        "kernels/build; also settable via "
                        "JEPSEN_TPU_COMPILE_CACHE.")
    return _device_opt(p)


def _device_opt(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where the checkers run: cuda (the card, the "
                        "default) or cpu (the kernels' plain PyTorch "
                        "versions).")
    return p


def test_opt_fn(options: argparse.Namespace) -> dict:
    """Normalizes parsed options into a test-options dict
    (cli.clj test-opt-fn: parse-nodes, parse-concurrency,
    rename-ssh-options)."""
    o = vars(options).copy()
    if o.get("nodes_file"):
        with open(o["nodes_file"]) as f:
            nodes = [ln.strip() for ln in f if ln.strip()]
    elif o.get("nodes"):
        nodes = [n.strip() for n in o["nodes"].split(",") if n.strip()]
    elif o.get("node"):
        nodes = list(o["node"])
    else:
        nodes = list(DEFAULT_NODES)
    o["nodes"] = nodes
    o["concurrency"] = util.coll_scaled(o.get("concurrency", "1n"),
                                        len(nodes))
    o["ssh"] = {
        "username": o.pop("username", "root"),
        "password": o.pop("password", "root"),
        "strict_host_key_checking": o.pop("strict_host_key_checking",
                                          False),
        "private_key_path": o.pop("ssh_private_key", None),
        "dummy": o.pop("no_ssh", False),
    }
    o["leave_db_running?"] = o.pop("leave_db_running", False)
    cache = o.pop("compile_cache", None)
    if cache is not None:
        # gpu/kernels/build.py reads the variable at each load, so
        # setting it here covers every kernel this process builds
        os.environ["JEPSEN_TPU_COMPILE_CACHE"] = cache
    o.pop("node", None)
    o.pop("nodes_file", None)
    return o


def run_test_n_times(test_fn: Callable[[dict], dict],
                     opts: dict) -> int:
    """single-test-cmd's run loop (cli.clj:389-399): runs test-count
    tests, returning the worst exit code."""
    from . import core

    worst = 0
    for _ in range(opts.get("test_count", 1)):
        test = core.run(test_fn(opts))
        valid = (test.get("results") or {}).get("valid?")
        if valid is False:
            return 1
        if valid == "unknown":
            worst = max(worst, 2)
    return worst


def test_all_run_tests(tests) -> dict:
    """Runs tests, grouping store paths by outcome
    (cli.clj:443-461). Outcomes: True, False, 'unknown', 'crashed'."""
    from . import core
    from . import store as jstore

    out: dict = {}
    for t in tests:
        t = core.prepare_test(t)
        where = str(jstore.test_dir(t))
        try:
            t = core.run(t)
            key = (t.get("results") or {}).get("valid?")
        except Exception:  # noqa: BLE001
            logger.exception("Test crashed")
            key = "crashed"
        out.setdefault(key, []).append(where)
    return out


def test_all_print_summary(results: dict) -> dict:
    """Prints grouped outcomes (cli.clj:463-492)."""
    sections = [(True, "Successful tests"),
                ("unknown", "Indeterminate tests"),
                ("crashed", "Crashed tests"),
                (False, "Failed tests")]
    for key, title in sections:
        if results.get(key):
            print(f"\n# {title}\n")
            for p in results[key]:
                print(p)
    print()
    print(len(results.get(True, [])), "successes")
    print(len(results.get("unknown", [])), "unknown")
    print(len(results.get("crashed", [])), "crashed")
    print(len(results.get(False, [])), "failures")
    return results


def test_all_exit_code(results: dict) -> int:
    """255 if crashed, 2 if unknown, 1 if invalid, 0 otherwise
    (cli.clj:494-502)."""
    if results.get("crashed"):
        return 255
    if results.get("unknown"):
        return 2
    if results.get(False):
        return 1
    return 0


def serve(host: str = "0.0.0.0", port: int = 8080, block: bool = True):
    """Runs the store web UI (cli.clj serve-cmd, web.clj)."""
    from . import web

    server = web.serve(host, port)
    logger.info("Listening on http://%s:%s/", host, port)
    if block:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            server.shutdown()
    return server


class CliError(SystemExit):
    pass


def run_cli(subcommands: dict, argv=None) -> None:
    """Dispatches `argv` to {name: {parser_fn?, run}} subcommands
    (cli.clj run!, 258-335). run receives the parsed Namespace."""
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    command = argv[0] if argv else None
    if command not in subcommands:
        print("Usage: python -m jepsen_tpu_torch COMMAND [OPTIONS ...]")
        print("Commands:", ", ".join(sorted(subcommands)))
        raise SystemExit(254)
    spec = subcommands[command]
    parser = argparse.ArgumentParser(prog=command)
    if spec.get("parser_fn"):
        spec["parser_fn"](parser)
    try:
        options = parser.parse_args(argv[1:])
    except SystemExit as e:
        raise SystemExit(254 if e.code not in (0, None) else 0)
    try:
        code = spec["run"](options)
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001
        logger.exception("Oh jeez, I'm sorry, Jepsen broke. Here's why:")
        raise SystemExit(255)
    raise SystemExit(code or 0)


def single_test_cmd(test_fn, parser_fn=None, opt_fn=None) -> dict:
    """A 'test' subcommand for a suite (cli.clj:355-442). test_fn:
    options-dict -> test map."""
    def run(options):
        opts = test_opt_fn(options)
        resolve_device(opts.get("device"))
        if opt_fn:
            opts = opt_fn(opts)
        return run_test_n_times(test_fn, opts)

    def build(p):
        add_test_opts(p)
        if parser_fn:
            parser_fn(p)
        return p

    return {"test": {"parser_fn": build, "run": run}}


def test_all_cmd(tests_fn, parser_fn=None, opt_fn=None) -> dict:
    """A 'test-all' subcommand sweeping a test matrix
    (cli.clj:504-530). tests_fn: options-dict -> iterable of tests."""
    def run(options):
        opts = test_opt_fn(options)
        resolve_device(opts.get("device"))
        if opt_fn:
            opts = opt_fn(opts)
        results = test_all_run_tests(tests_fn(opts))
        test_all_print_summary(results)
        return test_all_exit_code(results)

    def build(p):
        add_test_opts(p)
        if parser_fn:
            parser_fn(p)
        return p

    return {"test-all": {"parser_fn": build, "run": run}}


def telemetry_cmd() -> dict:
    """A 'telemetry' subcommand: prints the span-tree + metrics
    summary for a stored run (its telemetry.jsonl / metrics.json
    artifacts; see telemetry.py). --min-ms / --top prune the
    span tree (ancestors of kept spans survive) so per-launch kernel
    records don't drown the phase view."""
    def build(p):
        _store_run_opts(p)
        p.add_argument("--min-ms", type=float, default=None,
                       metavar="MS",
                       help="Hide spans shorter than this many "
                            "milliseconds.")
        p.add_argument("--top", type=int, default=None, metavar="N",
                       help="Show only the N longest spans (plus "
                            "their ancestors).")
        return p

    def run(options):
        from . import store as jstore
        from .reports import telemetry as rtel

        d = _resolve_stored_run(options)
        if d is None:
            print(f"no such stored test: {options.test}")
            return 254
        events, metrics = jstore.load_telemetry(d)
        if not events and metrics is None:
            print(f"no telemetry recorded under {d} "
                  "(run predates the telemetry layer?)")
            return 1
        print(f"# {d.resolve()}\n")
        print(rtel.telemetry_text(events, metrics,
                                  min_ms=options.min_ms,
                                  top=options.top))
        return 0

    return {"telemetry": {"parser_fn": build, "run": run}}


def profile_cmd() -> dict:
    """A 'profile' subcommand: the per-kernel device-performance table
    for a stored run — launches, compile-cache hit rate, FLOPs, bytes
    accessed, peak device memory, and the wall/device phase split —
    from the run's metrics.json + telemetry.jsonl launch records
    (gpu/profiler.py)."""
    def build(p):
        return _store_run_opts(p)

    def run(options):
        from . import store as jstore
        from .reports import profile as rprofile

        d = _resolve_stored_run(options)
        if d is None:
            print(f"no such stored test: {options.test}")
            return 254
        events, metrics = jstore.load_telemetry(d)
        if not events and metrics is None:
            print(f"no telemetry recorded under {d} "
                  "(run predates the profiler?)")
            return 1
        print(f"# {d.resolve()}\n")
        print(rprofile.profile_text(events, metrics))
        return 0

    return {"profile": {"parser_fn": build, "run": run}}


def _resolve_stored_run(options):
    """Shared run-dir resolution for artifact subcommands (telemetry,
    trace): a literal directory, a test name under the store base, or
    'latest'."""
    from pathlib import Path

    from . import store as jstore

    base = Path(options.store) if options.store else jstore.BASE
    d = Path(options.test)
    if not d.is_dir():
        d = base / options.test / options.timestamp
    if options.test == "latest" and not d.is_dir():
        d = base / "latest"
    return d if d.is_dir() else None


def _store_run_opts(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("test", nargs="?", default="latest",
                   help="A store directory, or a test name "
                        "(resolved under the store base).")
    p.add_argument("--timestamp", default="latest",
                   help="Which run of the named test.")
    p.add_argument("--store", default=None,
                   help="Store base directory (default ./store).")
    return p


def nodes_cmd() -> dict:
    """A 'nodes' subcommand: the node observability plane's per-node
    summary for a stored run — sample/gap counts, resource extremes,
    tagged DB-log events, breaker badges, and the merged clock-skew
    bound (nodes.jsonl, nodeprobe.py)."""
    def build(p):
        return _store_run_opts(p)

    def run(options):
        from . import nodeprobe as jnodeprobe
        from . import store as jstore
        from .reports import nodes as rnodes

        d = _resolve_stored_run(options)
        if d is None:
            print(f"no such stored test: {options.test}")
            return 254
        records = jstore.load_nodes(d)
        if not records:
            print(f"no node-plane records under {d} "
                  "(run predates — or disabled — the node probe)")
            return 1
        jnodeprobe.validate_records(records)
        test = None
        try:
            test = jstore.load(d)
        except (OSError, ValueError):
            pass
        print(f"# {d.resolve()}\n")
        print(rnodes.nodes_text(records,
                                (test or {}).get("history")))
        return 0

    return {"nodes": {"parser_fn": build, "run": run}}


def certify_cmd() -> dict:
    """A 'certify' subcommand: independently re-validates a stored
    run's verdict certificates against its recovered history (valid →
    replayable linearization / serialization order; invalid →
    confirmed witness or justified cycle; gpu/certify.py). --print
    pretty-prints each certificate.
    Exit: 0 = every present certificate validates, 1 = at least one
    proof failed, 2 = the run carries no certificates."""
    def build(p):
        _store_run_opts(p)
        p.add_argument("--print", action="store_true", dest="print_",
                       help="Pretty-print each certificate instead "
                            "of just validating it.")
        return p

    def run(options):
        import json as _json

        from . import store as jstore
        from .store import format as fmt
        from .gpu import certify as jcertify

        d = _resolve_stored_run(options)
        if d is None:
            print(f"no such stored test: {options.test}")
            return 254
        try:
            results = jstore.load_results(d)
        except (OSError, ValueError):
            results = None
        if not isinstance(results, dict):
            print(f"no results.json under {d} (crashed run? try "
                  "`analyze --resume` first)")
            return 2
        hist = fmt.read_history(d / "history.jlog")
        digest = jcertify.history_digest(hist)
        print(f"# {d.resolve()}\n")
        rows = []
        errors = 0
        for path, res in jcertify.iter_certificates(results):
            cert = res["certificate"]
            if isinstance(cert.get("absent"), str) \
                    and cert["absent"]:
                status = f"absent ({cert['absent']})"
            else:
                # a malformed/unknown-version certificate is itself a
                # diagnosis, not a crash: validate() schema-checks
                # first, so it lands in the error column and exit 1
                try:
                    jcertify.validate(hist, cert, digest=digest)
                    status = "certified"
                except jcertify.CertificateError as e:
                    status = f"ERROR: {e}"
                    errors += 1
            kind = cert.get("kind", "-")
            verdict = cert.get("verdict", "-")
            rows.append((path, kind, verdict, status))
            if options.print_:
                print(f"## {path}")
                print(_json.dumps(cert, indent=1, default=repr))
                print()
        if not rows:
            print("(no certificates — the run predates verdict "
                  "certification, or every checker skipped it)")
            return 2
        w = max(len(p) for p, *_r in rows)
        for path, kind, verdict, status in rows:
            print(f"{path.ljust(w)}  {kind:<5} {verdict:<8} {status}")
        print(f"\n{len(rows)} certificate(s), {errors} error(s)")
        return 1 if errors else 0

    return {"certify": {"parser_fn": build, "run": run}}


def trace_cmd() -> dict:
    """A 'trace' subcommand: exports a stored run as Chrome-trace JSON
    (trace.json) openable in ui.perfetto.dev — telemetry spans, op
    lifetimes (one track per process), and nemesis windows on one
    timeline (reports/trace.py)."""
    def build(p):
        _store_run_opts(p)
        p.add_argument("-o", "--out", default=None,
                       help="Output path (default: <run>/trace.json).")
        p.add_argument("--ops", default=None,
                       help="Comma-separated op indices: restrict the "
                            "client tracks to these ops (anomaly "
                            "provenance drill-down).")
        return p

    def run(options):
        from .reports import trace as rtrace

        d = _resolve_stored_run(options)
        if d is None:
            print(f"no such stored test: {options.test}")
            return 254
        ops = ([int(x) for x in options.ops.split(",") if x.strip()]
               if options.ops else None)
        out = rtrace.write_trace(d, options.out, ops=ops)
        print(f"wrote {out}")
        print("open it at https://ui.perfetto.dev "
              "(or chrome://tracing)")
        return 0

    return {"trace": {"parser_fn": build, "run": run}}


def analyze_cmd(test_fn=None) -> dict:
    """An 'analyze' subcommand: recovers a stored run's history (valid
    CRC prefix; torn tail dropped) and (re)runs its checkers, writing
    results.json — the recovery path after a control-process crash.
    --resume reuses completed checkers from the partial-results log and
    the wgl segment checkpoints (resume.py). test_fn rebuilds
    the checker stack from the run's spec.json (suites pass their own
    test function; the default is __main__.make_test)."""
    def build(p):
        _store_run_opts(p)
        p.add_argument("--resume", action="store_true",
                       help="Reuse completed checker results and wgl "
                            "segment checkpoints from the crashed "
                            "analysis instead of starting over.")
        p.add_argument("--checker-timeout", type=float, default=None,
                       metavar="SECS",
                       help="Per-checker wall-clock bound; a hung "
                            "checker degrades to valid? unknown.")
        return _device_opt(p)

    def run(options):
        from . import resume as jresume

        resolve_device(options.device)
        d = _resolve_stored_run(options)
        if d is None:
            print(f"no such stored test: {options.test}")
            return 254
        test = jresume.analyze_run(
            d, resume=options.resume, test_fn=test_fn,
            checker_timeout_s=options.checker_timeout,
            device=options.device)
        valid = (test.get("results") or {}).get("valid?")
        print(f"results written to {d / 'results.json'}")
        if valid is True:
            return 0
        if valid is False:
            return 1
        return 2

    return {"analyze": {"parser_fn": build, "run": run}}


def coverage_cmd(all_workloads=None) -> dict:
    """A 'coverage' subcommand: the cross-run fault × workload ×
    anomaly matrix, witnessed-cell detail, gap report, and (--suggest)
    ranked gap-filling configs — the campaign runner's input hook
    (coverage.py). Scans the store for
    per-run coverage.json records, folds any missing ones into
    store/coverage_atlas.jsonl, then aggregates."""
    def build(p):
        p.add_argument("--store", default=None,
                       help="Store base directory (default ./store).")
        p.add_argument("--suggest", type=int, nargs="?", const=5,
                       default=0, metavar="N",
                       help="Also print the top N gap-filling "
                            "(workload, nemesis) configs (default 5).")
        p.add_argument("--no-sync", action="store_true",
                       help="Skip folding stored coverage.json "
                            "records into the atlas first.")
        return p

    def run(options):
        from pathlib import Path

        from . import coverage as jcoverage
        from . import store as jstore

        base = Path(options.store) if options.store else jstore.BASE
        if not options.no_sync:
            n = jcoverage.sync_store(base)
            if n:
                print(f"(folded {n} run record(s) into the atlas)")
        entries = jcoverage.read_atlas(base / jcoverage.ATLAS_FILE)
        jcoverage.validate_atlas(entries)
        cells = jcoverage.aggregate(entries)
        wls = all_workloads
        if wls is None:
            from . import workloads

            wls = list(workloads.REGISTRY)
        print(jcoverage.coverage_text(cells, wls,
                                      n_suggest=options.suggest))
        return 0

    return {"coverage": {"parser_fn": build, "run": run}}


def lint_cmd() -> dict:
    """A 'lint' subcommand: graftlint — static analysis of the hand
    kernels' launches (host syncs in launch loops, dtype widening,
    copies before a launch, sharding readiness, values compiled into a
    kernel that Python also holds, carry bloat) plus the threaded
    modules' lock-discipline lint, gated by the committed baseline
    ratchet (jepsen_tpu_torch.analysis; doc/static-analysis-torch.md).
    The default mode reads the launch plans on meta tensors: CPU-safe,
    no execution — tier-1 runs `lint --baseline
    lint-baseline-torch.json`. Exit: 0 clean or fully baselined, 1 NEW
    findings, 2 a launch failed to trace (or, with --full, its sizes
    are not the library's), 254 a refused --update."""
    def build(p):
        # the driver owns the full flag set; mirror it here so
        # `lint --help` works through the standard dispatcher
        p.add_argument("--baseline", default=None, metavar="FILE")
        p.add_argument("--update", action="store_true")
        p.add_argument("--json", action="store_true", dest="json_")
        p.add_argument("--runtime-buckets", action="store_true")
        p.add_argument("--full", action="store_true")
        p.add_argument("--rules", default=None, metavar="R1,R2,...")
        return p

    def run(options):
        from .analysis import driver

        argv = []
        if options.baseline:
            argv += ["--baseline", options.baseline]
        if options.update:
            argv.append("--update")
        if options.json_:
            argv.append("--json")
        if options.runtime_buckets:
            argv.append("--runtime-buckets")
        if options.full:
            argv.append("--full")
        if options.rules:
            argv += ["--rules", options.rules]
        return driver.main(argv)

    return {"lint": {"parser_fn": build, "run": run}}


def _fleet_top_lines(stats: dict) -> list[str]:
    """Renders `fleet top`'s frame from a stats() reply: the flight
    recorder's SLO quantiles, per-tenant latency tracks, per-class
    occupancy, and the scheduler decision log. Pure text-from-dict so
    tests exercise it without a terminal."""
    fr = stats.get("flightrec") or {}
    lines = []
    sched = stats.get("scheduler") or {}
    lines.append(
        f"streams {stats.get('streams', 0)}  "
        f"chunks {stats.get('chunks', 0)}  "
        f"verdicts {stats.get('verdicts', 0)}  "
        f"launches {sched.get('launches', 0)}")
    if not fr.get("enabled"):
        lines.append("flight recorder disabled")
        return lines

    def q(d, key):
        v = (d or {}).get(key)
        return "     -" if v is None else f"{v:10.2f}"

    v, a = fr.get("verdict_ms") or {}, fr.get("ack_ms") or {}
    lines.append(f"verdict ms  p50 {q(v, 'p50')}  p95 {q(v, 'p95')}"
                 f"  p99 {q(v, 'p99')}   (n={v.get('n', 0)})")
    lines.append(f"ack ms      p50 {q(a, 'p50')}  p95 {q(a, 'p95')}"
                 f"  p99 {q(a, 'p99')}   (n={a.get('n', 0)})")
    tenants = fr.get("tenants") or {}
    if tenants:
        lines.append(f"{'tenant':<16} {'verdict p50':>12} "
                     f"{'verdict p99':>12} {'ack p99':>10} "
                     f"{'items':>7}")
        fair = fr.get("fairness") or {}
        for t in sorted(tenants):
            td = tenants[t]
            lines.append(
                f"{t:<16} {q(td.get('verdict_ms'), 'p50'):>12} "
                f"{q(td.get('verdict_ms'), 'p99'):>12} "
                f"{q(td.get('ack_ms'), 'p99'):>10} "
                f"{(fair.get(t) or {}).get('items', 0):>7}")
    for cls, c in sorted((fr.get("classes") or {}).items()):
        lines.append(
            f"{cls:<7} launches {c.get('launches', 0):>5}  "
            f"rows/launch {c.get('rows_per_launch', 0.0):>8.2f}  "
            f"occupancy {c.get('occupancy', 0.0):>6.1%}")
    dec = fr.get("decisions") or {}
    lines.append("decisions  " + "  ".join(
        f"{r}={dec.get(r, 0)}" for r in
        ("full", "timeout", "drain", "breaker", "quarantine")))
    idle = fr.get("idle") or {}
    lines.append(f"device idle  {idle.get('gaps', 0)} gaps, "
                 f"{idle.get('total_ms', 0.0):.1f} ms total")
    return lines


def fleet_cmd() -> dict:
    """A 'fleet' subcommand: the checking-as-a-service data plane
    (fleet/).

      fleet serve            run the always-on multi-tenant server
      fleet submit <run>     stream a stored run's history.jlog to the
                             fleet and print its verdict
      fleet status           the server's per-tenant stats
      fleet top              live SLO/utilization view (flight rec.)
      fleet explain <run>    a verdict's latency decomposition
      fleet trace            write the Perfetto fleet-session view
      fleet ckpt <path>      inspect a checkpoint record (or a
                             <tenant>/<run> under <base>/ckpt)
    """
    def build(p):
        p.add_argument("action", choices=["serve", "submit",
                                          "status", "top", "explain",
                                          "trace", "ckpt"])
        p.add_argument("run_dir", nargs="?", default=None,
                       help="submit: a stored run dir (or a "
                            "history.jlog) to stream. explain: the "
                            "run name whose verdict to decompose. "
                            "ckpt: a .ckpt path or tenant/run.")
        p.add_argument("--base", default="store/fleet",
                       help="Fleet state dir (WALs, verdicts, "
                            "fleet.addr).")
        p.add_argument("--addr", default=None,
                       help="host:port (default: read "
                            "<base>/fleet.addr).")
        p.add_argument("-b", "--host", default="127.0.0.1")
        p.add_argument("-p", "--port", type=int, default=0)
        p.add_argument("--tenant", default="cli")
        p.add_argument("--model", default="cas-register",
                       help="Model spec for submit (see "
                            "fleet.known_models()).")
        p.add_argument("--initial", default=None,
                       help="Initial value for register-family "
                            "models (JSON scalar; e.g. 0 for a DB "
                            "that seeds the register).")
        p.add_argument("--weight", type=float, default=1.0,
                       help="Weighted-fair-queue share for submit.")
        p.add_argument("--chunk-ops", type=int, default=256)
        p.add_argument("--max-tenants", type=int, default=8)
        p.add_argument("--max-streams", type=int, default=16)
        p.add_argument("--interval", type=float, default=2.0,
                       help="top: seconds between refreshes.")
        p.add_argument("--iterations", type=int, default=0,
                       help="top: stop after N frames (0 = forever).")
        p.add_argument("--out", default=None,
                       help="trace: output path (default "
                            "<base>/fleet-trace.json).")
        return _device_opt(p)

    def _addr(options):
        if options.addr:
            return options.addr
        from pathlib import Path
        try:
            line = (Path(options.base)
                    / "fleet.addr").read_text().splitlines()[0]
            return line.strip()
        except (OSError, IndexError):
            raise CliError(
                f"no fleet.addr under {options.base!r} — pass --addr "
                "or start one with `fleet serve`")

    def run(options):
        import json as _json

        from .fleet import client as fclient
        from .fleet import server as fserver

        if options.action == "serve":
            resolve_device(options.device)
            quotas = fserver.Quotas(
                max_tenants=options.max_tenants,
                max_total_streams=options.max_streams)
            srv = fserver.FleetServer(options.base, host=options.host,
                                      port=options.port,
                                      quotas=quotas,
                                      device=options.device).start()
            host, port = srv.addr
            print(f"fleet server on {host}:{port} "
                  f"(base {options.base})")
            try:
                import time as _time
                while True:
                    _time.sleep(3600)
            except KeyboardInterrupt:
                srv.stop()
            return 0
        if options.action == "status":
            c = fclient.FleetClient(_addr(options), options.tenant,
                                    "status", observe=True)
            print(_json.dumps(c.status(), indent=2, sort_keys=True))
            c.close()
            return 0
        if options.action == "top":
            import time as _time
            i = 0
            while True:
                c = fclient.FleetClient(_addr(options),
                                        options.tenant, "status",
                                        observe=True)
                try:
                    stats = c.status()
                finally:
                    c.close()
                print("\n".join(_fleet_top_lines(stats)))
                i += 1
                if options.iterations and i >= options.iterations:
                    return 0
                print()
                _time.sleep(options.interval)
        if options.action == "explain":
            if not options.run_dir:
                raise CliError("fleet explain needs a run name")
            from .fleet import flightrec as frec

            c = fclient.FleetClient(_addr(options), options.tenant,
                                    options.run_dir)
            try:
                env = c.claim()
            finally:
                c.close()
            lat = env.get("latency") if isinstance(env, dict) \
                else None
            if not isinstance(lat, dict):
                print("no latency block (flight recorder disabled?)")
                return 2
            frec.validate_latency(lat)
            for k in frec.LATENCY_KEYS:
                print(f"  {k:>15}  {lat.get(k, 0.0):9.3f} ms")
            print(f"  {'total':>15}  "
                  f"{lat.get('total_ms', 0.0):9.3f} ms")
            if lat.get("replay"):
                print("  (replayed after restart: ingest/WAL slices "
                      "predate the crash and read zero)")
            k, v = frec.dominant_slice(lat)
            print(f"dominant slice: {k} ({v:.3f} ms)")
            return 0
        if options.action == "ckpt":
            if not options.run_dir:
                raise CliError(
                    "fleet ckpt needs a .ckpt path or tenant/run")
            from pathlib import Path

            from .gpu import ckpt as tckpt

            p = Path(options.run_dir)
            if p.suffix != ".ckpt" and not p.exists():
                # tenant/run shorthand under the fleet base
                parts = options.run_dir.split("/")
                if len(parts) == 2:
                    p = tckpt.fleet_path(options.base, *parts)
            if not p.exists():
                raise CliError(f"no checkpoint at {p}")
            rec = tckpt.read(p)
            if rec is None:
                # honest about why the reader refused it — a torn or
                # schema-invalid record is discarded, never trusted
                print(f"{p}: torn or invalid checkpoint "
                      "(discarded on read — a resume from this file "
                      "falls back to a full re-check)")
                return 2
            kind = rec["kind"]
            print(f"{p}")
            print(f"  kind    {kind}")
            print(f"  n_ops   {rec['n_ops']}")
            print(f"  digest  {rec['digest'][:16]}…")
            if kind == "stream-wgl":
                print(f"  model   {rec['model']}")
                print(f"  checked {rec['checked']}  "
                      f"mask {rec['mask']:#x}")
            elif kind == "wgl-extend":
                print(f"  stride  {rec['stride']}  "
                      f"cuts {len(rec['cuts'])}  "
                      f"states {len(rec['states'])}  "
                      f"masks {len(rec['masks'])}")
            elif kind == "elle":
                print(f"  family  {rec['family']}")
                fro = rec.get("frontier") or {}
                print(f"  closed  {rec['n_closed']} txns  "
                      f"keys {len(rec.get('versions') or {})}  "
                      f"edges {len(fro.get('edges') or [])}  "
                      f"state {fro.get('state')!r}")
            return 0
        if options.action == "trace":
            from pathlib import Path

            from .fleet import flightrec as frec
            from .reports import trace as rtrace

            snap = Path(options.base) / frec.SNAPSHOT_FILE
            try:
                d = _json.loads(snap.read_text())
            except (OSError, ValueError):
                raise CliError(
                    f"no flight-recorder snapshot at {snap}")
            doc = rtrace.fleet_chrome_trace(d.get("records") or [])
            out = Path(options.out) if options.out \
                else Path(options.base) / "fleet-trace.json"
            with open(out, "w") as f:
                _json.dump(doc, f)
            print(f"wrote {out} ({len(doc['traceEvents'])} events)")
            return 0
        # submit: stream a stored history
        if not options.run_dir:
            raise CliError("fleet submit needs a run dir or .jlog")
        from pathlib import Path

        from .store import format as sformat

        p = Path(options.run_dir)
        log = p if p.suffix == ".jlog" else p / "history.jlog"
        if not log.exists():
            raise CliError(f"no history log at {log}")
        run_name = (p.parent.name if p.suffix == ".jlog" else p.name
                    ).replace(" ", "-") or "run"
        initial = options.initial
        if initial is not None:
            try:
                initial = _json.loads(initial)
            except ValueError:
                pass  # a bare string initial is legal
        c = fclient.FleetClient(_addr(options), options.tenant,
                                run_name, model=options.model,
                                initial=initial,
                                weight=options.weight)
        ops: list = []
        n = 0
        for o in sformat.read_ops(log):
            ops.append(o)
            if len(ops) >= options.chunk_ops:
                c.send_chunk(ops)
                n += len(ops)
                ops = []
        if ops:
            c.send_chunk(ops)
            n += len(ops)
        verdict = c.finish()
        c.close()
        print(_json.dumps(verdict, indent=2, sort_keys=True))
        res = (verdict.get("result") or {}).get("valid?")
        return 0 if res is True else 1 if res is False else 2

    return {"fleet": {"parser_fn": build, "run": run}}


def serve_cmd() -> dict:
    """A 'serve' subcommand for the web UI (cli.clj:336-354)."""
    def build(p):
        p.add_argument("-b", "--host", default="0.0.0.0",
                       help="Hostname to bind to")
        p.add_argument("-p", "--port", type=int, default=8080,
                       help="Port number to bind to")
        return p

    def run(options):
        serve(options.host, options.port)
        return 0

    return {"serve": {"parser_fn": build, "run": run}}
