"""graftlint driver: registry x rules + concurrency lint + ratchet (the
port's copy of jepsen_tpu/analysis/driver.py).

`run_lint()` is the one entry point every surface shares — the
`python -m jepsen_tpu_torch lint` CLI, the web /lint page and the
tier-1 baseline gate. It traces every registry entry at its shape
buckets off the kernel wrappers' launch plans (meta tensors: no
execution, no card, CPU-safe), runs the launch rules over each trace,
scans the launch-site modules for host syncs in launch loops (R1), the
host feeder modules for 64-bit dtypes (R2) and the kernels' mirrored
constants (R5), AST-audits the threaded harness modules (C1-C3), and
reports through the house observability fabric (`lint.*` telemetry
counters/gauges).
"""

from __future__ import annotations

import inspect
import json
import logging
import time
from dataclasses import dataclass, field

from .. import telemetry
from ..gpu import lint as lint_mod
from ..gpu.lint import Finding
from . import concurrency, registry

logger = logging.getLogger(__name__)

# Threaded harness modules under the C1-C3 lock-annotation convention
# (the JAX driver's twelve, `tpu.` read as `gpu.`).
CONCURRENCY_MODULE_NAMES = (
    "jepsen_tpu_torch.telemetry",
    "jepsen_tpu_torch.monitor",
    "jepsen_tpu_torch.nodeprobe",
    "jepsen_tpu_torch.interpreter",
    "jepsen_tpu_torch.gpu.profiler",
    # the fleet data plane: every threaded class annotated
    "jepsen_tpu_torch.fleet.scheduler",
    "jepsen_tpu_torch.fleet.server",
    "jepsen_tpu_torch.fleet.client",
    "jepsen_tpu_torch.fleet.flightrec",
    "jepsen_tpu_torch.chaos",
    # checkpoint-and-extend: the store's fault hook and the streaming
    # elle consumer are both threaded
    "jepsen_tpu_torch.gpu.ckpt",
    "jepsen_tpu_torch.gpu.elle",
)


@dataclass
class LintReport:
    findings: list[Finding] = field(default_factory=list)
    traces: list[dict] = field(default_factory=list)  # per-trace meta
    errors: list[dict] = field(default_factory=list)  # entry -> error
    wall_s: float = 0.0
    ratchet: dict | None = None                       # vs a baseline

    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def aggregates(self) -> dict:
        """The JAX report's ledger numbers, under its keys: R3's bytes
        (here, bytes copied before a launch), R4 replicated bytes and
        unsharded batch-axis count (0 on one card)."""
        non_donated = sum(f.cost_bytes or 0 for f in self.findings
                          if f.rule == "R3")
        replicated = sum(f.cost_bytes or 0 for f in self.findings
                         if f.rule == "R4"
                         and f.site.startswith("replicated:"))
        unsharded = sum(1 for f in self.findings
                        if f.rule == "R4"
                        and f.site.startswith("unsharded-axis:"))
        return {"non_donated_bytes": int(non_donated),
                "replicated_bytes": int(replicated),
                "unsharded_axes": int(unsharded),
                "findings": self.by_rule()}

    def to_dict(self) -> dict:
        out = {"findings": [f.to_dict() for f in self.findings],
               "aggregates": self.aggregates(),
               "traces": self.traces, "wall_s": round(self.wall_s, 3)}
        if self.errors:
            out["errors"] = self.errors
        if self.ratchet is not None:
            out["ratchet"] = {
                "new": [f.to_dict() for f in self.ratchet["new"]],
                "baselined": len(self.ratchet["baselined"]),
                "stale": self.ratchet["stale"],
            }
        return out

    def text(self) -> str:
        lines = []
        agg = self.aggregates()
        lines.append(
            f"graftlint: {len(self.findings)} finding(s) across "
            f"{len(self.traces)} trace(s) in {self.wall_s:.2f}s — "
            + (" ".join(f"{r}={n}" for r, n in agg["findings"].items())
               or "clean"))
        lines.append(
            f"  R3 copied {agg['non_donated_bytes'] / 1024:.0f} "
            f"KiB · R4 replicated {agg['replicated_bytes'] / 1024:.0f}"
            f" KiB · R4 unsharded axes {agg['unsharded_axes']}")
        new = set()
        if self.ratchet is not None:
            new = {f.key for f in self.ratchet["new"]}
            lines.append(
                f"  baseline: {len(self.ratchet['baselined'])} "
                f"pinned, {len(new)} NEW, "
                f"{len(self.ratchet['stale'])} stale (fixed)")
        for f in sorted(self.findings,
                        key=lambda f: (f.key not in new, f.key)):
            mark = "NEW " if f.key in new else ""
            where = f"  [{f.file}:{f.line}]" if f.file else ""
            lines.append(f"{mark}{f.rule} {f.kernel} "
                         f"{f.site}{where}")
            lines.append(f"    {f.message}")
            if f.hint:
                lines.append(f"    fix: {f.hint}")
        if self.ratchet and self.ratchet["stale"]:
            lines.append("stale baseline entries (fixed — rerun with "
                         "--update to prune):")
            for k in self.ratchet["stale"]:
                lines.append(f"  {k}")
        for e in self.errors:
            lines.append(f"TRACE ERROR {e['entry']}/{e['bucket']}: "
                         f"{e['error']}")
        return "\n".join(lines)


def _concurrency_modules() -> list:
    import importlib

    mods = []
    for name in CONCURRENCY_MODULE_NAMES:
        try:
            mods.append(importlib.import_module(name))
        except ImportError:  # pragma: no cover — partial installs
            logger.warning("concurrency lint: cannot import %s", name)
    return mods


def host_sync_findings() -> list[Finding]:
    """R1's AST scan over the launch-site modules, before
    registry.R1_HOST_ONLY is applied."""
    out: list[Finding] = []
    sites = registry.launch_site_modules()
    index = lint_mod.launch_sync_index({
        m.__name__: inspect.getsource(m)
        for m in sites + registry.kernel_modules()})
    for m in sites:
        out.extend(lint_mod.scan_source_host_sync(
            m.__name__, inspect.getsourcefile(m), index))
    return out


def source_findings() -> list[Finding]:
    """The rules that read source rather than a launch: R1 over the
    launch-site modules (less the loops registry.R1_HOST_ONLY shows to
    launch nothing), R2 over the host feeders, R5 over the mirrored
    constants."""
    out = [f for f in host_sync_findings()
           if f.key not in registry.R1_HOST_ONLY]
    for mod in registry.host_feeder_modules():
        out.extend(lint_mod.scan_module_dtypes(mod))
    for kernel, pairs in registry.MIRRORS:
        py, cu = registry.mirror_paths(kernel)
        out.extend(lint_mod.mirror_findings(kernel, py, cu, pairs))
    return out


def _buckets(entry, runtime: dict) -> list[dict]:
    buckets = list(entry.buckets)
    known = {b["label"] for b in buckets}
    return buckets + [b for b in runtime.get(entry.name, ())
                      if b["label"] not in known]


def run_lint(runtime_buckets: bool = False,
             concurrency_lint: bool = True,
             trace_kernels: bool = True,
             full: bool = False,
             rules: set[str] | None = None) -> LintReport:
    """The full pass. runtime_buckets=False keeps the report
    deterministic (the committed baseline's contract); True also traces
    the shapes this process launched (profiler.shape_buckets()) and
    runs R5's bucket-cardinality cross-check. full=False reads the
    launch plans on meta tensors alone (CPU-safe, the tier-1 mode);
    full=True, the counterpart of the JAX driver's lowering, builds and
    loads the kernel libraries and holds every trace's Python scratch
    and shared-memory sizes to the library's: it needs the card and
    nvcc and raises without them, and a mismatch is a trace error."""
    t0 = time.monotonic()
    rep = LintReport()
    if trace_kernels:
        runtime: dict = {}
        if full:
            import torch

            from ..gpu.kernels import build

            if not torch.cuda.is_available():
                raise RuntimeError("lint --full builds and asks the "
                                   "kernel libraries: no CUDA device is "
                                   "available")
            build.build_all()
        if runtime_buckets:
            from ..gpu import profiler

            raw = profiler.shape_buckets()
            for b in (registry.runtime_wgl_buckets(raw.get("wgl", ()))
                      + registry.runtime_scc_buckets(raw.get("scc", ()))):
                runtime.setdefault(b["entry"], []).append(b)
        for entry in registry.entries():
            for b in _buckets(entry, runtime):
                try:
                    trace = entry.trace(b, full=full)
                except Exception as e:  # noqa: BLE001 — keep linting
                    logger.exception("tracing %s/%s failed",
                                     entry.name, b.get("label"))
                    rep.errors.append({"entry": entry.name,
                                       "bucket": b.get("label"),
                                       "error": repr(e)})
                    continue
                rep.findings.extend(lint_mod.run_rules(trace))
                rep.traces.append({
                    "kernel": trace.name, "bucket": trace.bucket,
                    "args_bytes": sum(a.nbytes for a in trace.args),
                    "copied_bytes": sum(a.nbytes for a in trace.args
                                        if a.copied),
                    "outputs_bytes": sum(a.nbytes for a in trace.outputs),
                    "scratch_bytes": trace.scratch_bytes,
                    "smem_bytes": trace.smem_bytes,
                    "carry_bytes": trace.carry_bytes,
                    "bucket_policy": trace.bucket_policy,
                    **({"library": trace.library} if full else {}),
                })
        rep.findings.extend(source_findings())
        if runtime_buckets:
            from ..gpu import profiler

            rep.findings.extend(lint_mod.runtime_bucket_findings(
                profiler.shape_buckets()))
    if concurrency_lint:
        for mod in _concurrency_modules():
            rep.findings.extend(concurrency.scan_module(mod))
    if rules is not None:
        rep.findings = [f for f in rep.findings if f.rule in rules]
    rep.findings.sort(key=lambda f: (f.rule, f.kernel, f.site))
    rep.wall_s = time.monotonic() - t0
    _mirror_telemetry(rep)
    return rep


def _mirror_telemetry(rep: LintReport) -> None:
    tel = telemetry.get()
    tel.count("lint.runs")
    tel.count("lint.traces", len(rep.traces))
    for rule, n in rep.by_rule().items():
        tel.count(f"lint.findings.{rule}", n)
    agg = rep.aggregates()
    tel.gauge("lint.non-donated-bytes", agg["non_donated_bytes"])
    tel.gauge("lint.replicated-bytes", agg["replicated_bytes"])
    tel.gauge("lint.unsharded-axes", agg["unsharded_axes"])
    tel.gauge("lint.wall-s", round(rep.wall_s, 3))


def gate(report: LintReport, baseline_path,
         rules: set[str] | None = None) -> LintReport:
    """Applies the baseline ratchet to a report (sets .ratchet);
    callers fail on report.ratchet['new']. When the report was
    rule-filtered, pass the same `rules` so pinned findings of OTHER
    rules aren't mislabeled as stale (fixed)."""
    baseline = lint_mod.load_baseline(baseline_path)
    if rules is not None:
        baseline = dict(baseline, findings=[
            e for e in baseline.get("findings", ())
            if e.get("rule") in rules])
    report.ratchet = lint_mod.ratchet(report.findings, baseline)
    telemetry.get().count("lint.new-findings",
                          len(report.ratchet["new"]))
    return report


def main(argv=None) -> int:
    """`python -m jepsen_tpu_torch lint` behind cli.lint_cmd: report,
    gate against --baseline (exit 1 on NEW findings), --update rewrites
    the baseline (pinning current findings, pruning stale keys)."""
    import argparse

    p = argparse.ArgumentParser(prog="lint")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="Gate against this committed baseline: only "
                        "NEW findings (not pinned there) fail.")
    p.add_argument("--update", action="store_true",
                   help="Rewrite --baseline with the current "
                        "findings (prunes stale entries).")
    p.add_argument("--json", action="store_true", dest="json_",
                   help="Emit the full report as JSON.")
    p.add_argument("--runtime-buckets", action="store_true",
                   help="Also trace the shape buckets this process "
                        "launched (non-deterministic; never used for "
                        "the committed baseline).")
    p.add_argument("--full", action="store_true",
                   help="Also build the kernel libraries and hold each "
                        "launch's Python scratch and shared-memory "
                        "sizes to theirs (needs the card and nvcc).")
    p.add_argument("--rules", default=None, metavar="R1,R2,...",
                   help="Restrict to these rule ids.")
    opts = p.parse_args(argv)
    rules = (set(x.strip() for x in opts.rules.split(","))
             if opts.rules else None)
    if opts.update and rules is not None:
        # a rule-filtered report pins only those rules: writing it
        # would silently drop every other rule's baseline entries,
        # and the next full gate would fail on all of them as NEW
        print("--update with --rules would drop the other rules' "
              "pinned findings; run --update without --rules")
        return 254
    if opts.update and (opts.runtime_buckets or opts.full):
        # the committed baseline's contract is the deterministic
        # default mode: pinning runtime-bucket findings leaves entries
        # every default-mode gate (tier-1, web) reports as stale
        print("--update pins the deterministic default mode only; "
              "drop --runtime-buckets/--full")
        return 254
    rep = run_lint(runtime_buckets=opts.runtime_buckets,
                   full=opts.full, rules=rules)
    if opts.update:
        if not opts.baseline:
            print("--update requires --baseline")
            return 254
        lint_mod.write_baseline(opts.baseline, rep.findings)
        print(f"wrote {opts.baseline} "
              f"({len(rep.findings)} finding(s) pinned)")
        return 0
    if opts.baseline:
        gate(rep, opts.baseline, rules=rules)
    if opts.json_:
        print(json.dumps(rep.to_dict(), indent=1))
    else:
        print(rep.text())
    if rep.errors:
        return 2
    if rep.ratchet is not None and rep.ratchet["new"]:
        return 1
    return 0
