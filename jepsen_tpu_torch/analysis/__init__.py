"""Static analysis of the checker pipeline (graftlint; the port's copy of
jepsen_tpu/analysis/).

`jepsen_tpu_torch.gpu.lint` holds the rule suite over the kernels'
launches; this package holds the drivers:

  registry.py     enumerates every hand kernel's launch path and traces
                  it off the wrapper's launch plan at representative
                  shape buckets
  concurrency.py  AST lock-discipline lint over the threaded harness
                  modules (the _guarded_by_lock convention)
  driver.py       runs registry x rules + the source scans + the
                  concurrency lint, aggregates, renders, and gates
                  against the committed lint-baseline-torch.json

Surfaced via `python -m jepsen_tpu_torch lint`, the web /lint page and
`lint.*` telemetry counters. doc/static-analysis-torch.md is the rule
catalog.
"""

from .driver import LintReport, run_lint  # noqa: F401
