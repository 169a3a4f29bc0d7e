"""Report rendering (the port's copy of jepsen_tpu/reports): the anomaly
explanations (explain.py), the HTML timeline (timeline.py), the latency,
rate, monitor and bank plots (perf.py), the clock plot (clock.py), and
the readers of a stored run (telemetry.py, nodes.py, profile.py,
trace.py).

The reference keeps these under jepsen.checker.* (checker/perf.clj,
checker/timeline.clj, checker/clock.clj) and knossos.linear.report; they
live in their own package here because Python can't have both
checker.perf() (the checker constructor) and a checker.perf submodule.
"""
