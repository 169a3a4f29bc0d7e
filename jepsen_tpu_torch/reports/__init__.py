"""Report rendering: the anomaly explanations (explain.py), the HTML
timeline (timeline.py) and the bank workload's balance plot (perf.py) of
jepsen_tpu/reports.

The reference keeps these under jepsen.checker.* (checker/timeline.clj)
and knossos.linear.report. The latency, rate and clock plots of the JAX
package (the rest of reports/perf.py, reports/clock.py) are not ported.
"""
