"""Report rendering: the anomaly explanations (explain.py) and the HTML
timeline (timeline.py) of jepsen_tpu/reports.

The reference keeps these under jepsen.checker.* (checker/timeline.clj)
and knossos.linear.report. The latency, rate and clock plots of the JAX
package (reports/perf.py, reports/clock.py) need matplotlib and are not
ported.
"""
