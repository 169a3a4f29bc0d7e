"""Workloads whose checkers run on the card: the bank workload of
jepsen_tpu/workloads, ported."""
