"""Workloads: a generator and the checker that judges its histories.
The port's copies of jepsen_tpu/workloads' register, bank, txn_append,
txn_wr and lock workloads; the register, bank and transactional
checkers run on the card. The registry of jepsen_tpu/workloads/__init__.py
and the other workload families are not ported yet."""
