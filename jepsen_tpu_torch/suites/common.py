"""Shared plumbing for the SQL-CLI suites (galera, tidb, ...): one
ambient-session transport class and the fail/info error classifier,
parameterized on connection argv and the engine's definite-error
patterns (every reference suite carries its own with-errors macro
making the same split; here it's one helper).

The port's copy of jepsen_tpu/suites/common.py.
"""

from __future__ import annotations

import re

from .. import control


class SqlCli:
    """Runs one SQL batch through a CLI on the client's node. Split
    out so tests can stub `run`."""

    def __init__(self, test, node, argv, timeout: float = 10.0):
        self.test = test
        self.node = node
        self.argv = argv
        self.timeout = timeout
        self.sess = control.session(test, node)

    def run(self, sql: str) -> str:
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_(*self.argv, sql,
                                 timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


def make_classifier(definite_patterns):
    """op-error classifier: reads and definite rejections -> :fail,
    anything indeterminate -> :info."""
    definite_re = re.compile("|".join(definite_patterns), re.I)

    def classify(op, e: Exception):
        msg = (f"{getattr(e, 'err', '')} {getattr(e, 'out', '')} "
               f"{e}")
        if op.f == "read" or definite_re.search(msg):
            return op.copy(type="fail", error=msg.strip()[:200])
        return op.copy(type="info", error=msg.strip()[:200])

    return classify
