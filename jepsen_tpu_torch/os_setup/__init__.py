"""Operating-system automation (the port's copy of
jepsen_tpu/os_setup/).

Capability reference: jepsen/src/jepsen/os.clj (OS protocol, os.clj:4-9)
plus the distro implementations in os/debian.clj, os/centos.clj,
os/ubuntu.clj (ported in sibling modules).
"""

from __future__ import annotations


class OS:
    """Prepares and tears down an operating system on a node."""

    def setup(self, test, node) -> None:
        pass

    def teardown(self, test, node) -> None:
        pass


class NoopOS(OS):
    pass


noop = NoopOS()
