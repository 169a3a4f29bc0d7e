"""Network manipulation: partitions and packet shaping (the port's copy
of jepsen_tpu/net.py).

Capability reference: jepsen/src/jepsen/net/proto.clj:5-35 (Net and
PartitionAll protocols), jepsen/src/jepsen/net.clj (tc/netem behavior
table and shaping 67-173, iptables impl 175-233, ipfilter impl 235-270),
jepsen/src/jepsen/control/net.clj (IP resolution, reachability).

A Net applies *mechanism*: which packets to drop/delay/corrupt on which
nodes. Grudge *policy* (who should drop whom) lives in nemesis.core and
arrives here as a map node -> set of nodes whose packets it drops.
"""

from __future__ import annotations

import re

from . import control
from .control.core import Lit, RemoteError
from .util import real_pmap

TC = "/sbin/tc"


def _trace_net(name: str, **attrs) -> None:
    """Partition/shaping changes as span events on the nemesis op that
    applied them (the nemesis worker's invoke carries the ambient
    trace context), so a cycle that closed across a partition window
    links straight to the iptables/tc change that opened it."""
    from . import tracing

    tracing.event(f"net.{name}", **attrs)


# ---------------------------------------------------------------------------
# IP resolution (control/net.clj)
# ---------------------------------------------------------------------------

class BlankGetentIP(Exception):
    """getent returned no address for a hostname (control/net.clj ip*)."""


def reachable(node) -> bool:
    """Can the current node ping the given node? (control/net.clj:8-12)"""
    try:
        control.exec_("ping", "-w", 1, node)
        return True
    except RemoteError:
        return False


def local_ip() -> str:
    """The current node's IP address (control/net.clj:14-17)."""
    return control.exec_("hostname", "-I").split()[0]


def ip_unmemoized(host) -> str:
    """Looks up an IPv4 address for a hostname on the current node via
    getent ahostsv4 (control/net.clj:19-44). Falls back to local-ip when
    getent returns loopback (Debian Bookworm behavior)."""
    res = control.exec_("getent", "ahostsv4", host)
    first_line = res.splitlines()[0] if res else ""
    addr = first_line.split()[0] if first_line.split() else ""
    if addr.startswith("127"):
        return local_ip()
    if not addr:
        raise BlankGetentIP(f"blank getent ip for host {host!r}: {res!r}")
    return addr


_ip_cache: dict = {}


def ip(host) -> str:
    """Memoized ip_unmemoized (control/net.clj:46-48)."""
    if host not in _ip_cache:
        _ip_cache[host] = ip_unmemoized(host)
    return _ip_cache[host]


def clear_ip_cache() -> None:
    _ip_cache.clear()


def control_ip() -> str:
    """The control node's IP as seen from the current DB node, parsed
    from $SSH_CLIENT (control/net.clj:50-62)."""
    out = control.exec_("bash", "-c", "echo $SSH_CLIENT")
    m = re.match(r"^(.+?)\s", out + " ")
    if not m or not m.group(1):
        raise RuntimeError(f"couldn't parse SSH_CLIENT: {out!r}")
    return m.group(1)


# ---------------------------------------------------------------------------
# tc helpers (net.clj:44-66)
# ---------------------------------------------------------------------------

def net_dev() -> str:
    """The current node's primary network interface, from
    `ip -o link show` minus loopback (net.clj:46-57)."""
    with control.su():
        out = control.exec_("ip", "-o", "link", "show")
    for line in out.splitlines():
        m = re.match(r"\d+: ([^:@]+)", line)
        if m and m.group(1) != "lo":
            return m.group(1)
    raise RuntimeError(f"couldn't determine network interface:\n{out}")


def qdisc_del(dev: str) -> None:
    """Deletes the root qdisc on dev; tolerates there being none
    (net.clj:59-66)."""
    try:
        with control.su():
            control.exec_(TC, "qdisc", "del", "dev", dev, "root")
    except RemoteError as e:
        if e.exit == 2:  # no qdisc to delete
            return
        raise


# Packet behaviors and their default option values (net.clj:68-95).
ALL_PACKET_BEHAVIORS = {
    "delay": {"time": "50ms", "jitter": "10ms", "correlation": "25%",
              "distribution": "normal"},
    "loss": {"percent": "20%", "correlation": "75%"},
    "corrupt": {"percent": "20%", "correlation": "75%"},
    "duplicate": {"percent": "20%", "correlation": "75%"},
    "reorder": {"percent": "20%", "correlation": "75%"},
    "rate": {"rate": "1mbit"},
}

_BEHAVIOR_ORDER = ["delay", "loss", "corrupt", "duplicate", "reorder",
                   "rate"]


def behaviors_to_netem(behaviors: dict) -> list:
    """Netem option list for a behavior map, defaults filled in
    (net.clj:97-126). :reorder requires :delay."""
    behaviors = dict(behaviors)
    if "reorder" in behaviors and "delay" not in behaviors:
        behaviors["delay"] = ALL_PACKET_BEHAVIORS["delay"]
    args: list = []
    for b in _BEHAVIOR_ORDER:
        if b not in behaviors:
            continue
        o = {**ALL_PACKET_BEHAVIORS[b], **(behaviors[b] or {})}
        if b == "delay":
            args += ["delay", o["time"], o["jitter"], o["correlation"],
                     "distribution", o["distribution"]]
        elif b == "rate":
            args += ["rate", o["rate"]]
        else:
            args += [b, o["percent"], o["correlation"]]
    return args


# ---------------------------------------------------------------------------
# Net protocol
# ---------------------------------------------------------------------------

class Net:
    """Network manipulation protocol (net/proto.clj:5-26). Implementors
    may override drop_all for a one-call partition fast path
    (PartitionAll, net/proto.clj:28-35)."""

    def drop(self, test, src, dest) -> None:
        """Drops traffic from src at dest."""
        raise NotImplementedError

    def heal(self, test) -> None:
        """Ends all drops, restoring the network."""
        raise NotImplementedError

    def slow(self, test, mean: int = 50, variance: int = 10,
             distribution: str = "normal") -> None:
        """Delays packets on every node."""
        raise NotImplementedError

    def flaky(self, test) -> None:
        """Introduces randomized packet loss on every node."""
        raise NotImplementedError

    def fast(self, test) -> None:
        """Removes packet delay/loss."""
        raise NotImplementedError

    def shape(self, test, nodes, behavior: dict):
        """Shapes traffic to `nodes` per a behavior map (delay/loss/
        corrupt/duplicate/reorder/rate)."""
        raise NotImplementedError

    def drop_all(self, test, grudge: dict) -> None:
        """Applies a grudge {node: nodes-to-drop}; default expands into
        parallel drop calls (net.clj:26-42)."""
        pairs = [(src, dst) for dst, srcs in grudge.items()
                 for src in srcs]
        real_pmap(lambda p: self.drop(test, p[0], p[1]), pairs)


class NoopNet(Net):
    """Does nothing (net.clj noop)."""

    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, mean=50, variance=10, distribution="normal"):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass

    def shape(self, test, nodes, behavior):
        pass

    def drop_all(self, test, grudge):
        pass


def _shape_on_node(test, node, targets, behavior):
    """Per-node body of net_shape (net.clj:128-173)."""
    nodes = set(test["nodes"])
    tset = set(targets or ())
    if node in tset:
        tset = nodes - {node}
    dev = net_dev()
    qdisc_del(dev)
    if not (tset and behavior):
        return None
    with control.su():
        # root prio qdisc; bands 1:1-3 are the system default priomap
        control.exec_(TC, "qdisc", "add", "dev", dev, "root", "handle",
                      "1:", "prio", "bands", 4, "priomap",
                      *"1 2 2 2 1 2 0 0 1 1 1 1 1 1 1 1".split())
        # band 1:4 is a netem qdisc with the requested behavior
        control.exec_(TC, "qdisc", "add", "dev", dev, "parent", "1:4",
                      "handle", "40:", "netem",
                      *behaviors_to_netem(behavior))
        # steer each target's dst ip into the netem band
        for target in sorted(tset):
            control.exec_(TC, "filter", "add", "dev", dev, "parent",
                          "1:0", "protocol", "ip", "prio", 3, "u32",
                          "match", "ip", "dst", ip(target),
                          "flowid", "1:4")
    return sorted(tset)


def _net_shape(net, test, targets, behavior):
    results = control.on_nodes(
        test, lambda t, n: _shape_on_node(t, n, targets, behavior))
    if targets and behavior:
        _trace_net("shape", targets=sorted(map(str, targets or ())),
                   behavior=sorted(behavior or ()))
        return ["shaped", results, "netem", behaviors_to_netem(behavior)]
    _trace_net("shape-clear")
    return ["reliable", results]


class IPTables(Net):
    """Default iptables implementation (net.clj:175-233)."""

    def drop(self, test, src, dest):
        def body(t, n):
            with control.su():
                control.exec_("iptables", "-A", "INPUT", "-s", ip(src),
                              "-j", "DROP", "-w")
        control.on_nodes(test, body, [dest])
        _trace_net("drop", src=str(src), dest=str(dest))

    def heal(self, test):
        def body(t, n):
            with control.su():
                control.exec_("iptables", "-F", "-w")
                control.exec_("iptables", "-X", "-w")
        control.on_nodes(test, body)
        _trace_net("heal")

    def slow(self, test, mean=50, variance=10, distribution="normal"):
        def body(t, n):
            with control.su():
                control.exec_(TC, "qdisc", "add", "dev", "eth0", "root",
                              "netem", "delay", f"{mean}ms",
                              f"{variance}ms", "distribution",
                              distribution)
        control.on_nodes(test, body)

    def flaky(self, test):
        def body(t, n):
            with control.su():
                control.exec_(TC, "qdisc", "add", "dev", "eth0", "root",
                              "netem", "loss", "20%", "75%")
        control.on_nodes(test, body)

    def fast(self, test):
        def body(t, n):
            try:
                with control.su():
                    control.exec_(TC, "qdisc", "del", "dev", "eth0",
                                  "root")
            except RemoteError as e:
                if "RTNETLINK answers: No such file or directory" in (
                        (e.err or "") + (e.out or "")):
                    return
                raise
        control.on_nodes(test, body)

    def shape(self, test, nodes, behavior):
        return _net_shape(self, test, nodes, behavior)

    def drop_all(self, test, grudge):
        def snub(t, node):
            srcs = grudge.get(node) or ()
            if not srcs:
                return
            with control.su():
                control.exec_("iptables", "-A", "INPUT", "-s",
                              ",".join(ip(s) for s in sorted(srcs)),
                              "-j", "DROP", "-w")
        control.on_nodes(test, snub, list(grudge.keys()))
        _trace_net("partition",
                   grudge={str(n): sorted(map(str, srcs))
                           for n, srcs in grudge.items() if srcs})


class IPFilter(Net):
    """ipf-based implementation for ipfilter systems (net.clj:235-270)."""

    def drop(self, test, src, dest):
        def body(t, n):
            with control.su():
                control.exec_("echo", "block", "in", "from", src, "to",
                              "any", Lit("|"), "ipf", "-f", "-")
        control.on_nodes(test, body, [dest])
        _trace_net("drop", src=str(src), dest=str(dest))

    def heal(self, test):
        def body(t, n):
            with control.su():
                control.exec_("ipf", "-Fa")
        control.on_nodes(test, body)
        _trace_net("heal")

    slow = IPTables.slow
    flaky = IPTables.flaky
    fast = IPTables.fast

    def shape(self, test, nodes, behavior):
        return _net_shape(self, test, nodes, behavior)


noop = NoopNet()
iptables = IPTables()
ipfilter = IPFilter()
