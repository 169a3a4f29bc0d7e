"""Hazelcast test suite: CP-subsystem locks, semaphores, CAS longs,
id generators, and queues against a real coordination service.

Capability reference: hazelcast/src/jepsen/hazelcast.clj — the DB
builds + ships its own server jar and starts it with a --members list
(34-118); clients are per-structure (lock 258-327, fenced/reentrant
CP locks 329-420, CP semaphore 422-453, atomic long / reference CAS
169-256, queue 47-120 in the workload map, id-gen); the workload map
(652-768) pairs each client with a cycled acquire/release generator
and a linearizable checker over the matching mutex/semaphore model.

The op->model semantics (OwnerMutex, FencedMutex, ReentrantMutex,
Semaphore) live in jepsen_tpu_torch.workloads.lock; this suite contributes
the DB automation and the wire clients. Like the reference — which
runs its OWN server project rather than stock hazelcast alone
(hazelcast.clj:34-66 `build-server!`) — the client side is a thin
bundled console jar speaking a line protocol:

    lock acquire <name>      -> OK <fence> | BUSY
    lock release <name>      -> OK | ERR <msg>
    sem acquire <name>       -> OK | BUSY
    sem release <name>       -> OK | ERR <msg>
    long read <name>         -> OK <v>
    long write <name> <v>    -> OK
    long cas <name> <a> <b>  -> OK | FAIL
    ref read <name>          -> OK <v>|nil
    ref write <name> <v>     -> OK
    ref cas <name> <a> <b>   -> OK | FAIL
    id next <name>           -> OK <id>
    q offer <name> <v>       -> OK
    q poll <name>            -> OK <v> | EMPTY

One JVM invocation per op (`java -jar client.jar --addresses ...
--session jepsen-p<process> --cmd ...`): CP lock/semaphore state is
bound to a CP SESSION, so the jar manages one NAMED session per jepsen
process through the CP Session Management API (create-if-absent on
first use) instead of the client's auto-session — otherwise every JVM
exit would end the session and auto-release held locks mid-test. The
server config stretches session-time-to-live to outlive think time
between a process's ops; a crashed process's session simply expires
(its locks release), exactly the reincarnation semantics the lock
models expect.

The port's copy of jepsen_tpu/suites/hazelcast.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import logging

from .. import checker as chk
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import testing
from ..checker import models
from ..control import util as cu
from ..control.core import RemoteError
from ..os_setup import debian
from ..workloads import lock as lock_wl
from ..workloads import queue as queue_wl
from ..workloads import register as register_wl
from ..workloads import unique_ids as ids_wl

logger = logging.getLogger(__name__)

DIR = "/opt/hazelcast"
VERSION = "5.3.6"
URL = ("https://repository.hazelcast.com/download/hazelcast/"
       f"hazelcast-{VERSION}.tar.gz")
CLIENT_JAR = f"{DIR}/jepsen-client.jar"
LOG_FILE = f"{DIR}/server.log"
PID_FILE = f"{DIR}/server.pid"
CONFIG = f"{DIR}/config/hazelcast.yaml"
PORT = 5701


def member_config(test) -> str:
    """Server YAML: static member list + CP subsystem sized to the
    cluster (the reference passes --members on the command line,
    hazelcast.clj:78-89; CP needs >= 3 members for raft)."""
    nodes = test["nodes"]
    members = "\n".join(f"          - {n}:{PORT}" for n in nodes)
    cp = max(len(nodes), 3)
    return f"""hazelcast:
  cluster-name: jepsen
  network:
    port:
      port: {PORT}
    join:
      multicast:
        enabled: false
      tcp-ip:
        enabled: true
        member-list:
{members}
  cp-subsystem:
    cp-member-count: {cp}
    session-time-to-live-seconds: 600
    session-heartbeat-interval-seconds: 5
"""


class HzDB(jdb.DB):
    """Installs and runs hazelcast members (hazelcast.clj db, 98-118)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            debian.install(["openjdk-17-jre-headless"])
            cu.install_archive(URL, DIR)
            cu.write_file(member_config(test), CONFIG)
        self.start(test, node)
        cu.await_tcp_port(PORT, timeout_secs=90)

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", LOG_FILE, PID_FILE,
                          check=False)

    def log_files(self, test, node):
        return [LOG_FILE]

    def start(self, test, node):
        with control.su():
            cu.start_daemon(
                {"chdir": DIR, "logfile": LOG_FILE,
                 "pidfile": PID_FILE},
                f"{DIR}/bin/hz", "start", "-c", CONFIG)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("com.hazelcast")
            control.exec_("rm", "-rf", PID_FILE, check=False)


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------


class HzConsole:
    """One-shot line-protocol invocations of the bundled client jar,
    bound to one named CP session per jepsen process (see module
    docstring)."""

    def __init__(self, test, node, timeout: float = 10.0):
        self.node = node
        self.addresses = ",".join(f"{n}:{PORT}" for n in test["nodes"])
        self.timeout = timeout

    def cmd(self, line: str, session: str = "jepsen") -> str:
        out = control.exec_(
            "timeout", str(int(self.timeout)), "java", "-jar",
            CLIENT_JAR, "--addresses", self.addresses,
            "--session", session, "--cmd", line)
        return out.strip()


class _HzClient(jclient.Client):
    """Shared open/close: one console handle per (client, node)."""

    console_factory = HzConsole

    def __init__(self, console_factory=None):
        if console_factory is not None:
            self.console_factory = console_factory
        self.console = None

    def open(self, test, node):
        c = type(self)(self.console_factory)
        c.console = self.console_factory(test, node)
        return c

    def close(self, test):
        self.console = None


class LockClient(_HzClient):
    """acquire/release ops against one named CP lock; ok acquires
    carry {"fence": n} (hazelcast.clj lock/fenced-lock clients,
    258-420 — the fence is FencedLock.getFence)."""

    def __init__(self, console_factory=None, name: str = "jepsen.lock"):
        super().__init__(console_factory)
        self.name = name

    def open(self, test, node):
        c = super().open(test, node)
        c.name = self.name
        return c

    def invoke(self, test, op):
        try:
            out = self.console.cmd(
                f"lock {op.f} {self.name}",
                session=f"jepsen-p{op.process}")
        except RemoteError as e:
            return op.copy(type="info", error=str(e))
        if out.startswith("OK"):
            parts = out.split()
            if op.f == "acquire" and len(parts) > 1:
                return op.copy(type="ok",
                               value={"fence": int(parts[1])})
            return op.copy(type="ok")
        if out == "BUSY":
            return op.copy(type="fail", error="busy")
        return op.copy(type="fail", error=out)


class SemaphoreClient(_HzClient):
    """acquire/release against one named CP semaphore
    (hazelcast.clj cp-semaphore-client, 422-453)."""

    def __init__(self, console_factory=None,
                 name: str = "jepsen.semaphore"):
        super().__init__(console_factory)
        self.name = name

    def open(self, test, node):
        c = super().open(test, node)
        c.name = self.name
        return c

    def invoke(self, test, op):
        try:
            out = self.console.cmd(
                f"sem {op.f} {self.name}",
                session=f"jepsen-p{op.process}")
        except RemoteError as e:
            return op.copy(type="info", error=str(e))
        if out.startswith("OK"):
            return op.copy(type="ok")
        if out == "BUSY":
            return op.copy(type="fail", error="no permits")
        return op.copy(type="fail", error=out)


class CasLongClient(_HzClient):
    """read/write/cas on a CP IAtomicLong (hazelcast.clj
    cp-cas-long-client, 169-211)."""

    def __init__(self, console_factory=None,
                 name: str = "jepsen.cas-long"):
        super().__init__(console_factory)
        self.name = name

    def open(self, test, node):
        c = super().open(test, node)
        c.name = self.name
        return c

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.console.cmd(f"long read {self.name}")
                if out.startswith("OK"):
                    v = out.split()[1]
                    return op.copy(type="ok",
                                   value=None if v == "nil"
                                   else int(v))
            elif op.f == "write":
                out = self.console.cmd(
                    f"long write {self.name} {op.value}")
                if out.startswith("OK"):
                    return op.copy(type="ok")
            else:  # cas
                a, b = op.value
                out = self.console.cmd(f"long cas {self.name} {a} {b}")
                if out.startswith("OK"):
                    return op.copy(type="ok")
                if out == "FAIL":
                    return op.copy(type="fail", error="cas failed")
        except RemoteError as e:
            # reads fail safely; writes/cas are indeterminate
            t = "fail" if op.f == "read" else "info"
            return op.copy(type=t, error=str(e))
        return op.copy(type="fail", error=out)


class IdGenClient(_HzClient):
    """generate ops against a CP atomic-long id source (hazelcast.clj
    cp-id-gen-long / atomic-ref-ids, 232-256)."""

    def __init__(self, console_factory=None, name: str = "jepsen.ids"):
        super().__init__(console_factory)
        self.name = name

    def open(self, test, node):
        c = super().open(test, node)
        c.name = self.name
        return c

    def invoke(self, test, op):
        try:
            out = self.console.cmd(f"id next {self.name}")
        except RemoteError as e:
            return op.copy(type="info", error=str(e))
        if out.startswith("OK"):
            return op.copy(type="ok", value=int(out.split()[1]))
        return op.copy(type="fail", error=out)


class QueueClient(_HzClient):
    """enqueue/dequeue against a distributed queue (hazelcast.clj
    queue-client, total-queue checked)."""

    def __init__(self, console_factory=None, name: str = "jepsen.q"):
        super().__init__(console_factory)
        self.name = name

    def open(self, test, node):
        c = super().open(test, node)
        c.name = self.name
        return c

    def invoke(self, test, op):
        try:
            if op.f == "enqueue":
                out = self.console.cmd(
                    f"q offer {self.name} {op.value}")
                if out.startswith("OK"):
                    return op.copy(type="ok")
                return op.copy(type="info", error=out)
            if op.f == "drain":
                got = []
                while True:
                    try:
                        out = self.console.cmd(f"q poll {self.name}")
                    except RemoteError as e:
                        # elements polled so far WERE dequeued; losing
                        # them would misreport real dequeues as lost
                        return op.copy(type="info", error=str(e),
                                       value=got)
                    if out == "EMPTY":
                        return op.copy(type="ok", value=got)
                    if out.startswith("OK"):
                        got.append(int(out.split()[1]))
                    else:
                        return op.copy(type="info", error=out,
                                       value=got)
            out = self.console.cmd(f"q poll {self.name}")
        except RemoteError as e:
            return op.copy(type="info", error=str(e))
        if out == "EMPTY":
            return op.copy(type="fail", error="empty")
        if out.startswith("OK"):
            return op.copy(type="ok", value=int(out.split()[1]))
        return op.copy(type="info", error=out)


# ---------------------------------------------------------------------------
# Workloads (hazelcast.clj workloads map, 652-768)
# ---------------------------------------------------------------------------


def _lock_workload(opts, model, client, repeats=1):
    w = lock_wl._workload(dict(opts), model, repeats=repeats)
    w["client"] = client
    return w


def lock(opts):
    return _lock_workload(opts, models.mutex(),
                          LockClient(name="jepsen.lock"))


def owner_lock(opts):
    return _lock_workload(opts, lock_wl.OwnerMutex(),
                          LockClient(name="jepsen.cpLock1"))


def fenced_lock(opts):
    return _lock_workload(opts, lock_wl.FencedMutex(),
                          LockClient(name="jepsen.cpLock1"))


def reentrant_lock(opts):
    o = dict(opts)
    return _lock_workload(
        o, lock_wl.ReentrantMutex(limit=o.get("limit", 2)),
        LockClient(name="jepsen.cpLock2"), repeats=o.get("limit", 2))


def semaphore(opts):
    o = dict(opts)
    return _lock_workload(
        o, lock_wl.Semaphore(permits=o.get("permits", 2)),
        SemaphoreClient())


def _cas_workload(opts, client):
    """read/write/cas mix against ONE named CP long/reference,
    linearizable vs cas-register(0) — IAtomicLong starts at 0
    (hazelcast.clj cp-cas-long / cp-cas-reference, 169-231)."""
    import random as _random

    o = dict(opts)
    rng = _random.Random(o.get("seed"))
    g = gen.limit(o.get("ops", 300),
                  lambda: register_wl.cas_op_mix(rng))
    return {
        "generator": g,
        "checker": chk.linearizable({"model": models.cas_register(0),
                                     "device": o.get("device")}),
        "client": client,
    }


class CasRefClient(_HzClient):
    """read/write/cas on a CP IAtomicReference (hazelcast.clj
    cp-cas-reference-client, 213-231): like the long, but the initial
    value is nil and reads may return nil."""

    def __init__(self, console_factory=None,
                 name: str = "jepsen.cas-ref"):
        super().__init__(console_factory)
        self.name = name

    def open(self, test, node):
        c = super().open(test, node)
        c.name = self.name
        return c

    def invoke(self, test, op):
        try:
            if op.f == "read":
                out = self.console.cmd(f"ref read {self.name}")
                if out.startswith("OK"):
                    v = out.split()[1]
                    return op.copy(type="ok",
                                   value=None if v == "nil"
                                   else int(v))
            elif op.f == "write":
                out = self.console.cmd(
                    f"ref write {self.name} {op.value}")
                if out.startswith("OK"):
                    return op.copy(type="ok")
            else:
                a, b = op.value
                out = self.console.cmd(f"ref cas {self.name} {a} {b}")
                if out.startswith("OK"):
                    return op.copy(type="ok")
                if out == "FAIL":
                    return op.copy(type="fail", error="cas failed")
        except RemoteError as e:
            t = "fail" if op.f == "read" else "info"
            return op.copy(type=t, error=str(e))
        return op.copy(type="fail", error=out)


def cas_long(opts):
    return _cas_workload(opts, CasLongClient())


def cas_reference(opts):
    """IAtomicReference starts at nil, so the model's initial value
    differs from cas_long's 0."""
    import random as _random

    o = dict(opts)
    rng = _random.Random(o.get("seed"))
    from ..workloads import register as register_wl

    g = gen.limit(o.get("ops", 300),
                  lambda: register_wl.cas_op_mix(rng))
    return {
        "generator": g,
        "checker": chk.linearizable(
            {"model": models.cas_register(None),
             "device": o.get("device")}),
        "client": CasRefClient(),
    }


def id_gen(opts):
    w = ids_wl.workload(dict(opts))
    w["client"] = IdGenClient()
    return w


def queue(opts):
    w = queue_wl.workload(dict(opts))
    w["client"] = QueueClient()
    return w


WORKLOADS = {
    "lock": lock,
    "owner-lock": owner_lock,
    "fenced-lock": fenced_lock,
    "reentrant-lock": reentrant_lock,
    "semaphore": semaphore,
    "cas-long": cas_long,
    "cas-reference": cas_reference,
    "id-gen": id_gen,
    "queue": queue,
}


def nemesis_for(opts: dict, db) -> dict:
    from ..nemesis import combined

    faults = set(opts.get("faults") or ("partition",))
    o = dict(opts)
    o.update(db=db, faults=faults,
             interval=opts.get("nemesis_interval", 15))
    return combined.compose_packages(combined.nemesis_packages(o))


def hazelcast_test(opts: dict) -> dict:
    name = opts.get("workload") or "lock"
    w = WORKLOADS[name](opts)
    db = HzDB(version=opts.get("version", VERSION))
    pkg = nemesis_for(opts, db)
    test = testing.noop_test()
    test.update(
        name=f"hazelcast-{name}",
        os=debian.os,
        db=db,
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        nemesis=pkg["nemesis"],
        checker=chk.compose({"workload": w["checker"],
                             "stats": chk.stats(),
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=_suite_generator(opts, w, pkg))
    return test


def _suite_generator(opts, w, pkg):
    nemesis_gen = pkg.get("generator")
    client_part = gen.stagger(1.0 / opts.get("rate", 10),
                              w["generator"])
    mix = gen.time_limit(
        opts.get("time_limit", 60),
        gen.clients(client_part, nemesis_gen)
        if nemesis_gen is not None else gen.clients(client_part))
    parts = [mix]
    final = w.get("final_generator")
    if final is not None:
        parts.append(gen.sleep(opts.get("recovery_time", 10)))
        parts.append(gen.clients(final))
    return parts[0] if len(parts) == 1 else gen.phases(*parts)


def _opts(p):
    p.add_argument("--workload", default=None,
                   help="Workload (default lock). "
                        + cli.one_of(WORKLOADS))
    p.add_argument("--rate", type=float, default=10)
    p.add_argument("--version", default=VERSION)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(hazelcast_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
