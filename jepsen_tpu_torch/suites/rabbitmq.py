"""RabbitMQ test suite: a mirrored durable queue checked for message
conservation (enqueue/dequeue/drain -> total-queue).

Capability reference: rabbitmq/src/jepsen/rabbitmq.clj — DB: deb
install + shared erlang cookie + stop_app/join_cluster/start_app into
the primary with a synchronize barrier between phases, ha-mode
mirroring policy on "jepsen." queues (25-99); client: declare a
durable queue, enqueue with publisher confirms, dequeue where an empty
queue or timeout is a :fail (re-delivery makes that sound), and a
drain that loops dequeues until empty (103-174); checked with
total-queue (the reference wires checker/total-queue in its test).
The reference links the langohr AMQP client into the JVM; here ops go
through `rabbitmqadmin -f raw_json` on the node (management plugin),
keeping the control host driver-free like the zookeeper/postgres
suites.

The port's copy of jepsen_tpu/suites/rabbitmq.py: the same host code, with
opts["device"] (None, the card, or "cpu") passed to every checker it
builds.
"""

from __future__ import annotations

import json
import logging
import time

from .. import checker as chk
from .. import cli, client as jclient, control, core, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import testing
from ..control import util as cu
from ..control.core import RemoteError
from ..core import primary
from ..os_setup import debian

logger = logging.getLogger(__name__)

VERSION = "3.8.9"
QUEUE = "jepsen.queue"
COOKIE = "jepsen-rabbitmq"
ADMIN = "/usr/local/bin/rabbitmqadmin"
MGMT_PORT = 15672
LOGFILE = "/var/log/rabbitmq/rabbit.log"


class RabbitDB(jdb.DB):
    """deb-installed rabbit joined into one mirrored cluster
    (rabbitmq.clj db, 25-99)."""

    supports_kill = True

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        logger.info("%s installing rabbitmq %s", node, self.version)
        deb = f"rabbitmq-server_{self.version}-1_all.deb"
        url = (f"https://github.com/rabbitmq/rabbitmq-server/releases/"
               f"download/v{self.version}/{deb}")
        with control.su():
            debian.install(["erlang-nox"])
            path = cu.cached_wget(url)
            # apt resolves the deb's dependencies, unlike bare dpkg -i
            control.exec_("apt-get", "install", "-y", path)
            # Same erlang cookie everywhere, set before clustering
            control.exec_("service", "rabbitmq-server", "stop",
                          check=False)
            control.exec_("sh", "-c",
                          "echo " + COOKIE +
                          " > /var/lib/rabbitmq/.erlang.cookie")
            control.exec_("chmod", "400",
                          "/var/lib/rabbitmq/.erlang.cookie")
            control.exec_("chown", "rabbitmq:rabbitmq",
                          "/var/lib/rabbitmq/.erlang.cookie")
            control.exec_("service", "rabbitmq-server", "start")
            control.exec_("rabbitmq-plugins", "enable",
                          "rabbitmq_management")
            # The management plugin serves its own CLI; the deb does
            # not ship rabbitmqadmin on PATH
            cu.await_tcp_port(MGMT_PORT, timeout_secs=60)
            control.exec_("wget", "-q", "-O", ADMIN,
                          f"http://localhost:{MGMT_PORT}"
                          f"/cli/rabbitmqadmin")
            control.exec_("chmod", "+x", ADMIN)
            if node != primary(test):
                control.exec_("rabbitmqctl", "stop_app")
        # everyone's daemon is up (or stopped-app) before joins begin
        core.synchronize(test)
        with control.su():
            if node != primary(test):
                logger.info("%s joining %s", node, primary(test))
                control.exec_("rabbitmqctl", "join_cluster",
                              f"rabbit@{primary(test)}")
                control.exec_("rabbitmqctl", "start_app")
        core.synchronize(test)
        with control.su():
            # Mirror jepsen. queues across a majority with auto sync
            control.exec_(
                "rabbitmqctl", "set_policy", "ha-maj", "jepsen.",
                '{"ha-mode": "exactly", "ha-params": 3, '
                '"ha-sync-mode": "automatic"}')
        logger.info("%s rabbit ready", node)

    def teardown(self, test, node):
        logger.info("%s nuking rabbit", node)
        with control.su():
            control.exec_("killall", "-9", "beam.smp", "epmd",
                          check=False)
            control.exec_("rm", "-rf", "/var/lib/rabbitmq/mnesia/")
            control.exec_("service", "rabbitmq-server", "stop",
                          check=False)

    def kill(self, test, node):
        with control.su():
            control.exec_("killall", "-9", "beam.smp", check=False)
        return "killed"

    def start(self, test, node):
        with control.su():
            control.exec_("service", "rabbitmq-server", "start")
        return "started"

    def log_files(self, test, node):
        return [LOGFILE]


# ---------------------------------------------------------------------------
# Client over rabbitmqadmin
# ---------------------------------------------------------------------------

class RabbitAdmin:
    """Runs rabbitmqadmin on the node; split out so tests can stub
    `run`."""

    def __init__(self, test, node, timeout: float = 8.0):
        self.test = test
        self.node = node
        self.timeout = timeout
        self.sess = control.session(test, node)

    def run(self, *args) -> str:
        with control.with_session(self.test, self.node, self.sess):
            return control.exec_(ADMIN, "-f", "raw_json", *args,
                                 timeout=self.timeout)

    def close(self):
        control.disconnect(self.sess)


class RabbitQueueClient(jclient.Client):
    """Queue ops (rabbitmq.clj QueueClient, 128-174): enqueue is a
    routed-checked publish; dequeue fetches with ack_requeue_false
    (an EMPTY reply is a definite :fail, an errored request :info —
    the server may have consumed the message before the reply was
    lost); drain loops until :empty, keeping collected values even if
    a later fetch errors."""

    def __init__(self, admin_factory=RabbitAdmin):
        self.admin_factory = admin_factory
        self.admin = None

    def open(self, test, node):
        c = RabbitQueueClient(self.admin_factory)
        c.admin = self.admin_factory(test, node)
        return c

    def setup(self, test):
        self.admin.run("declare", "queue", f"name={QUEUE}",
                       "durable=true", "auto_delete=false")
        return self

    def close(self, test):
        if self.admin is not None:
            self.admin.close()

    def _dequeue(self, op):
        out = self.admin.run("get", f"queue={QUEUE}",
                             "ackmode=ack_requeue_false", "count=1")
        msgs = json.loads(out) if out.strip() else []
        if not msgs:
            return op.copy(type="fail", error="empty")
        return op.copy(type="ok", value=int(msgs[0]["payload"]))

    def invoke(self, test, op):
        values = []  # survives a drain that dies mid-loop
        try:
            if op.f == "enqueue":
                out = self.admin.run("publish",
                                     "exchange=amq.default",
                                     f"routing_key={QUEUE}",
                                     f"payload={int(op.value)}")
                # rabbitmqadmin exits 0 even when the message routed
                # nowhere ("Message published but NOT routed"): that
                # message was never enqueued — a definite :fail, not
                # a spurious total-queue loss
                if "not routed" in out.lower():
                    return op.copy(type="fail", error="not routed")
                return op.copy(type="ok")
            if op.f == "dequeue":
                return self._dequeue(op)
            if op.f == "drain":
                # Transient fetch errors must not end the drain as
                # :ok — messages left in the queue would read as lost.
                # Retry (up to 5 CONSECUTIVE failures; post-heal
                # drains make errors rare). But any errored get may
                # also have consumed a message whose reply was lost
                # (ack_requeue_false removes server-side), so a drain
                # that saw ANY error is indeterminate: complete :info
                # keeping fetched values (acked messages are really
                # gone) so the conservation checker sees an aborted
                # drain, never a definite empty-queue claim.
                consecutive, any_error, last_err = 0, False, ""
                while True:
                    try:
                        r = self._dequeue(op)
                    except RemoteError as e:
                        consecutive += 1
                        any_error = True
                        last_err = (f"{e.err or ''} "
                                    f"{e.out or ''}").strip()[:200]
                        if consecutive >= 5:
                            return op.copy(type="info", value=values,
                                           error=last_err)
                        time.sleep(0.2 * consecutive)
                        continue
                    consecutive = 0
                    if r.type != "ok":
                        if any_error:
                            return op.copy(type="info", value=values,
                                           error=last_err)
                        return op.copy(type="ok", value=values)
                    values.append(r.value)
            raise ValueError(f"unknown f {op.f!r}")
        except RemoteError as e:
            err = f"{e.err or ''} {e.out or ''}".strip()[:200]
            if op.f == "dequeue":
                # get-with-ack REMOVES the message when the server
                # processes the request, so a lost response may have
                # consumed one: indeterminate, never a definite :fail
                return op.copy(type="info", error=err)
            # an unconfirmed publish may still have landed
            return op.copy(type="info", error=err)


# ---------------------------------------------------------------------------
# Test
# ---------------------------------------------------------------------------

def queue_workload(opts: dict) -> dict:
    """Enqueue/dequeue mix + a drain kept as a SEPARATE phase, so the
    test can heal the network before draining (the workload bundle in
    workloads/queue.py runs drain immediately after the mix; under a
    nemesis the drain must come after recovery or conservation fails
    spuriously on still-partitioned messages)."""
    import itertools

    counter = itertools.count()
    mix = gen.mix([lambda: {"f": "enqueue", "value": next(counter)},
                   lambda: {"f": "dequeue", "value": None}])
    return {
        "client": RabbitQueueClient(),
        "mix": gen.limit(opts.get("ops", 500), mix),
        "drain": gen.each_thread(gen.once(
            lambda: {"f": "drain", "value": None})),
        "checker": chk.compose({"total-queue": chk.total_queue(),
                                "stats": chk.stats()}),
    }


WORKLOADS = {"queue": queue_workload}


def rabbitmq_test(opts: dict) -> dict:
    name = opts.get("workload", "queue")
    w = WORKLOADS[name](opts)
    test = testing.noop_test()
    test.update(
        name=f"rabbitmq-{name}",
        os=debian.os,
        db=RabbitDB(opts.get("version", VERSION)),
        ssh=opts["ssh"],
        nodes=opts["nodes"],
        concurrency=opts["concurrency"],
        client=w["client"],
        nemesis=jnemesis.partition_random_halves(),
        checker=chk.compose({"workload": w["checker"],
                             "perf": chk.perf(),
                             "timeline": chk.timeline()}),
        generator=gen.phases(
            gen.time_limit(
                opts.get("time_limit", 30),
                gen.clients(
                    gen.stagger(1.0 / opts.get("rate", 20),
                                w["mix"]),
                    jnemesis.start_stop_cycle(10.0))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(opts.get("recovery_time", 5)),
            gen.clients(w["drain"])))
    return test


def _opts(p):
    p.add_argument("--workload", default="queue",
                   help="Workload. " + cli.one_of(WORKLOADS))
    p.add_argument("--version", default=VERSION,
                   help="rabbitmq-server version to install.")
    p.add_argument("--rate", type=float, default=20)
    return p


def main(argv=None) -> None:
    commands = {}
    commands.update(cli.single_test_cmd(rabbitmq_test,
                                        parser_fn=_opts))
    commands.update(cli.serve_cmd())
    cli.run_cli(commands, argv)


if __name__ == "__main__":
    main()
