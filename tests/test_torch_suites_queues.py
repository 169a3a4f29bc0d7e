"""The port's disque, elasticsearch and rabbitmq suites against the JAX
package's, on the CPU: disque's job queue over disque-cli, elasticsearch's
dirty-read and set workloads over its HTTP API, and rabbitmq's mirrored
queue over rabbitmqadmin with its separate drain phase.

For each suite: the DB's command streams per node on the dummy remote;
the transport against the JAX test's in-memory fake (disque's broker,
elasticsearch's near-real-time index behind each package's own EsHttp,
rabbitmq's broker); each client's completions; the error classification
(each package's own RemoteError); whole clusterless runs, healthy and
with the JAX test's seeded bugs (lost jobs, lost and dirty writes, lost
and duplicated messages), recorded on each package and checked by both
with equal results; the builder, the command line, stored runs across
packages, and phase 28 at a small size. Every check is on the host, so
no kernel launches. Equality is exact: the results are verdicts and
counts.
"""

from __future__ import annotations

import pytest

import test_disque as tdq
import test_elasticsearch as tes
import test_rabbitmq as trq
from test_torch_suites_registry import (  # noqa: F401 (fixture)
    JAX, PORT, ROOTS, Raising, both_streams, clear_ip_caches, device_opts,
    help_options, make_test, op, outcome, parsed, phase_28, remote_error,
    run_checked_by_both, shape, small_specs, stored_across, suite)

SUITES = ("disque", "elasticsearch", "rabbitmq")


def disque_factory(state=None):
    """tests/test_disque.py's FakeCliFactory: replies are strings, so
    both packages share it."""
    state = state or tdq.FakeDisque()
    return lambda root: tdq.FakeCliFactory(state)


def es_factory(state=None):
    """tests/test_elasticsearch.py's FakeHttpFactory per package: root's
    own EsHttp, its request answered by the one fake."""
    state = state or tes.FakeEs()

    def for_root(root):
        def make(node, timeout=8.0):
            http = suite(root, "elasticsearch").EsHttp(node,
                                                       timeout=timeout)
            http.request = state.request
            return http

        make.state = state
        return make

    return for_root


def rabbit_factory(broker=None):
    """tests/test_rabbitmq.py's FakeAdminFactory: replies are strings,
    so both packages share it."""
    broker = broker or trq.FakeBroker()
    return lambda root: trq.FakeAdminFactory(broker)


# ---------------------------------------------------------------------------
# DB command streams
# ---------------------------------------------------------------------------

DBS = {
    "disque": (lambda s, r: s.DisqueDB("1.0-rc1"), tdq.responder),
    "elasticsearch": (lambda s, r: s.ElasticsearchDB("7.17.23"),
                      tes.responder),
    "rabbitmq": (lambda s, r: s.RabbitDB("3.8.9"), trq.responder),
}


@pytest.mark.parametrize("name", SUITES)
@pytest.mark.parametrize("method", ["setup", "teardown", "kill", "start"])
def test_db_command_stream(name, method):
    make_db, responder = DBS[name]
    calls = ([("setup", None)] if method == "setup"
             else [(method, "n2"), (method, "n1")])
    both_streams(name, make_db, calls, responder, prepare=True)


@pytest.mark.parametrize("name,cls,args", [
    ("disque", "DisqueCli", ("getjob", "nohang", "from", "jepsen")),
    ("rabbitmq", "RabbitAdmin", ("get", "queue=jepsen.queue"))])
def test_transport_command_line_alike(name, cls, args):
    got = {}
    for root in ROOTS:
        test = make_test(root, lambda node, a: "[]", ("n1", "n2"),
                         ssh={"dummy": True})
        t = getattr(suite(root, name), cls)(test, "n2", timeout=3)
        out = t.run(*args)
        got[root] = (out, [(a.cmd, a.stdin) for a in t.sess.log])
        t.close()
    assert got[PORT] == got[JAX]


# ---------------------------------------------------------------------------
# clients and transports
# ---------------------------------------------------------------------------

def _disque(root, c):
    return [outcome(c.invoke({}, op(root, f, v)))
            for f, v in (("dequeue", None), ("enqueue", 4), ("enqueue", 5),
                         ("dequeue", None), ("enqueue", 6),
                         ("drain", None), ("drain", None))]


def _rabbit(root, c):
    return [outcome(c.invoke({}, op(root, f, v)))
            for f, v in (("dequeue", None), ("enqueue", 4), ("enqueue", 5),
                         ("dequeue", None), ("enqueue", 6),
                         ("drain", None), ("drain", None))]


def _es_dirty(root, c):
    return [outcome(c.invoke({}, op(root, f, v)))
            for f, v in (("write", 3), ("read", 3), ("read", 4),
                         ("write", 3), ("strong-read", None),
                         ("refresh", None), ("strong-read", None))]


def _es_set(root, c):
    return [outcome(c.invoke({}, op(root, f, v)))
            for f, v in (("add", 4), ("add", 1), ("add", 4),
                         ("read", None))]


def test_disque_client_alike():
    got = {}
    for root in ROOTS:
        state = tdq.FakeDisque()
        c = suite(root, "disque").DisqueQueueClient(
            disque_factory(state)(root)).open({}, "n1")
        got[root] = (_disque(root, c), state.jobs, state.order)
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT][0]] == ["fail"] + ["ok"] * 6
    assert got[PORT][0][5][2] == [5, 6]


def test_rabbitmq_client_alike():
    got = {}
    for root in ROOTS:
        f = rabbit_factory()(root)
        c = suite(root, "rabbitmq").RabbitQueueClient(
            admin_factory=f).open({}, "n1")
        c.setup({})
        got[root] = (_rabbit(root, c), list(f.broker.q), f.declared)
    assert got[PORT] == got[JAX]
    assert got[PORT][0][5][:3] == ("ok", "drain", [5, 6])


@pytest.mark.parametrize("cls,script", [("EsDirtyReadClient", _es_dirty),
                                        ("EsSetClient", _es_set)])
def test_elasticsearch_client_alike(cls, script):
    got = {}
    for root in ROOTS:
        f = es_factory()(root)
        c = getattr(suite(root, "elasticsearch"), cls)(f).open({}, "n1")
        c.setup({})
        got[root] = (script(root, c), sorted(f.state.docs),
                     sorted(f.state.searchable))
    assert got[PORT] == got[JAX]
    assert all(o[0] in ("ok", "fail") for o in got[PORT][0])


@pytest.mark.parametrize("step", ["index", "get", "refresh", "search",
                                  "create", "duplicate"])
def test_elasticsearch_driver_alike(step):
    calls = {
        "index": lambda h: h.index_doc("sets", "7"),
        "get": lambda h: (h.index_doc("sets", "7"), h.get_doc("sets", "7"),
                          h.get_doc("sets", "8")),
        "refresh": lambda h: h.refresh("sets"),
        "search": lambda h: (h.index_doc("sets", "3"),
                             h.index_doc("sets", "12"), h.refresh("sets"),
                             h.search_ids("sets")),
        "create": lambda h: h.create_index("sets"),
        "duplicate": lambda h: (h.index_doc("sets", "3"),
                                h.index_doc("sets", "3")),
    }[step]
    got = {}
    for root in ROOTS:
        state = tes.FakeEs()
        requests = []
        real = state.request

        def recording(method, path, body=None, real=real,
                      requests=requests):
            requests.append((method, path, body))
            return real(method, path, body)

        state.request = recording
        got[root] = (calls(es_factory(state)(root)("n1")), requests)
    assert got[PORT] == got[JAX]


def test_elasticsearch_search_pages_alike():
    got = {}
    for root in ROOTS:
        state = tes.FakeEs()
        state.docs = {f"{i:06d}" for i in range(25)}
        state.searchable = set(state.docs)
        http = es_factory(state)(root)("n1")
        real = http.request

        def small_pages(method, path, body=None, real=real):
            if path.endswith("/_search") and body:
                body = dict(body, size=7)
            return real(method, path, body)

        http.request = small_pages
        got[root] = http.search_ids("sets")
    assert got[PORT] == got[JAX]
    assert len(got[PORT]) == 25


class Rejecting:
    """A disque CLI answering every command with a broker error."""

    def __call__(self, test, node, timeout=5.0):
        class _C:
            def run(self, *args):
                return "NOREPLICA Not enough reachable nodes"

            def close(self):
                pass

        return _C()


ERRORS = [
    ("disque", "enqueue", 7, "broken pipe", "info"),
    ("disque", "dequeue", None, "connection refused", "fail"),
    ("disque", "drain", None, "broken pipe", "info"),
    ("rabbitmq", "enqueue", 7, "conn refused", "info"),
    ("rabbitmq", "dequeue", None, "conn refused", "info"),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_client_error_classified_alike(case, monkeypatch):
    name, f, value, err, want = ERRORS[case]
    got = {}
    for root in ROOTS:
        s = suite(root, name)
        make = Raising(root, lambda r: remote_error(r, "broker down",
                                                    err=err))
        if name == "disque":
            c = s.DisqueQueueClient(make)
        else:
            c = s.RabbitQueueClient(admin_factory=make)
        got[root] = outcome(c.open({}, "n1").invoke({}, op(root, f, value)))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == want


def test_disque_broker_rejection_is_a_definite_fail_alike():
    got = {}
    for root in ROOTS:
        c = suite(root, "disque").DisqueQueueClient(Rejecting()).open(
            {}, "n1")
        got[root] = [outcome(c.invoke({}, op(root, f, v)))
                     for f, v in (("enqueue", 7), ("dequeue", None))]
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT]] == ["fail", "fail"]


def test_elasticsearch_errors_classified_alike():
    class Down:
        def request(self, method, path, body=None):
            raise TimeoutError("timed out")

    got = {}
    for root in ROOTS:
        c = suite(root, "elasticsearch").EsDirtyReadClient(
            es_factory(Down())(root)).open({}, "n1")
        got[root] = [outcome(c.invoke({}, op(root, f, v)))
                     for f, v in (("write", 1), ("read", 1),
                                  ("strong-read", None))]
    assert got[PORT] == got[JAX]
    assert [o[0] for o in got[PORT]] == ["info", "fail", "info"]


@pytest.mark.parametrize("pattern", [
    ["msg", "msg", "err", "err", "empty"],
    ["msg", "err", "err", "err", "err", "err"],
    ["msg", "msg", "empty"]])
def test_rabbitmq_drain_retries_alike(pattern, monkeypatch):
    got = {}
    for root in ROOTS:
        s = suite(root, "rabbitmq")
        monkeypatch.setattr(s, "time", type("T", (), {
            "sleep": staticmethod(lambda _s: None)}))
        calls = {"n": 0}

        class Scripted:
            def __call__(self, test, node, timeout=8.0, root=root):
                class _Admin:
                    def run(self, *args):
                        step = pattern[min(calls["n"], len(pattern) - 1)]
                        calls["n"] += 1
                        if step == "err":
                            raise remote_error(root, "conn reset",
                                               err="reset")
                        if step == "msg":
                            return '[{"payload": "%d"}]' % calls["n"]
                        return ""

                    def close(self):
                        pass

                return _Admin()

        c = s.RabbitQueueClient(admin_factory=Scripted()).open({}, "n1")
        got[root] = outcome(c.invoke({}, op(root, "drain")))
    assert got[PORT] == got[JAX]


# ---------------------------------------------------------------------------
# whole clusterless runs
# ---------------------------------------------------------------------------

class DisqueDropping(tdq.FakeDisque):
    """tests/test_disque.py's Dropping: every fifth job acked, then
    lost."""

    def run(self, *args):
        out = super().run(*args)
        if args[0].lower() == "addjob" and self.n % 5 == 0:
            with self.lock:
                jid = self.order.pop()
                self.jobs.pop(jid, None)
        return out


class DisqueLostAck(tdq.FakeDisque):
    """tests/test_disque.py's LostAck: every seventh ACK lost, the job
    redelivered (duplicated, never lost)."""

    def __init__(self):
        super().__init__()
        self.acks = 0

    def run(self, *args):
        if args[0].lower() == "ackjob":
            self.acks += 1
            if self.acks % 7 == 0:
                with self.lock:
                    if args[1] in self.jobs:
                        self.order.append(args[1])
                return "1"
        return super().run(*args)


class EsLossy(tes.FakeEs):
    """Every fifth acked write dropped."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def request(self, method, path, body=None):
        if "/_doc/" in path and method == "PUT":
            self.n += 1
            if self.n % 5 == 0:
                return 201, {"result": "created"}
        return super().request(method, path, body)


class EsDirty(tes.FakeEs):
    """Every fourth write times out, yet reads of it find it."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.phantom: set = set()

    def request(self, method, path, body=None):
        if "/_doc/" in path and method == "PUT":
            self.n += 1
            if self.n % 4 == 0:
                with self.lock:
                    self.phantom.add(path.split("/_doc/")[1].split("?")[0])
                raise TimeoutError("ack lost")
        if "/_doc/" in path and method == "GET" and \
                path.split("/_doc/")[1] in self.phantom:
            return 200, {"found": True}
        return super().request(method, path, body)


class RabbitLossy(trq.FakeBroker):
    def __init__(self):
        super().__init__()
        self.n = 0

    def publish(self, payload):
        self.n += 1
        if self.n % 10 == 0:
            return "Message published"
        return super().publish(payload)


N2 = {"nodes": ("n1", "n2"), "concurrency": 4, "stagger": 0.0004}
N3 = {"nodes": ("n1", "n2", "n3"), "concurrency": 6, "stagger": 0.0004}
RUNS = {
    "disque-queue": ("disque", "queue_workload", {"ops": 150},
                     "cli_factory", lambda r: disque_factory()(r), True,
                     N2),
    "disque-queue-lost": ("disque", "queue_workload", {"ops": 200},
                          "cli_factory",
                          lambda r: disque_factory(DisqueDropping())(r),
                          False, N2),
    "disque-queue-lost-ack": ("disque", "queue_workload", {"ops": 200},
                              "cli_factory",
                              lambda r: disque_factory(DisqueLostAck())(r),
                              None, N2),
    "elasticsearch-dirty-read": ("elasticsearch", "dirty_read_workload",
                                 {"ops": 300, "concurrency": 6, "seed": 11},
                                 "http_factory", lambda r: es_factory()(r),
                                 True, dict(N3, final=True)),
    "elasticsearch-dirty-read-lost": ("elasticsearch",
                                      "dirty_read_workload",
                                      {"ops": 300, "concurrency": 6,
                                       "seed": 11}, "http_factory",
                                      lambda r: es_factory(EsLossy())(r),
                                      False, dict(N3, final=True)),
    "elasticsearch-dirty-read-dirty": ("elasticsearch",
                                       "dirty_read_workload",
                                       {"ops": 400, "concurrency": 6,
                                        "seed": 11}, "http_factory",
                                       lambda r: es_factory(EsDirty())(r),
                                       False, dict(N3, final=True)),
    "elasticsearch-set": ("elasticsearch", "set_workload", {"ops": 80},
                          "http_factory", lambda r: es_factory()(r), True,
                          dict(N2, nodes=("n1",), final=True)),
    "rabbitmq-queue": ("rabbitmq", "queue_workload", {"ops": 200},
                       "admin_factory", lambda r: rabbit_factory()(r),
                       True, dict(N2, stagger=0.0003, final=True)),
    "rabbitmq-queue-lost": ("rabbitmq", "queue_workload", {"ops": 200},
                            "admin_factory",
                            lambda r: rabbit_factory(RabbitLossy())(r),
                            False, dict(N2, stagger=0.0003, final=True)),
}


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_checked_by_both(run, root):
    name, workload, opts, attr, factory, valid, kw = RUNS[run]
    if valid is None:
        # a redelivered job is duplicated, never lost: the verdict is
        # the duplicates', the loss count 0 on both packages
        from test_torch_suites_registry import (check_both, norm,
                                                run_workload,
                                                workload_checker)

        test = run_workload(root, name, workload, opts, attr, factory, **kw)
        port, jax = check_both(workload_checker(name, workload, opts), test)
        assert norm(port) == norm(jax)
        assert port["total-queue"]["lost-count"] == 0
        return
    res = run_checked_by_both(root, name, workload, opts, attr, factory,
                              valid, **kw)
    if run.endswith("-lost") and name != "elasticsearch":
        assert res["total-queue"]["lost-count"] > 0
    if run == "elasticsearch-dirty-read-dirty":
        assert res["dirty-count"] > 0


# ---------------------------------------------------------------------------
# builders, command lines, stored runs, phase 28
# ---------------------------------------------------------------------------

BUILDERS = {"disque": "disque_test", "elasticsearch": "elasticsearch_test",
            "rabbitmq": "rabbitmq_test"}
OPTS = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
        "ssh": {"dummy": True}, "time_limit": 1, "seed": 1}


@pytest.mark.parametrize("name,workload", [
    ("disque", None), ("disque", "queue"), ("elasticsearch", None),
    ("elasticsearch", "set"), ("rabbitmq", "queue")])
def test_builder_shape_equal(name, workload):
    opts = dict(OPTS, **({"workload": workload} if workload else {}))
    tests = {root: getattr(suite(root, name), BUILDERS[name])(
        device_opts(root, opts)) for root in ROOTS}
    assert shape(tests[PORT]) == shape(tests[JAX])
    assert list(suite(PORT, name).WORKLOADS) == \
        list(suite(JAX, name).WORKLOADS)


@pytest.mark.parametrize("name", SUITES)
def test_command_line_options(name):
    port, jax = help_options(PORT, name), help_options(JAX, name)
    assert sorted(set(port) - {"--device"}) == sorted(set(jax))
    argv = ["--nodes", "n1,n2", "--time-limit", "3", "--no-ssh",
            "--rate", "40"]
    got = parsed(PORT, name, argv + ["--device", "cpu"])
    want = parsed(JAX, name, argv)
    assert got.pop("device") == "cpu"
    assert got == want


@pytest.mark.parametrize("writer", ROOTS)
@pytest.mark.parametrize("run", sorted(small_specs(SUITES)))
def test_stored_run_analysed_by_both(run, writer, tmp_path):
    stored_across(writer, small_specs(SUITES)[run], tmp_path)


def test_phase_28_queue_runs_at_a_small_size(monkeypatch):
    launches = phase_28(SUITES, monkeypatch)
    assert launches == {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
