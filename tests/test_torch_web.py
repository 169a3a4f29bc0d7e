"""The port's web UI (web.py) against the JAX package's on the CPU.

Both packages' servers (web.serve on 127.0.0.1, port 0) serve the same
store: a register run stored by the port's `test` subcommand with the
node probe on, its twin with one read corrupted (analysed by the port's
`analyze`, invalid, so its page lists the counterexample), and a run the
JAX package's `test` stored, with the coverage atlas those runs left.
Every page and route must answer with the same status, content type and
bytes: the home page, a run's file listing and page, results.json, the
telemetry page, the live page and its event stream, the Perfetto export
(with and without an op filter), the coverage heatmap and a cell,
/metrics, the zip and the 404s. The port's own name (`python -m
jepsen_tpu_torch`) is read as the JAX package's. The run page's lint
panel is set aside in that comparison: each package's report reads its
own kernels, so /lint and the panel are tested on the port alone (the
port's report, gated against lint-baseline-torch.json).

Counterparts of test_cli.py::test_web_ui, test_fleet.py::TestServerE2E::
test_fleet_page_and_metrics, the web half of test_flightrec.py::
TestRenderers and test_chaos.py::TestRecoverableFlag."""

from __future__ import annotations

import importlib
import json
import os
import shutil
import socket
import time
import urllib.error
import urllib.request

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PORT = "jepsen_tpu_torch"


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def as_jax(b: bytes) -> bytes:
    return b.replace(b"jepsen_tpu_torch", b"jepsen_tpu")


@pytest.fixture(autouse=True)
def clear_ip_caches():
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()
    yield
    for root in ROOTS:
        mod(root, "net").clear_ip_cache()


def get(port, path):
    """(status, content type, body) of GET path."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture
def servers(tmp_path):
    """Starts each package's web server over a base; yields a starter."""
    started = []

    def start(base):
        out = {}
        for root in ROOTS:
            srv = mod(root, "web").serve("127.0.0.1", 0, base=base)
            started.append(srv)
            out[root] = srv.server_address[1]
        return out

    yield start
    for srv in started:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# test_cli.py::test_web_ui
# ---------------------------------------------------------------------------

def test_web_ui(tmp_path, servers):
    d = tmp_path / "store" / "demo" / "20260729T000000.0000"
    d.mkdir(parents=True)
    (d / "results.json").write_text('{"valid?": true}')
    (d / "jepsen.log").write_text("hello log")
    ports = servers(tmp_path / "store")
    rel = "demo/20260729T000000.0000"
    paths = ["/", f"/files/{rel}/results.json", f"/files/{rel}/",
             f"/zip/{rel}", f"/telemetry/{rel}", "/nope", "/files/nope"]
    before = {r: [get(p, path) for path in paths] for r, p in
              ports.items()}
    assert before[PORT] == before["jepsen_tpu"]
    home = before[PORT][0][2].decode()
    assert "demo" in home and "20260729T000000.0000" in home
    assert json.loads(before[PORT][1][2])["valid?"] is True
    assert "jepsen.log" in before[PORT][2][2].decode()
    assert before[PORT][3][2][:2] == b"PK"
    assert before[PORT][4][0] == 404
    (d / "telemetry.jsonl").write_text(
        '{"id": 1, "parent": null, "name": "run", "t0": 0, '
        '"t1": 5000000}\n')
    (d / "metrics.json").write_text(
        '{"spans": {}, "counters": {"wgl.kernel.launches": 2}, '
        '"gauges": {}}')
    after = {r: [get(p, path) for path in paths] for r, p in
             ports.items()}
    assert after[PORT] == after["jepsen_tpu"]
    page = after[PORT][4][2].decode()
    assert "run" in page and "wgl.kernel.launches" in page
    assert "5.0ms" in page
    assert "/telemetry/demo/" in after[PORT][0][2].decode()
    # raw-socket path traversal (urllib would normalize ..)
    for port in ports.values():
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.sendall(b"GET /files/../../../etc/passwd HTTP/1.0\r\n"
                      b"Host: x\r\n\r\n")
            reply = s.makefile("rb").read().decode()
        assert "404" in reply.splitlines()[0]
        assert "root:" not in reply


# ---------------------------------------------------------------------------
# every page over a store of real runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store_base(tmp_path_factory):
    """A store holding a port run, its corrupted twin analysed by the
    port (invalid) and a JAX run, written by each package's command
    line; returns (base, {name: rel})."""
    import chip_smoke as cs
    import test_torch_cli as tc

    work = tmp_path_factory.mktemp("web")
    args = ["test", "--workload", "register", "--no-ssh",
            "--time-limit", "3", "--ops", "120", "--nodes", "n1,n2,n3",
            "--nodeprobe-interval", "0.2"]
    runs = {}
    for root in ROOTS:
        for r in ROOTS:
            mod(r, "net").clear_ip_cache()
        code, _ = tc.main(root, tc.port_argv(root, list(args)), cwd=work)
        assert code == 0
        runs[root] = (work / "store" / "register-demo" / "latest"
                      ).resolve()
        time.sleep(0.01)  # distinct run directory names
    src = runs[PORT]
    twin = src.parent / (src.name + "-twin")
    cs.cli_twin(src, twin)
    code, _ = tc.main(PORT, ["analyze", str(twin), "--device", "cpu"],
                      cwd=work)
    assert code == 1
    for r in ROOTS:
        mod(r, "net").clear_ip_cache()
    base = work / "store"
    rels = {"port": str(src.relative_to(base)),
            "jax": str(runs["jepsen_tpu"].relative_to(base)),
            "twin": str(twin.relative_to(base))}
    return base, rels


@pytest.fixture
def no_lint_panel(monkeypatch):
    """Sets the run page's lint panel aside in both packages (the JAX
    panel starts a lint trace in the background)."""
    for root in ROOTS:
        monkeypatch.setattr(mod(root, "web"), "lint_panel_html",
                            lambda: "")


def route_list(rels):
    out = ["/", "/coverage", "/coverage/", "/coverage/none/register",
           "/coverage/partition/bank", "/fleet", "/nope", "/zip/nope",
           "/telemetry/nope", "/trace/nope", "/live/nope",
           "/metrics?run=nope"]
    for rel in rels.values():
        out += [f"/files/{rel}/", f"/files/{rel}",
                f"/files/{rel}/results.json",
                f"/files/{rel}/timeline.html", f"/files/{rel}/nodes.jsonl",
                f"/files/{rel}/history.jlog", f"/telemetry/{rel}",
                f"/telemetry/{rel}/", f"/live/{rel}", f"/trace/{rel}",
                f"/trace/{rel}?ops=1,2,3,x", f"/metrics?run={rel}",
                f"/zip/{rel}"]
    return out


def test_every_page_equal_over_the_same_store(store_base, servers,
                                              no_lint_panel):
    base, rels = store_base
    ports = servers(base)
    for path in route_list(rels):
        got = {r: get(p, path) for r, p in ports.items()}
        status, ctype, body = got[PORT]
        assert (status, ctype, as_jax(body)) == got["jepsen_tpu"], path
    # the twin's page lists its counterexample with trace links
    page = get(ports[PORT], f"/files/{rels['twin']}/")[2].decode()
    assert "<h2>anomalies</h2>" in page and "?ops=" in page
    assert "<h2>nodes</h2>" in page and "search explorer" in page


def test_live_event_streams_equal(store_base, servers):
    base, rels = store_base
    ports = servers(base)
    for name, rel in rels.items():
        bodies = [get(p, f"/live/{rel}?events=1")
                  for p in ports.values()]
        assert bodies[1] == bodies[0]
        status, ctype, body = bodies[1]
        assert status == 200 and ctype == "text/event-stream"
        # the twin is a copy without the monitor's time series
        assert (body.count(b"data: {\"t\"") >= 1) is (name != "twin")
        assert body.endswith(b"event: end\ndata: {}\n\n")


def test_lint_page_and_panel(store_base, servers):
    """Counterpart of test_lint.py::test_web_lint_page_and_panel over
    the port's server: /lint answers 200 (HTML, ?json=1, ?refresh=1)
    with the port's report gated against its baseline, and the run
    page shows one graftlint panel, from the cached report."""
    web = mod(PORT, "web")
    web._lint_cache.clear()
    base, rels = store_base
    port = servers(base)[PORT]
    status, ctype, body = get(port, "/lint?json=1")
    assert status == 200 and ctype == "application/json"
    doc = json.loads(body)
    assert doc["ratchet"]["new"] == [] and doc["ratchet"]["stale"] == []
    assert {t["kernel"] for t in doc["traces"]} >= {"wgl", "scc",
                                                    "bank_reduce"}
    for path in ("/lint", "/lint/", "/lint?refresh=1"):
        status, ctype, body = get(port, path)
        assert status == 200 and ctype.startswith("text/html")
        page = body.decode()
        assert "graftlint" in page and "R1" in page
        assert "doc/static-analysis-torch.md" in page
    page = get(port, f"/files/{rels['port']}/")[2].decode()
    assert page.count("<h2>graftlint</h2>") == 1
    assert "finding(s)</a>" in page and "baseline: ok" in page
    home = get(port, "/")[2].decode()
    assert "<a href='/lint'>graftlint</a>" in home


def test_lint_panel_warms_in_the_background():
    """A run page never waits for the lint: a cold cache gives the
    warming placeholder and starts one background compute."""
    web = mod(PORT, "web")
    web._lint_cache.clear()
    panel = web.lint_panel_html()
    assert "warming" in panel and "/lint" in panel
    deadline = time.monotonic() + 120
    while web._lint_cache.get("rep") is None:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    panel = web.lint_panel_html()
    assert "unsharded axes 0" in panel and "baseline: ok" in panel


@pytest.mark.parametrize("fn", ["home_html", "fast_tests"])
def test_page_functions_equal(store_base, fn):
    base, _rels = store_base
    want = getattr(mod("jepsen_tpu", "web"), fn)(base)
    got = getattr(mod(PORT, "web"), fn)(base)
    assert got == want


def test_coverage_pages_equal(store_base):
    base, _rels = store_base
    cells = [mod(r, "web")._atlas_cells(base) for r in ROOTS]
    assert cells[1] == cells[0] and cells[1]
    wls = list(mod(PORT, "workloads").REGISTRY)
    for root_fn in ("coverage_html",):
        want = getattr(mod("jepsen_tpu", "web"), root_fn)(cells[0], wls)
        got = getattr(mod(PORT, "web"), root_fn)(cells[1], wls)
        assert got == want
    for k, w, _a in sorted(cells[1]):
        assert mod(PORT, "web").coverage_cell_html(cells[1], k, w) == \
            mod("jepsen_tpu", "web").coverage_cell_html(cells[0], k, w)


def test_anomaly_search_and_certificate_indexes_equal(store_base):
    base, rels = store_base
    for rel in rels.values():
        res = json.loads((base / rel / "results.json").read_text())
        for fn in ("anomaly_index", "search_index"):
            assert getattr(mod(PORT, "web"), fn)(res) == getattr(
                mod("jepsen_tpu", "web"), fn)(res)
        assert mod(PORT, "web").certificate_rows(res) == mod(
            "jepsen_tpu", "web").certificate_rows(res)


# ---------------------------------------------------------------------------
# the fleet page (test_fleet.py::TestServerE2E, test_flightrec.py)
# ---------------------------------------------------------------------------

def test_fleet_page_and_metrics(tmp_path):
    import test_torch_fleet as tf

    for p in tf.PKGS:
        web = p.m("web")
        base = tmp_path / p.root / "store"
        assert "no fleet server" in web.fleet_html(base)
        srv = p.server(base / "fleet").start()
        try:
            tf.stream(p, srv.addr, "acme", "r1", p.hist(1, 100))
            html = web.fleet_html(base)
            assert "acme" in html and "verdicts" in html
            st, addr = web._fleet_stats(base)
            assert st is not None
            text = p.m("fleet.server").prometheus_from_stats(st)
            assert 'tenant="acme"' in text
        finally:
            srv.stop()
    # the same stats render the same page in both packages
    st = json.loads(json.dumps(st))
    pages = []
    for root in ROOTS:
        web = mod(root, "web")
        real = web._fleet_stats
        web._fleet_stats = lambda base: (st, "127.0.0.1:1")
        try:
            pages.append(web.fleet_html(tmp_path))
        finally:
            web._fleet_stats = real
    assert pages[1] == pages[0]
    assert as_jax(mod(PORT, "web").fleet_html(tmp_path / "none").encode()
                  ) == mod("jepsen_tpu", "web").fleet_html(
        tmp_path / "none").encode()


def test_fleet_sections_with_quarantine_and_breaker():
    st = {"runs": 3, "active_streams": 1, "verdicts": 2, "rejected": 1,
          "recovered": 1,
          "scheduler": {"launches": 4, "items": 9, "breaker_open": True,
                        "quarantine": [{"tenant": "t<1>", "run": "r",
                                        "probes": 2,
                                        "error": "boom " * 40}]},
          "tenants": {"t<1>": {"streams": 1, "chunks": 4, "ops": 300}},
          "streams": {"t<1>/r": {"state": "open", "checked-frac": 0.5,
                                 "ops": 120}},
          "flightrec": {"enabled": False}}
    pages = []
    for root in ROOTS:
        web = mod(root, "web")
        real = web._fleet_stats
        web._fleet_stats = lambda base: (st, "h:1")
        try:
            pages.append(web.fleet_html(None))
        finally:
            web._fleet_stats = real
    assert pages[1] == pages[0]
    assert "device breaker OPEN" in pages[1] and "t&lt;1&gt;" in pages[1]


def test_web_event_payload_and_section():
    import test_torch_cli as tc

    for root in ROOTS:
        web = mod(root, "web")
        st = tc.stats_fixture(root)
        payload = web.fleet_event_payload(st)
        assert payload["enabled"] is True
        assert payload["launches"] == 1
        assert payload["occupancy"]["final"] == pytest.approx(
            4 / 64, abs=1e-4)
        assert json.loads(json.dumps(payload)) == payload
        assert web.fleet_event_payload({}) == {"enabled": False}
        html = web._flightrec_html(st["flightrec"])
        assert "flight recorder" in html and "EventSource" in html
        assert "disabled" in web._flightrec_html({"enabled": False})
    sts = [tc.stats_fixture(r) for r in ROOTS]
    assert (mod(PORT, "web").fleet_event_payload(sts[1])
            == mod("jepsen_tpu", "web").fleet_event_payload(sts[0]))
    assert (mod(PORT, "web")._flightrec_html(sts[1]["flightrec"])
            == mod("jepsen_tpu", "web")._flightrec_html(
                sts[0]["flightrec"]))


# ---------------------------------------------------------------------------
# test_chaos.py::TestRecoverableFlag
# ---------------------------------------------------------------------------

def test_live_pid_suppresses_recoverable(tmp_path):
    td = tmp_path / "demo" / "t1"
    td.mkdir(parents=True)
    (td / "history.jlog").write_text("x")
    old = time.time() - 3600
    os.utime(td / "history.jlog", (old, old))
    for pid, want in ((str(os.getpid()), False), ("999999999", True),
                      (None, True)):
        if pid is None:
            (td / "run.pid").unlink()
        else:
            (td / "run.pid").write_text(pid)
        got = [mod(r, "web")._looks_recoverable(td) for r in ROOTS]
        assert got == [want, want]
    # a run still writing is live, not recoverable
    (td / "history.jlog").write_text("xy")
    assert [mod(r, "web")._looks_recoverable(td) for r in ROOTS] == [
        False, False]
    shutil.rmtree(td)
    td.mkdir()
    assert [mod(r, "web")._looks_recoverable(td) for r in ROOTS] == [
        False, False]


def test_run_writes_pid_marker(tmp_path):
    from jepsen_tpu_torch import checker, core, store, testing
    from jepsen_tpu_torch import generator as gen

    state = testing.AtomState()
    test = testing.noop_test()
    test.update(name="pid-marker", store_base=str(tmp_path),
                nodes=["n1", "n2"], concurrency=2,
                db=testing.AtomDB(state),
                client=testing.AtomClient(state),
                checker=checker.compose({"stats": checker.stats()}),
                generator=gen.clients(gen.limit(8, lambda: {"f": "read"})))
    t = core.run(test)
    d = store.path(t)
    assert int((d / "run.pid").read_text()) == os.getpid()
    flags = mod(PORT, "web").fast_tests(tmp_path)
    assert flags == mod("jepsen_tpu", "web").fast_tests(tmp_path)
    assert flags[0]["flags"] == [] and flags[0]["valid"] is True
