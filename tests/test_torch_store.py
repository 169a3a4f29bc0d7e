"""The port's run store against the JAX package's: store/format.py (the
history log and its sidecar index, the lazy chunked view, the bulk
writer, partial results, the native codec) and store/__init__.py (run
directories, three-phase saves, the per-test log, load and browse), as
in tests/test_store.py.

Each package writes, and each reads what the other wrote: the bytes of
history.jlog, its .idx and results.partial.jlog must be equal for the
same ops, and every reader must give back the same ops. All comparisons
are exact.
"""

from __future__ import annotations

import importlib
import json
import logging
import struct
import zlib

import pytest

ROOTS = ("jepsen_tpu", "jepsen_tpu_torch")
PAIRS = [(w, r) for w in ROOTS for r in ROOTS]


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def fmt(root):
    return mod(root, "store.format")


def ops_of(root, n=50, value=lambda i: {"k": [i, "x"]}):
    op = mod(root, "history").op
    return [op(index=i, time=i * 10, type=("invoke", "ok")[i % 2],
               process=i % 3, f="write", value=value(i)) for i in range(n)]


def fields(ops):
    return [o.to_dict() for o in ops]


def write_log(root, path, n=50, chunk_size=4096):
    w = fmt(root).HistoryWriter(path, chunk_size=chunk_size)
    for o in ops_of(root, n):
        w.append(o)
    w.close()
    return path


# ---------------------------------------------------------------------------
# store/format.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 4096])
def test_history_writer_bytes_equal(tmp_path, chunk):
    j = write_log("jepsen_tpu", tmp_path / "j.jlog", 100, chunk)
    p = write_log("jepsen_tpu_torch", tmp_path / "p.jlog", 100, chunk)
    assert p.read_bytes() == j.read_bytes()
    assert fmt("jepsen_tpu_torch").index_path(p).read_bytes() == \
        fmt("jepsen_tpu").index_path(j).read_bytes()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_history_log_read_across(tmp_path, writer, reader):
    p = write_log(writer, tmp_path / "history.jlog", 100, chunk_size=16)
    f = fmt(reader)
    want = fields(ops_of(reader, 100))
    assert fields(f.read_ops(p)) == want
    assert fields(f.read_history(p)) == want
    lazy = f.read_history_lazy(p)
    assert len(lazy) == 100 and fields(lazy) == want
    assert lazy[-1].to_dict() == want[-1]
    assert f._read_index(p) == fmt(writer)._read_index(p)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_write_history_read_across(tmp_path, writer, reader):
    p = tmp_path / "history.jlog"
    fmt(writer).write_history(p, ops_of(writer, 1000), chunk_size=128)
    lazy = fmt(reader).read_history_lazy(p)
    assert len(lazy) == 1000
    assert fields(lazy) == fields(ops_of(reader, 1000))
    assert len(fmt(reader)._read_index(p)) == 1000 // 128


def test_write_history_bytes_native_and_python(tmp_path, monkeypatch):
    """The bulk writer frames through the C codec when it builds, else
    in Python: the same bytes either way, and the JAX package's."""
    from jepsen_tpu_torch import native

    j = tmp_path / "j.jlog"
    fmt("jepsen_tpu").write_history(j, ops_of("jepsen_tpu", 300), 64)
    a = tmp_path / "a.jlog"
    fmt("jepsen_tpu_torch").write_history(a, ops_of("jepsen_tpu_torch",
                                                    300), 64)
    monkeypatch.setattr(native, "jlog", lambda: None)
    b = tmp_path / "b.jlog"
    fmt("jepsen_tpu_torch").write_history(b, ops_of("jepsen_tpu_torch",
                                                    300), 64)
    assert a.read_bytes() == b.read_bytes() == j.read_bytes()
    assert (tmp_path / "a.jlog.idx").read_bytes() == \
        (tmp_path / "j.jlog.idx").read_bytes()


@pytest.mark.parametrize("damage", ["torn", "crc"])
@pytest.mark.parametrize("writer,reader", PAIRS)
def test_recovery_read_across(tmp_path, writer, reader, damage):
    p = write_log(writer, tmp_path / "history.jlog", 10)
    with open(p, "r+b") as f:
        if damage == "torn":
            f.truncate(p.stat().st_size - 5)
        else:
            f.seek(-2, 2)
            f.write(b"XX")
    got = list(fmt(reader).read_ops(p))
    assert len(got) == 9
    assert fmt(reader)._valid_prefix_end(p) == \
        fmt(writer)._valid_prefix_end(p)


@pytest.mark.parametrize("writer,reopener", PAIRS)
def test_reopen_truncates_torn_tail(tmp_path, writer, reopener):
    p = write_log(writer, tmp_path / "history.jlog", 10)
    with open(p, "r+b") as f:
        f.truncate(p.stat().st_size - 5)
    w2 = fmt(reopener).HistoryWriter(p)
    w2.append(mod(reopener, "history").op(index=100, type="ok", process=1,
                                          f="read", value=100))
    back = w2.read_back()
    assert len(back) == 10 and back[-1].value == 100


@pytest.mark.parametrize("root", ROOTS)
def test_reopen_bad_magic_restarts(tmp_path, root):
    p = tmp_path / "history.jlog"
    p.write_bytes(b"garbage")
    w = fmt(root).HistoryWriter(p)
    w.append(mod(root, "history").op(index=0, type="ok", process=0,
                                     f="read", value=1))
    assert [o.value for o in w.read_back()] == [1]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_lazy_history_across(tmp_path, writer, reader):
    p = write_log(writer, tmp_path / "history.jlog", 40, chunk_size=8)
    f = fmt(reader)
    lazy = f.read_history_lazy(p)
    lazy[5]
    assert len(lazy._cache) == 1  # only one chunk decoded
    # a crash tears the tail back into the 4th chunk
    with open(p, "r+b") as fh:
        fh.truncate(f._read_index(p)[3][1] + 7)
    lazy = f.read_history_lazy(p)
    assert len(lazy) == 32
    assert [o.value for o in lazy] == [o.value for o in
                                      ops_of(reader, 32)]


@pytest.mark.parametrize("writer,reopener", PAIRS)
def test_writer_reopen_rebuilds_index(tmp_path, writer, reopener):
    p = write_log(writer, tmp_path / "history.jlog", 20, chunk_size=8)
    w2 = fmt(reopener).HistoryWriter(p, chunk_size=8)
    for o in ops_of(reopener, 30)[20:]:
        w2.append(o)
    w2.close()
    lazy = fmt(reopener).read_history_lazy(p)
    assert len(lazy) == 30
    assert fields(lazy) == fields(ops_of(reopener, 30))


@pytest.mark.parametrize("root", ROOTS)
def test_lazy_bad_magic_raises_cleanly(tmp_path, root):
    p = tmp_path / "history.jlog"
    p.write_bytes(b"")
    with pytest.raises((ValueError, OSError)):
        fmt(root).read_history_lazy(p)
    p.write_bytes(b"garbage!")
    with pytest.raises(ValueError):
        fmt(root).read_history_lazy(p)


@pytest.mark.parametrize("root", ROOTS)
def test_mid_append_crash_recovers_prefix(tmp_path, root):
    p = write_log(root, tmp_path / "history.jlog", 12)
    with open(p, "ab") as f:  # half-written frame: header only
        f.write(struct.pack("<II", 999, 12345))
        f.write(b"{\"par")
    hist = fmt(root).read_history(p)
    assert len(hist) == 12
    w2 = fmt(root).HistoryWriter(p)
    w2.append(mod(root, "history").op(index=12, type="ok", process=0,
                                      f="read", value=12))
    assert len(w2.read_back()) == 13


def test_native_codec_against_python(tmp_path):
    from jepsen_tpu_torch import native

    assert native.jlog() is not None  # built with cc, like elleflat.c
    p = write_log("jepsen_tpu_torch", tmp_path / "history.jlog", 50)
    buf = p.read_bytes()
    pf = fmt("jepsen_tpu_torch")
    offs, end = native.scan(buf, len(pf.MAGIC))
    assert len(offs) == 50 and end == len(buf)
    with open(p, "r+b") as f:
        f.truncate(p.stat().st_size - 2)
    offs, end = native.scan(p.read_bytes(), len(pf.MAGIC))
    assert len(offs) == 49 and end == pf._valid_prefix_end(p)
    payloads = [json.dumps({"i": i}).encode() for i in range(20)]
    H = struct.Struct("<II")
    assert native.frame(payloads) == b"".join(
        H.pack(len(x), zlib.crc32(x)) + x for x in payloads)
    assert native.frame(payloads) == b"".join(map(pf.frame, payloads))


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_partial_results_across(tmp_path, writer, reader):
    p = tmp_path / "results.partial.jlog"
    w = fmt(writer).PartialResultsWriter(p)
    w.put("stats", {"valid?": True, "ok-count": 5})
    w.put("lin", {"valid?": False, "set": {3, 1}})
    w.close()
    got = fmt(reader).read_partial_results(p)
    assert got == {"stats": {"valid?": True, "ok-count": 5},
                   "lin": {"valid?": False, "set": [1, 3]}}
    with open(p, "r+b") as f:  # a torn tail drops only the tail
        f.truncate(p.stat().st_size - 3)
    assert set(fmt(reader).read_partial_results(p)) == {"stats"}
    got = mod(reader, "store").load_results(tmp_path)
    assert got["partial?"] is True and got["valid?"] == "unknown"


def test_partial_results_bytes_equal(tmp_path):
    for root in ROOTS:
        w = fmt(root).PartialResultsWriter(tmp_path / f"{root}.jlog")
        w.put("a", {"valid?": True, "x": [1, 2]})
        w.put("b", {"valid?": "unknown", "error": "boom"})
        w.close()
    assert (tmp_path / "jepsen_tpu.jlog").read_bytes() == \
        (tmp_path / "jepsen_tpu_torch.jlog").read_bytes()


@pytest.mark.parametrize("nested", [False, True])
def test_compose_streams_partials(tmp_path, nested):
    def scen(root):
        chk = mod(root, "checker")
        History = mod(root, "history").History
        op = mod(root, "history").op

        class Boom(chk.Checker):
            def check(self, test, hist, opts=None):
                raise RuntimeError("checker crashed")

        p = tmp_path / f"{root}.jlog"
        w = fmt(root).PartialResultsWriter(p)
        hist = History([op(type="invoke", process=0, f="read", value=None),
                        op(type="ok", process=0, f="read", value=1)])
        if nested:
            inner = chk.compose({"stats": chk.stats(),
                                 "bank-ish": chk.unbridled_optimism()})
            c = chk.compose({"workload": inner, "stats": chk.stats()})
        else:
            c = chk.compose({"stats": chk.stats(), "boom": Boom()})
        res = c.check({}, hist, {"partial_results": w})
        w.close()
        got = fmt(root).read_partial_results(p)
        return res["valid?"], sorted(got), {
            k: v["valid?"] for k, v in got.items()}

    j, p = scen("jepsen_tpu"), scen("jepsen_tpu_torch")
    assert j == p
    if not nested:
        assert p[0] == "unknown" and p[2]["boom"] == "unknown"
    else:
        assert p[1] == ["stats", "workload"]


@pytest.mark.parametrize("root", ROOTS)
def test_jsonable_degrades_gracefully(root):
    class Weird:
        def __repr__(self):
            return "<weird>"

    op = mod(root, "history").op
    v = fmt(root).jsonable({"a": {1, 2}, "b": Weird(),
                            "c": [op(type="ok")]})
    json.dumps(v)
    assert v["b"] == "<weird>" and v["a"] == [1, 2]


def test_decode_op_across():
    for w, r in PAIRS:
        o = ops_of(w, 3)[2]
        got = fmt(r).decode_op(fmt(w).encode_op(o))
        assert got.to_dict() == o.to_dict()


# ---------------------------------------------------------------------------
# store/__init__.py
# ---------------------------------------------------------------------------

def stored_run(root, tmp_path, name="store-e2e"):
    testing = mod(root, "testing")
    gen = mod(root, "generator")
    state = testing.AtomState()
    test = testing.noop_test()
    test.update(name=name, store_base=str(tmp_path), nodes=["n1"],
                concurrency=3, db=testing.AtomDB(state),
                client=testing.AtomClient(state),
                checker=mod(root, "checker").stats(),
                spec={"workload": "atom", "opts": {"ops": 30}},
                generator=gen.clients(gen.limit(30, lambda: {"f": "read"})))
    return mod(root, "core").run(test)


def test_full_run_persists_and_loads(tmp_path):
    from jepsen_tpu_torch import store

    test = stored_run("jepsen_tpu_torch", tmp_path)
    assert test["results"]["valid?"] is True
    d = store.path(test)
    for f in ("test.json", "results.json", "history.jlog", "jepsen.log",
              "spec.json", "telemetry.jsonl", "metrics.json",
              "timeseries.jsonl", "coverage.json"):
        assert (d / f).exists(), f
    loaded = store.load(d)
    assert len(loaded["history"]) == 60
    assert loaded["results"]["valid?"] is True
    assert loaded["name"] == "store-e2e"
    assert (tmp_path / "store-e2e" / "latest").resolve() == d.resolve()
    assert not (tmp_path / "current").exists()  # cleared after save-2
    assert store.load_spec(d) == test["spec"]
    events, metrics = store.load_telemetry(d)
    assert {e["name"] for e in events} >= {"run", "case", "analyze"}
    assert store.load_timeseries(d)
    assert list(store.tests(base=tmp_path)) == [d.resolve()] or \
        list(store.tests(base=tmp_path)) == [d]
    assert store.delete(base=tmp_path) == 1
    assert list(store.tests(base=tmp_path)) == []
    assert not (tmp_path / "latest").is_symlink()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_stored_run_loads_across(tmp_path, writer, reader):
    test = stored_run(writer, tmp_path)
    s = mod(reader, "store")
    d = test["store_dir"]
    loaded = s.load(d)
    assert [o.to_dict() for o in loaded["history"]] == \
        [o.to_dict() for o in test["history"]]
    assert loaded["results"] == json.loads(json.dumps(
        fmt(writer).jsonable(test["results"])))
    assert s.load_spec(d) == test["spec"]
    events, metrics = s.load_telemetry(d)
    assert mod(reader, "telemetry").validate_metrics(metrics) > 0
    assert len(events) == len(list(mod(writer, "telemetry").read_events(
        f"{d}/telemetry.jsonl")))
    assert s.load_timeseries(d) == mod(writer, "store").load_timeseries(d)
    assert [p.name for p in s.tests(base=tmp_path)] == \
        [p.name for p in mod(writer, "store").tests(base=tmp_path)]


def test_spec_roundtrip(tmp_path):
    for w, r in PAIRS:
        d = tmp_path / f"{w}-{r}"
        d.mkdir()
        test = {"name": "spec-rt", "store_dir": str(d),
                "spec": {"workload": "register",
                         "opts": {"nodes": ["n1"], "ops": 10}}}
        mod(w, "store").save_spec(test)
        assert mod(r, "store").load_spec(d) == test["spec"]
        assert mod(r, "store").load_spec(tmp_path) is None


@pytest.mark.parametrize("root", ROOTS)
def test_crashed_lifecycle_releases_log_handler(tmp_path, root):
    testing = mod(root, "testing")
    gen = mod(root, "generator")

    class BoomDB(mod(root, "db").DB):
        def setup(self, test, node):
            raise RuntimeError("boom")

    before = list(logging.getLogger().handlers)
    test = testing.noop_test()
    test.update(name="crash", store_base=str(tmp_path), nodes=["n1"],
                concurrency=1, db=BoomDB(),
                generator=gen.clients(gen.limit(1, lambda: {"f": "read"})))
    with pytest.raises(RuntimeError, match="boom"):
        mod(root, "core").run(test)
    assert logging.getLogger().handlers == before


def test_both_lifecycles_release_their_own_handlers(tmp_path):
    """One process runs both packages' stored lifecycles: each stop()
    removes its own handler from the shared root logger, and each run's
    jepsen.log holds its own lines."""
    before = list(logging.getLogger().handlers)
    log = logging.getLogger()
    level = log.level
    log.setLevel(logging.INFO)
    try:
        j = stored_run("jepsen_tpu", tmp_path / "j", "both")
        p = stored_run("jepsen_tpu_torch", tmp_path / "p", "both")
    finally:
        log.setLevel(level)
    assert logging.getLogger().handlers == before
    for t in (j, p):
        text = (mod("jepsen_tpu_torch", "store").path(t, "jepsen.log")
                .read_text())
        assert "Analysis complete" in text


def test_test_json_key_for_key(tmp_path):
    """test.json holds repr() of the objects in the test map (save_test_map
    degrades them through jsonable): "net" is such a value and names each
    package's own class. It is left out, with the run's own start_time
    and store_base; every other key must be equal."""
    j = stored_run("jepsen_tpu", tmp_path / "j", "tj")
    p = stored_run("jepsen_tpu_torch", tmp_path / "p", "tj")
    docs = []
    for t in (j, p):
        with open(mod("jepsen_tpu_torch", "store").path(t, "test.json")) as f:
            docs.append(json.load(f))
    assert sorted(docs[0]) == sorted(docs[1])
    assert docs[0]["net"].startswith("<jepsen_tpu.net.IPTables object")
    assert docs[1]["net"].startswith(
        "<jepsen_tpu_torch.net.IPTables object")
    excluded = {"net", "start_time", "store_base"}
    assert {k: v for k, v in docs[0].items() if k not in excluded} == \
        {k: v for k, v in docs[1].items() if k not in excluded}
    assert docs[1]["spec"] == {"workload": "atom", "opts": {"ops": 30}}
