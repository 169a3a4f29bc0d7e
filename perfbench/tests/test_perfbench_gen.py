"""The frozen generator against the program's: the same register
histories and corruption, op for op, and a witness that replays."""

import pytest
from harness import gen
from reference import register as ref

from jepsen_tpu_torch.gpu import synth

CASES = [
    dict(n_ops=300, seed=0),
    dict(n_ops=500, seed=2**31 + 11, n_procs=5),
    dict(n_ops=400, seed=7, n_procs=4, crash_p=0.15),
    dict(n_ops=200, seed=12, crash_p=0.15, cas_p=1 / 3, read_p=1 / 3),
    dict(n_ops=250, seed=3, n_values=3, cas_p=0.5, read_p=0.2),
]


def _tuples(hist):
    for i, o in enumerate(hist):
        assert o.index == i and o.time == i
    return [(o.type, o.process, o.f, o.value) for o in hist]


@pytest.mark.parametrize("kw", CASES)
def test_register_history_matches_the_program(kw):
    events, _witness = gen.register_history(**kw)
    assert events == _tuples(synth.register_history(**kw))


@pytest.mark.parametrize("kw", CASES)
def test_witness_replays(kw):
    events, witness = gen.register_history(**kw)
    assert ref.decide(ref.pair(enumerate(events)), witness) == (True, None)


@pytest.mark.parametrize("frac", [0.5, 0.85])
def test_corruption_matches_the_program(frac):
    events, _w = gen.register_history(600, seed=5)
    bad, i = gen.corrupt_register_history(events, frac)
    want, j = synth.corrupt_register_history(
        synth.register_history(600, seed=5), frac)
    assert (bad, i) == (_tuples(want), j)


def test_relabel_keeps_structure():
    events, witness = gen.register_history(300, seed=9)
    bad, _i = gen.corrupt_register_history(events, 0.85)
    vp, pp = [2, 0, 4, 1, 3], [17, 402, 3, 999, 0]
    for evs in (events, bad):
        out = gen.relabel(evs, vp, pp)
        assert [(t, f) for t, _p, f, _v in out] == \
            [(t, f) for t, _p, f, _v in evs]
        assert ref.decide(ref.pair(enumerate(out)), witness) == \
            ref.decide(ref.pair(enumerate(evs)), witness)


def test_fold_keys_interleaves_by_position_then_key():
    a, wa = gen.register_history(20, seed=1)
    b, wb = gen.register_history(30, seed=2)
    events, pos = gen.fold_keys([a, b])
    assert len(events) == len(a) + len(b)
    for k, h in enumerate((a, b)):
        for i, (t, p, f, v) in enumerate(h):
            assert events[pos[k][i]] == (t, k * 1000 + p, f, (k, v))
    items = ref.split(events)
    for k, w in enumerate((wa, wb)):
        assert ref.decide(ref.pair(items[k]),
                          [pos[k][i] for i in w]) == (True, None)


def test_register_entry_gives_every_seed_the_same_work():
    """The register entry's base comes from the configuration's
    base_seed, whatever the run's seed; the run's seed draws the
    relabellings, so two seeds hand the program different histories."""
    from entries import linearizable
    from harness import cell

    spec = cell.resolve("register-1m.valid")
    config, traffic = spec["config"], spec["traffic"]
    config["history"]["ops"] = 300
    a = linearizable.inputs(config, traffic, 2**31 + 21)
    b = linearizable.inputs(config, traffic, 5)
    assert a == b
    want = gen.register_history(300, seed=config["history"]["base_seed"],
                                **linearizable.register_kw(config, traffic))
    assert (a["events"], a["witness"]) == want
    la = next(linearizable.labels(config, 2**31 + 21))
    lb = next(linearizable.labels(config, 5))
    assert la != lb
    assert linearizable.history(a, la)["events"] != \
        linearizable.history(b, lb)["events"]
