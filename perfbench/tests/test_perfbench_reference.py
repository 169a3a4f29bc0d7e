"""The plain reference: it decides known valid and invalid histories,
accepts the program's certificates of them, and rejects tampered ones."""

import copy

import pytest
from harness import cell, gen, judge
from reference import register as ref

from jepsen_tpu_torch import checker
from jepsen_tpu_torch.checker import models


def _check(events):
    lin = checker.linearizable({"model": models.cas_register(),
                                "device": "cpu"})
    return lin.check({}, cell.to_history(events))


def test_decides_hand_made_histories():
    ok = [("invoke", 0, "write", 1), ("invoke", 1, "read", None),
          ("ok", 0, "write", 1), ("ok", 1, "read", 1),
          ("invoke", 0, "cas", [1, 2]), ("ok", 0, "cas", [1, 2]),
          ("invoke", 1, "cas", [1, 3]), ("fail", 1, "cas", [1, 3])]
    entries = ref.pair(enumerate(ok))
    assert set(entries) == {0, 1, 4}
    assert ref.decide(entries, [0, 1, 4]) == (True, None)
    # a witness that breaks real time or the model decides nothing
    assert ref.decide(entries, [1, 0, 4]) == (None, None)
    bad = ok + [("invoke", 1, "read", None), ("ok", 1, "read", 7)]
    assert ref.decide(ref.pair(enumerate(bad)), [0, 1, 4, 8]) == (False, 8)


def test_crashed_ops_may_be_left_out_or_applied():
    evs = [("invoke", 0, "write", 3), ("info", 0, "write", 3),
           ("invoke", 1, "read", None), ("ok", 1, "read", 3),
           ("invoke", 2, "write", 4)]
    entries = ref.pair(enumerate(evs))
    assert entries[0][4] and entries[4][4] and not entries[2][4]
    assert ref.decide(entries, [0, 2]) == (True, None)
    ref.replay([(0, "apply"), (2, "apply"), (4, "discard")], entries)
    with pytest.raises(ref.Rejected):
        ref.replay([(2, "discard")], entries)


@pytest.fixture(scope="module")
def valid_case():
    events, witness = gen.register_history(400, seed=2**31 + 3)
    return events, witness, _check(events)


@pytest.fixture(scope="module")
def invalid_case():
    events, witness = gen.register_history(400, seed=2**31 + 4)
    bad, i = gen.corrupt_register_history(events, 0.85)
    return bad, witness, i, _check(bad)


def test_accepts_the_programs_valid_certificate(valid_case):
    events, witness, res = valid_case
    entries = ref.pair(enumerate(events))
    assert ref.decide(entries, witness) == (True, None)
    assert res["valid?"] is True
    ref.check_certificate(res["certificate"], entries, True,
                          ref.history_digest(events))


def test_accepts_the_programs_invalid_certificate(invalid_case):
    bad, witness, i, res = invalid_case
    entries = ref.pair(enumerate(bad))
    valid, anomaly = ref.decide(entries, witness)
    assert valid is False and bad[anomaly][0] == "invoke"
    assert bad[anomaly][1] == bad[i][1] and anomaly < i
    assert res["valid?"] is False and res["op"].index == anomaly
    ref.check_certificate(res["certificate"], entries, False,
                          ref.history_digest(bad))


def _swap_two(c):
    o = c["segments"][0]["order"]
    o[3], o[4] = o[4], o[3]


def _drop_one(c):
    del c["segments"][-1]["order"][-1]


def _twice(c):
    o = c["segments"][0]["order"]
    o[5] = list(o[4])


def _stuck_applies(c):
    c["witness"]["op-index"] = c["witness"]["prefix"][-1][0]


TAMPERED_VALID = {
    "swapped steps": _swap_two,
    "an op left out": _drop_one,
    "an op placed twice": _twice,
    "another history's digest": lambda c: c["history"].update(crc=1),
    "the verdict turned": lambda c: c.update(verdict="invalid"),
    "absent": lambda c: c.update(absent="budget"),
    "another model": lambda c: c["model"].update(name="register"),
}

TAMPERED_INVALID = {
    "another stuck op": _stuck_applies,
    "another witness state": lambda c: c["witness"].update(state=99),
    "a prefix step discarded": lambda c: c["witness"]["prefix"][0]
    .__setitem__(1, "discard"),
}


@pytest.mark.parametrize("name", sorted(TAMPERED_VALID))
def test_rejects_a_tampered_valid_certificate(valid_case, name):
    events, _w, res = valid_case
    cert = copy.deepcopy(res["certificate"])
    TAMPERED_VALID[name](cert)
    with pytest.raises(ref.Rejected):
        ref.check_certificate(cert, ref.pair(enumerate(events)), True,
                              ref.history_digest(events))


@pytest.mark.parametrize("name", sorted(TAMPERED_INVALID))
def test_rejects_a_tampered_invalid_certificate(invalid_case, name):
    bad, _w, _i, res = invalid_case
    cert = copy.deepcopy(res["certificate"])
    TAMPERED_INVALID[name](cert)
    with pytest.raises(ref.Rejected):
        ref.check_certificate(cert, ref.pair(enumerate(bad)), False,
                              ref.history_digest(bad))


def test_rejects_a_certificate_of_another_history(valid_case):
    events, _w, res = valid_case
    other = gen.relabel(events, list(range(5)), [10, 11, 12, 13, 14])
    with pytest.raises(ref.Rejected):
        ref.check_certificate(res["certificate"],
                              ref.pair(enumerate(other)), True,
                              ref.history_digest(other))


def test_a_value_permutation_keeps_the_proof(valid_case):
    # the register model does not tell values apart: the same order
    # proves the history with its values permuted
    events, _w, res = valid_case
    other = gen.relabel(events, [1, 2, 3, 4, 0], list(range(5)))
    ref.check_certificate(res["certificate"], ref.pair(enumerate(other)),
                          True, ref.history_digest(other))


def test_digest_is_the_certificate_schemas(valid_case):
    events, _w, res = valid_case
    assert ref.history_digest(events) == res["certificate"]["history"]


def _judge(config, events, witness, answer):
    counts = dict.fromkeys(ref.LIMITS, 0)
    ref.judge(config, {"events": events, "witness": witness}, answer,
              counts)
    return counts


SINGLE = {"entry": "linearizable", "reference": "register",
          "guarantees": {"certificate": "on every verdict"}}


def test_judges_an_answer_by_the_stated_guarantee(valid_case):
    events, witness, res = valid_case
    assert _judge(SINGLE, events, witness, res) == \
        dict.fromkeys(ref.LIMITS, 0)
    bare = {k: v for k, v in res.items() if k != "certificate"}
    assert _judge(SINGLE, events, witness, bare)["certificates_absent"] == 1
    # a configuration that states no certificate does not ask for one
    uncertified = {**SINGLE, "guarantees": {"verdict": "exact"}}
    assert _judge(uncertified, events, witness, bare) == \
        dict.fromkeys(ref.LIMITS, 0)
    assert _judge(uncertified, events, witness,
                  {**res, "valid?": False})["verdicts_wrong"] == 1


def test_the_configuration_names_its_reference():
    assert judge.reference(SINGLE) is ref
    with pytest.raises(ModuleNotFoundError):
        judge.reference({"reference": "no_such_reference"})
    with pytest.raises(ValueError):
        judge.reference({"reference": "register.sub"})
    with pytest.raises(ValueError):
        cell.entry_module({"entry": "../linearizable"})
