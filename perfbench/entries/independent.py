"""The entry of a configuration with `"entry": "independent"`: many
keys, each a CAS register's history, folded into one history as a
Jepsen run of independent keys records them, and checked by the port's
independent checker over its linearizable checker (certificates on, no
store directory), which checks every key in one batched launch.

The configuration's `history` gives the number of keys and each key's
generator sizes; the base holds one history for each key, key k's from
the seed `seed * MAX_KEYS + k`. Each check deals the base's histories
out to the keys in an order of its own, permutes the values and maps
the process ids anew, so that no two checks put the same history under
the same key: an answer carried over from another check, or another
key's answer, is judged wrong.
"""

from __future__ import annotations

import random

from entries import linearizable
from harness import gen

MAX_KEYS = 4096


def inputs(config: dict, traffic: dict, seed: int) -> dict:
    """The base from `seed`: {"hists", "witnesses"}, each key's events
    and the positions of its invocations in the order the generator
    applied them."""
    h = config["history"]
    keys = h["keys"]
    if not 0 < keys <= MAX_KEYS:
        raise ValueError(f"keys must be 1..{MAX_KEYS}")
    kw = linearizable.register_kw(config, traffic)
    hists, wits = [], []
    for k in range(keys):
        ev, w = gen.register_history(h["ops"], seed=seed * MAX_KEYS + k,
                                     **kw)
        hists.append(ev)
        wits.append(w)
    return {"hists": hists, "witnesses": wits}


def labels(config: dict, seed: int):
    """(value permutation, process map, key order) triples, one a check,
    drawn from `seed`."""
    keys = config["history"]["keys"]
    rng = random.Random(f"keys:{seed}")
    for vp, pp in linearizable.labels(config, seed):
        yield vp, pp, rng.sample(range(keys), keys)


def history(base: dict, label) -> dict:
    """The history a check is handed, {"events", "witness"}: key k holds
    the base's history `order[k]`, folded and relabelled; the witness is
    key -> invocation positions in the folded history."""
    vp, pp, order = label
    events, positions = gen.fold_keys([base["hists"][i] for i in order])
    witness = {k: [positions[k][j] for j in base["witnesses"][i]]
               for k, i in enumerate(order)}
    return {"events": gen.relabel(events, vp, pp), "witness": witness}


def checker(config: dict, device):
    """The timed entry: independent.checker(checker.linearizable(...))."""
    from jepsen_tpu_torch import independent

    return independent.checker(linearizable.checker(config, device))
