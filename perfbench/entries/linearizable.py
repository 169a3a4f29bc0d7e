"""The entry of a configuration with `"entry": "linearizable"`: one CAS
register's history checked by the port's linearizable checker with its
defaults (certificates on) and no store directory, and the inputs it is
handed.

The configuration's `history` gives the generator's sizes (ops, procs,
values, read_p, cas_p) and its seed (`base_seed`); the traffic mix gives
crash_p. Every run checks that one base history, so every run does the
same work: histories drawn from different seeds differ in how long the
search and the certificate take. The run's seed draws the relabellings:
each check gets the base history with its values permuted and its
process ids mapped anew (harness/gen.py `relabel`), a history the
program has not seen in the process.
"""

from __future__ import annotations

from harness import gen


def register_kw(config: dict, traffic: dict) -> dict:
    """The generator's keyword arguments of one register's history."""
    h = config["history"]
    return {"n_procs": h["procs"], "crash_p": traffic["crash_p"],
            "n_values": h["values"], "cas_p": h["cas_p"],
            "read_p": h["read_p"]}


def inputs(config: dict, traffic: dict, seed: int) -> dict:
    """The base history, {"events", "witness"}, from the configuration's
    `base_seed` (the run's `seed` draws only the relabellings), the
    witness the invocation positions in the order the generator applied
    them (the order reference/register.py replays)."""
    h = config["history"]
    events, witness = gen.register_history(
        h["ops"], seed=h["base_seed"], **register_kw(config, traffic))
    return {"events": events, "witness": witness}


def labels(config: dict, seed: int):
    """The relabellings of the base, one a check, drawn from `seed`."""
    h = config["history"]
    return gen.relabelings(seed, h["values"], h["procs"])


def history(base: dict, label) -> dict:
    """The history a check is handed, {"events", "witness"}: the base's
    events relabelled by `label`, and its witness, which relabelling
    keeps."""
    return {"events": gen.relabel(base["events"], *label),
            "witness": base["witness"]}


def checker(config: dict, device):
    """The timed entry: checker.linearizable over a CAS register."""
    from jepsen_tpu_torch import checker as checkers
    from jepsen_tpu_torch.checker import models

    return checkers.linearizable({"model": models.cas_register(),
                                  "device": device})
