"""Checking-as-a-service: the multi-tenant analysis fleet (the port's
copy of jepsen_tpu/fleet/).

Many concurrent test runs feed one shared device: tenants stream their
histories to one server, and the card answers them in shared launches.
This package is the data plane:

  wire.py       CRC-framed messages over a local socket (the jlog
                framing discipline applied to a stream: a torn or
                corrupt frame is detected, never half-applied)
  wal.py        per-(tenant, run) write-ahead journal — every accepted
                chunk hits disk BEFORE its ack, so a SIGKILL'd server
                replays to byte-identical verdicts on restart
  scheduler.py  continuous cross-run batching: per-key/per-segment
                slices and whole-history finals from MANY tenants
                packed into shared wgl_search and scc launches, drained by
                per-tenant weighted-fair queues
  server.py     the always-on service: admission control that sheds
                load by rejecting NEW streams with retry-after (never
                degrading in-flight ones), crash recovery, per-tenant
                quotas and stats
  client.py     streams chunks during a live run (RetryBudget +
                decorrelated jitter), falls back to local checking
                when the fleet is unreachable; the interpreter hook

Robustness contract: no lost chunks, no wedged queues, no verdict ever
silently wrong or silently dropped under any crash/overload schedule the
chaos rig can produce. Every verdict ships with its certificate
(gpu/certify.py) so a tenant can independently validate what the pool
computed.

The scheduler and the server take a `device` (None: the card; "cpu":
the kernels' plain versions) and pass it to every check they make. The
wire frames, WAL records, verdict files and stream checkpoints are the
JAX package's byte for byte, so either package's server recovers the
other's WAL directory.
"""

from __future__ import annotations

# model-spec registry: the wire names a model by string; both the
# client (for local fallback) and the server resolve it here. wgl
# entries are model factories; elle entries are check functions keyed
# by family.
def wgl_models() -> dict:
    from ..checker import models

    return {
        "register": models.register,
        "cas-register": models.cas_register,
        "mutex": models.mutex,
        "fifo-queue": models.fifo_queue,
        "unordered-queue": models.unordered_queue,
    }


def elle_checks() -> dict:
    from ..gpu import elle

    return {
        "list-append": elle.check_list_append,
        "rw-register": elle.check_rw_register,
    }


def known_models() -> list[str]:
    return sorted(list(wgl_models()) + list(elle_checks()))


# register-family models take an initial value; the rest don't (a
# queue's initial state IS empty). The wire's hello may carry
# `initial` for exactly these.
_TAKES_INITIAL = ("register", "cas-register")


def build_model(name: str, initial=None):
    """Instantiates a wgl model spec from the wire: (name, initial).
    The initial value matters — a register seeded to 0 by its DB
    checked against an initial-None model is PROVABLY nonlinearizable
    on the first read, so tenants must be able to say what their
    system starts as."""
    factory = wgl_models()[name]
    if initial is not None and name in _TAKES_INITIAL:
        return factory(initial)
    return factory()
