"""Workload bundles: generator + checker pairs for the classic jepsen
test families. Each module exposes `workload(opts) -> {"generator": ...,
"checker": ..., ...}` mirroring how suites map workload names to
{:generator :checker :client} bundles (e.g. tidb/src/tidb/core.clj:32-45,
jepsen/src/jepsen/tests/bank.clj:178-191).

The port's copy of jepsen_tpu/workloads/__init__.py: REGISTRY maps the
same 28 names, in the same order, to the port's constructors. The
register, bank, append and wr checkers run on the card (opts["device"]:
None, the default, or "cpu"); every other family checks on the host, as
in the JAX package, and launches no kernel.
"""

from . import adya  # noqa: F401
from . import bank  # noqa: F401
from . import causal  # noqa: F401
from . import causal_reverse  # noqa: F401
from . import counter  # noqa: F401
from . import dirty_read  # noqa: F401
from . import kafka  # noqa: F401
from . import lock  # noqa: F401
from . import long_fork  # noqa: F401
from . import lost_updates  # noqa: F401
from . import monotonic  # noqa: F401
from . import multimonotonic  # noqa: F401
from . import pages  # noqa: F401
from . import queue  # noqa: F401
from . import register  # noqa: F401
from . import scheduler  # noqa: F401
from . import sequential  # noqa: F401
from . import sets  # noqa: F401
from . import txn_append  # noqa: F401
from . import txn_wr  # noqa: F401
from . import unique_ids  # noqa: F401
from . import upsert  # noqa: F401
from . import version_divergence  # noqa: F401

REGISTRY = {
    "adya-g2": adya.workload,
    "bank": bank.workload,
    "causal": causal.workload,
    "causal-reverse": causal_reverse.workload,
    "counter": counter.workload,
    "dirty-read": dirty_read.workload,
    "fenced-lock": lock.fenced_lock_workload,
    "kafka": kafka.workload,
    "lock": lock.lock_workload,
    "long-fork": long_fork.workload,
    "lost-updates": lost_updates.workload,
    "monotonic": monotonic.workload,
    "multimonotonic": multimonotonic.workload,
    "owner-lock": lock.owner_lock_workload,
    "pages": pages.workload,
    "queue": queue.workload,
    "reentrant-lock": lock.reentrant_lock_workload,
    "register": register.workload,
    "run-coverage": scheduler.workload,
    "semaphore": lock.semaphore_workload,
    "sequential": sequential.workload,
    "set": sets.workload,
    "set-full": sets.full_workload,
    "append": txn_append.workload,
    "upsert": upsert.workload,
    "version-divergence": version_divergence.workload,
    "wr": txn_wr.workload,
    "unique-ids": unique_ids.workload,
}
