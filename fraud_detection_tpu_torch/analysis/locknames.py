"""The named-lock inventory: every cross-thread mutex the port relies on.

The port's copy of the JAX package's ``analysis/locknames.py``: the same
fourteen locks under the same names, kinds, classes and attributes, each
created in the port's module of the same name. Each :class:`LockDecl`
names one real lock (where it lives, which attribute binds it, why it
exists); the static pass (:mod:`.lockcheck`) resolves ``with <lock>:``
sites against this table to build the acquisition-order graph, and the
runtime witness (:mod:`fraud_detection_tpu_torch.utils.lockdep`)
instruments exactly these names under ``LOCKDEP=1``. The two are
cross-checked: a ``lockdep.lock("name")`` creation site with no
declaration here — or a declaration whose creation site disappeared — is
inventory drift, so the inventory cannot silently rot.

The canonical acquisition order (outer → inner) the serving tier relies
on::

    lifeboat.flush  →  lifeboat.journal      (journal_staged / rotate)
    lifeboat.flush  →  drift.window          (snapshot cut materialization)
    longhaul.inherit →  lifeboat.flush       (segment merge + rebind publish)

Everything else is a leaf: held for short critical sections, never while
acquiring another named lock — but for the store's ``netstore.pub →
taskq.broker`` (a write published under the publish lock runs the broker's
statement under its own). ``ShardFront`` health state and the
micro-batcher's admission bookkeeping are deliberately NOT here — they are
asyncio event-loop-confined (single-threaded by construction), which is the
discipline that keeps them out of this table.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LockDecl:
    #: canonical name — the string passed to ``lockdep.lock()``
    name: str
    #: repo-relative path of the module that creates the lock
    module: str
    #: owning class (subclasses inherit the binding); None = module global
    cls: str | None
    #: instance attribute / module global the lock binds to
    attr: str
    #: "lock" | "rlock"
    kind: str = "lock"
    #: what the lock protects + why (the report's inventory carries it)
    purpose: str = ""


LOCKS: tuple[LockDecl, ...] = (
    LockDecl(
        "lifeboat.flush", "fraud_detection_tpu_torch/lifeboat/boat.py",
        "Lifeboat", "flush_lock",
        purpose="couples {journal append → fused dispatch} on the flush "
        "path to {table+window read → seq capture → rotate} on the "
        "snapshot path — a snapshot cut can never split a flush from its "
        "journal record",
    ),
    LockDecl(
        "lifeboat.journal", "fraud_detection_tpu_torch/lifeboat/journal.py",
        "Journal", "_lock",
        purpose="serializes record appends against the maintenance "
        "thread's fsync tick and snapshot-boundary rotation",
    ),
    LockDecl(
        "drift.window", "fraud_detection_tpu_torch/monitor/drift.py",
        "DriftMonitor", "_lock",
        purpose="the fused flush donates the window/ledger buffers; a "
        "stats()/scrape reader racing the ingest thread would hand "
        "just-invalidated arrays to _drift_stats (MeshDriftMonitor "
        "inherits the binding)",
    ),
    LockDecl(
        "staging.pool", "fraud_detection_tpu_torch/ops/scorer.py",
        "StagingPool", "_lock",
        purpose="guards the per-bucket staging freelist (acquire/release "
        "of pinned host slots on the ingest path)",
    ),
    LockDecl(
        "binlane.server", "fraud_detection_tpu_torch/service/binlane.py",
        "BinaryIngestServer", "_lock",
        purpose="guards the binary-lane listener's connection set during "
        "accept/shed/close",
    ),
    LockDecl(
        "sentinel.conns", "fraud_detection_tpu_torch/service/sentinel.py",
        "Sentinel", "_lock",
        purpose="guards the sentinel's accepted-connection registry",
    ),
    LockDecl(
        "taskq.broker", "fraud_detection_tpu_torch/service/taskq.py",
        "SqliteBroker", "_lock",
        purpose="serializes task claim/ack against the shared sqlite "
        "connection",
    ),
    LockDecl(
        "netstore.pub", "fraud_detection_tpu_torch/service/netserver.py",
        "StoreServer", "_pub_lock", kind="rlock",
        purpose="writes capture their row image and publish under one "
        "critical section so a slower writer can't publish an older row "
        "image with a newer seq (reentrant: _dispatch → _publish)",
    ),
    LockDecl(
        "netstore.conns", "fraud_detection_tpu_torch/service/netserver.py",
        "StoreServer", "_conns_lock",
        purpose="guards the store's accepted-socket set",
    ),
    LockDecl(
        "lifecycle.store", "fraud_detection_tpu_torch/lifecycle/store.py",
        "LifecycleStore", "_lock",
        purpose="serializes the conductor's CAS state machine + feedback "
        "pools on the shared DB connection (the promotion CAS rides this)",
    ),
    LockDecl(
        "lifecycle.reloader", "fraud_detection_tpu_torch/lifecycle/swap.py",
        "ModelReloader", "_lock",
        purpose="makes hot-swap slot flips atomic against concurrent "
        "reload triggers",
    ),
    LockDecl(
        "watchtower.retrain", "fraud_detection_tpu_torch/monitor/watchtower.py",
        "Watchtower", "_retrain_lock",
        purpose="latch check/set for retrain recommendations — concurrent "
        "status() evaluations must not enqueue duplicate retrain tasks",
    ),
    LockDecl(
        "longhaul.members", "fraud_detection_tpu_torch/longhaul/membership.py",
        "DirectoryServer", "_members_lock",
        purpose="one critical section per membership mutation: epoch bump "
        "+ member-table update + durable members.json replace publish "
        "together, so no reader ever sees a new epoch with an old view "
        "(or vice versa)",
    ),
    LockDecl(
        "longhaul.inherit", "fraud_detection_tpu_torch/longhaul/host.py",
        "HostServer", "_inherit_lock",
        purpose="serializes segment inheritance on the surviving host — "
        "state flip to INHERITING, peer journal replay, and the "
        "merge+rebind are one take-over; acquired BEFORE lifeboat.flush "
        "(the merge publishes under the flush lock so a snapshot cut "
        "can't split the rebind)",
    ),
)


def by_name() -> dict[str, LockDecl]:
    return {d.name: d for d in LOCKS}


def by_attr() -> dict[str, list[LockDecl]]:
    out: dict[str, list[LockDecl]] = {}
    for d in LOCKS:
        out.setdefault(d.attr, []).append(d)
    return out
