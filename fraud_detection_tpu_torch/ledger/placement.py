"""Hash-mod-shard row placement for the sharded ledger flush (the JAX
package's ``ledger/placement.py``).

Under ``MESH_FLUSH_DEVICES=N`` the flush splits the staged bucket into N
row segments: rows ``[s·b/N, (s+1)·b/N)`` are shard ``s``'s, and each
shard folds its rows into its own ledger sub-table. For an entity's
aggregates to live in one sub-table, every row of that entity must land in
the same segment, so the batcher places rows by ``slot mod N`` before
staging — a host-side permutation. Entity-less rows carry no state and
fill the emptiest segments. A skewed mix can overfill a segment (9 of 16
rows on shard 0 of 2), so the bucket is bumped to the least power of two
that holds ``N × the fullest segment``; the mesh ledger's warm ladder
extends by the shard factor so a bump never meets a cold bucket.
"""

from __future__ import annotations

import numpy as np

from fraud_detection_tpu_torch.ops.scorer import _bucket


def shard_placement(
    slots: np.ndarray,       # (n,) int table slot per row
    has_entity: np.ndarray,  # (n,) truthy where the row carries an entity
    n_shards: int,
    min_bucket: int = 8,
) -> tuple[int, np.ndarray]:
    """``(bucket, positions)``: ``positions[i]`` is row ``i``'s staged index.
    Entity rows sit in segment ``slots[i] % n_shards``, in row order;
    entity-less rows go to the emptiest segment. The bucket is the least
    power of two ≥ ``max(n, n_shards · fullest segment, min_bucket)``."""
    n = int(slots.shape[0])
    shard_of = np.where(
        np.asarray(has_entity, bool), np.asarray(slots) % n_shards, -1
    )
    counts = np.bincount(shard_of[shard_of >= 0], minlength=n_shards)
    free = counts.copy()
    for i in np.flatnonzero(shard_of < 0):
        s = int(np.argmin(free))
        shard_of[i] = s
        free[s] += 1
    max_seg = int(free.max()) if n else 0
    bucket = _bucket(max(n, n_shards * max_seg, min_bucket), min_bucket)
    seg = bucket // n_shards
    positions = np.zeros(n, np.int64)
    cursor = np.zeros(n_shards, np.int64)
    for i in range(n):
        s = int(shard_of[i])
        positions[i] = s * seg + cursor[s]
        cursor[s] += 1
    return bucket, positions
