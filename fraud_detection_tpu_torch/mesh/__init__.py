"""The serving mesh and training across shards (the JAX package's
``mesh/``):

- :mod:`.topology` — the serving grid, every shard on the serving device;
- :mod:`.shardflush` — the fused flush over the shard axis, per-shard drift
  windows and ledger sub-tables merged at scrape time;
- :mod:`.front` — the shard front: replica micro-batchers behind a router
  with health tracking, draining and a half-open probe;
- :mod:`.retrain` — the wide family's fit on a 1×1 mesh.

The sharded weight update, the collectives and the 2-D wide mesh are
ROADMAP item 12b."""

from fraud_detection_tpu_torch.mesh.front import NoHealthyShards, ShardFront
from fraud_detection_tpu_torch.mesh.shardflush import (
    MeshDriftMonitor,
    init_sharded_window,
    merge_window,
)
from fraud_detection_tpu_torch.mesh.topology import serving_mesh, serving_mesh_size

__all__ = [
    "MeshDriftMonitor",
    "NoHealthyShards",
    "ShardFront",
    "init_sharded_window",
    "merge_window",
    "serving_mesh",
    "serving_mesh_size",
]
