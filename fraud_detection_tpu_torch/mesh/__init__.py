"""The serving mesh and training across shards (the JAX package's
``mesh/``):

- :mod:`.topology` — the serving grid, every shard on the serving device;
- :mod:`.shardflush` — the fused flush over the shard axis, per-shard drift
  windows and ledger sub-tables merged at scrape time;
- :mod:`.front` — the shard front: replica micro-batchers behind a router
  with health tracking, draining and a half-open probe;
- :mod:`.retrain` — the cross-replica-sharded weight update
  (``mesh_sgd_fit``) and the feedback pools' summary over the data axis,
  and the wide family's fit over a ``(data × model)`` grid
  (``wide_training_mesh``, ``wide_sgd_fit``).

The collectives are ``parallel/collectives``. The model axis
(``MESH_MODEL_DEVICES``) column-shards the wide family's cross table, in
the serving flush and in the fit; it lies inside a process, whose ranks
split the data axis."""

from fraud_detection_tpu_torch.mesh.front import NoHealthyShards, ShardFront
from fraud_detection_tpu_torch.mesh.shardflush import (
    MeshDriftMonitor,
    init_sharded_window,
    merge_window,
)
from fraud_detection_tpu_torch.mesh.topology import (
    serving_mesh,
    serving_mesh_model_size,
    serving_mesh_size,
)

__all__ = [
    "MeshDriftMonitor",
    "NoHealthyShards",
    "ShardFront",
    "init_sharded_window",
    "merge_window",
    "serving_mesh",
    "serving_mesh_model_size",
    "serving_mesh_size",
]
