"""The shard grid and its layouts (the JAX package's ``parallel/`` for
serving): a ``(data, model)`` grid of shards on the serving device
(:mod:`.mesh`) and how a tensor's leading axis splits over it
(:mod:`.sharding`). Collectives and multi-process bring-up are ROADMAP
item 12b."""

from fraud_detection_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    create_mesh,
    default_mesh,
    device_count,
)
from fraud_detection_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardLayout,
    batch_sharding,
    pad_to_multiple,
    replicated,
    shard_batch,
)
