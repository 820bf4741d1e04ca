"""The shard grid, its layouts and its collectives (the JAX package's
``parallel/``): a ``(data, model)`` grid of shards on one device a process
(:mod:`.mesh`), spanning several processes after
:func:`initialize_distributed`; how a tensor's leading axis splits over it
(:mod:`.sharding`); and the reductions over the data axis and, inside a
process, the model axis (:mod:`.collectives`)."""

from fraud_detection_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_gather_blocks,
    collective_counts,
    data_parallel,
    pmax,
    pmean,
    psum,
    psum_model,
    psum_scatter,
    psum_scatter_blocks,
    replicate,
    reset_collective_counts,
)
from fraud_detection_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    backend,
    create_mesh,
    default_mesh,
    device_count,
    global_mesh,
    initialize_distributed,
    process_count,
    process_index,
)
from fraud_detection_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardLayout,
    batch_sharding,
    data_sharding,
    pad_to_multiple,
    replicated,
    shard_batch,
)
