"""Ledger: per-entity velocity state held on the device.

A fixed-size hashed per-entity accumulator table on the device. The
ledger flush (``monitor/drift._fused_flush_ledger``) reads each row's
aggregates, derives K velocity features, writes the updated accumulators
back and scores the widened ``[rows, base + K]`` block through the
``fused_score`` kernel. Training replays its rows through the same body in
timestamp order (:mod:`.replay`), so the features the model fits on are
the features serving computes. Under the serving mesh the batcher places
each row in the segment of the shard that owns its slot
(:mod:`.placement`).
"""

from fraud_detection_tpu_torch.ledger.features import (  # noqa: F401
    _ledger_read_update,
    ledger_stats,
)
from fraud_detection_tpu_torch.ledger.replay import (  # noqa: F401
    materialize_features,
    synthesize_entities,
)
from fraud_detection_tpu_torch.ledger.state import (  # noqa: F401
    LEDGER_FEATURE_NAMES,
    LEDGER_K,
    LedgerSpec,
    LedgerState,
    entity_fingerprint,
    entity_slot,
    init_state,
    load_ledger,
    save_ledger,
)
