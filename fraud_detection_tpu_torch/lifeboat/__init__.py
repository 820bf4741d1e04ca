"""lifeboat: crash-consistent durability and warm restart for the serving
state on the device.

The port of the JAX package's ``lifeboat/``. The ledger's per-entity table
and the drift window live only on the device, updated in place by every
flush: a crash loses every aggregate folded in since the train-time stamp.
This package is the durability layer: CRC-stamped generational snapshots
(:mod:`.snapshot`), a write-ahead entity journal (:mod:`.journal`), the
replay through the ledger's read-update that rebuilds the table on restart
(:mod:`.recovery`), and the :class:`~.boat.Lifeboat` that wires them into
the serving process (``LIFEBOAT_DIR``).
"""

from fraud_detection_tpu_torch.lifeboat.boat import IDLE, READY, RECOVERING, Lifeboat  # noqa: F401
from fraud_detection_tpu_torch.lifeboat.journal import (  # noqa: F401
    Journal,
    JournalTail,
    list_journals,
    read_journal_file,
    read_tail,
)
from fraud_detection_tpu_torch.lifeboat.recovery import (  # noqa: F401
    RecoveryReport,
    recover,
    replay_records,
    replay_rows,
)
from fraud_detection_tpu_torch.lifeboat.snapshot import (  # noqa: F401
    Snapshot,
    TornSnapshot,
    list_snapshots,
    load_latest,
    load_snapshot,
    spec_hash,
    write_snapshot,
)
