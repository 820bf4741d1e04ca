"""The lifecycle loop: durable feedback, retrain → gate → ``@shadow``,
promotion and rollback, and the hot swap on the serving path.

The watchtower (:mod:`fraud_detection_tpu_torch.monitor`) detects drift and
emits recommendations; this package acts on them:

- :mod:`store` — durable labeled feedback (window + reservoir) and the
  persisted, crash-resumable state machine;
- :mod:`retrain` — the warm-started refit on the card and the evaluation
  it hands the gate;
- :mod:`gate` — the challenger gate (AUC / ECE / score-PSI bounds);
- :mod:`conductor` — runs the state machine on the task queue's
  lifecycle tasks;
- :mod:`swap` — the hot model swap on the serving path (no restart).
"""

from fraud_detection_tpu_torch.lifecycle.conductor import (  # noqa: F401
    FEEDBACK_TASK,
    PROMOTE_TASK,
    ROLLBACK_TASK,
    Conductor,
)
from fraud_detection_tpu_torch.lifecycle.gate import (  # noqa: F401
    GateResult,
    GateThresholds,
    evaluate_gate,
)
from fraud_detection_tpu_torch.lifecycle.retrain import run_retrain  # noqa: F401
from fraud_detection_tpu_torch.lifecycle.store import (  # noqa: F401
    LifecycleStore,
    open_lifecycle_store,
)
from fraud_detection_tpu_torch.lifecycle.swap import (  # noqa: F401
    ModelReloader,
    ModelSlot,
    warm_scorer,
)
