"""High-level model classes tying together params, scaler, and metadata."""

import os

from fraud_detection_tpu_torch.models.gbt import FraudGBTModel  # noqa: F401
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel  # noqa: F401

#: sidecars of the families the port does not serve yet → ROADMAP item
_UNPORTED_SIDECARS = {
    "wide_params.npz": "the wide family (ROADMAP queue 1, item 10)",
}


def load_any_model(directory: str, device=None):
    """Load the model family the artifact directory holds: the logistic
    family (ledger-widened when ``ledger_state.npz`` lies beside it) or a
    GBT forest (which, as in the JAX package, ignores a ledger sidecar: the
    ledger widens the logistic family only). A wide artifact raises
    ``NotImplementedError`` naming the ROADMAP item that ports it."""
    from fraud_detection_tpu_torch.ckpt.checkpoint import artifact_kind

    for sidecar, family in _UNPORTED_SIDECARS.items():
        if os.path.exists(os.path.join(directory, sidecar)):
            raise NotImplementedError(
                f"{directory} carries {sidecar}: {family} is not ported yet"
            )
    if artifact_kind(directory) == "gbt":
        return FraudGBTModel.load(directory, device=device)
    return FraudLogisticModel.load(directory, device=device)
