"""High-level model classes tying together params, scaler, and metadata."""

import os

from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel  # noqa: F401

#: sidecars of the families this slice does not serve yet → ROADMAP item
_UNPORTED_SIDECARS = {
    "ledger_state.npz": "the ledger-widened family (ROADMAP queue 1, item 9)",
    "wide_params.npz": "the wide family (ROADMAP queue 1, item 10)",
}


def load_any_model(directory: str, device=None):
    """Load the model family the artifact directory holds. Only the plain
    logistic family is ported; a GBT, ledger or wide artifact raises
    ``NotImplementedError`` naming the ROADMAP item that ports it."""
    from fraud_detection_tpu_torch.ckpt.checkpoint import artifact_kind

    kind = artifact_kind(directory)
    if kind == "gbt":
        raise NotImplementedError(
            f"{directory} holds a GBT forest: the GBT family is not ported "
            "yet (ROADMAP queue 1, item 7)"
        )
    for sidecar, family in _UNPORTED_SIDECARS.items():
        if os.path.exists(os.path.join(directory, sidecar)):
            raise NotImplementedError(
                f"{directory} carries {sidecar}: {family} is not ported yet"
            )
    return FraudLogisticModel.load(directory, device=device)
