"""High-level model classes tying together params, scaler, and metadata."""

from fraud_detection_tpu_torch.models.gbt import FraudGBTModel  # noqa: F401
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel  # noqa: F401


def load_any_model(directory: str, device=None):
    """Load the model family the artifact directory holds: the logistic
    family (ledger-widened when ``ledger_state.npz`` lies beside it, wide
    when ``wide_params.npz`` does) or a GBT forest (which, as in the JAX
    package, ignores a widening sidecar: both widen the logistic family
    only)."""
    from fraud_detection_tpu_torch.ckpt.checkpoint import artifact_kind

    if artifact_kind(directory) == "gbt":
        return FraudGBTModel.load(directory, device=device)
    return FraudLogisticModel.load(directory, device=device)
