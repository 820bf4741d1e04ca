"""Request/response schemas — the typed API contract, standard library only.

Dataclasses for the response bodies and hand validation for the request
body, with the same field names and the same client-facing 422 messages as
the JAX package's pydantic schemas (``fraud_detection_tpu/service/
schemas.py``), so either app answers a client identically.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class ReasonCodeOut:
    """One serve-time reason code: the feature and its exact
    interventional linear-SHAP attribution toward the fraud score."""

    feature: str
    attribution: float


@dataclass(frozen=True)
class PredictionOut:
    prediction: int
    score: float
    transaction_id: str
    correlation_id: str
    explanation_status: str
    #: top-k reason codes, highest attribution first — present when
    #: SCORER_EXPLAIN=topk; null otherwise
    reason_codes: list[ReasonCodeOut] | None = None

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class ExplanationOut:
    """A COMPLETED ``GET /explain/{transaction_id}`` body."""

    transaction_id: str
    status: str
    shap_values: dict[str, float]
    expected_value: float
    prediction_score: float | None = None
    created_at: float | None = None

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class ExplanationFailedOut:
    """A FAILED ``GET /explain/{transaction_id}`` body."""

    transaction_id: str
    status: str
    error: str | None = None

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class HealthOut:
    status: str
    checks: dict[str, str]
    model_source: str | None
    uptime_seconds: float

    def to_dict(self) -> dict:
        return asdict(self)


def parse_transaction(payload) -> list[float] | dict[str, float]:
    """Validate the /predict body → features (list or dict).

    Raises ValueError with a client-facing message (→ 422)."""
    if not isinstance(payload, dict) or "features" not in payload:
        raise ValueError("body must be an object with a 'features' field")
    features = payload["features"]
    if isinstance(features, dict):
        if not features:
            raise ValueError("'features' must not be empty")
        try:
            return {str(k): float(v) for k, v in features.items()}
        except (TypeError, ValueError) as e:
            raise ValueError(f"non-numeric feature value: {e}") from e
    if isinstance(features, list):
        if not features:
            raise ValueError("'features' must not be empty")
        try:
            return [float(v) for v in features]
        except (TypeError, ValueError) as e:
            raise ValueError(f"non-numeric feature value: {e}") from e
    raise ValueError("'features' must be a list or an object")


def parse_entity(payload) -> tuple[str | None, float | None]:
    """Validate the optional entity fields of a /predict body →
    ``(entity_id, timestamp)``: the ledger's key and event time for a
    ledger-widened model (a stateless family ignores them); a malformed one
    answers the same 422 as in the JAX app.

    Raises ValueError with a client-facing message (→ 422)."""
    entity_id = payload.get("entity_id")
    if entity_id is not None:
        if not isinstance(entity_id, (str, int)) or isinstance(entity_id, bool):
            raise ValueError("'entity_id' must be a string or integer")
        entity_id = str(entity_id)
        if not entity_id or len(entity_id) > 256:
            raise ValueError("'entity_id' must be 1-256 characters")
    ts = payload.get("timestamp")
    if ts is not None:
        try:
            ts = float(ts)
        except (TypeError, ValueError) as e:
            raise ValueError(f"'timestamp' must be a number: {e}") from e
        if not (ts > 0) or ts != ts or ts == float("inf"):
            raise ValueError("'timestamp' must be a positive finite number")
    return entity_id, ts
