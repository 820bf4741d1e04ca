"""Experiment tracking and model registry: the file store of the JAX
package's layout. ``MLFLOW_TRACKING_URI`` selects the store; the HTTP
tracking client is a later slice of the port."""

from fraud_detection_tpu_torch.tracking.registry import ModelRegistry  # noqa: F401
from fraud_detection_tpu_torch.tracking.store import Run  # noqa: F401
from fraud_detection_tpu_torch.tracking.store import (  # noqa: F401
    TrackingClient as FileTrackingClient,
)


def TrackingClient(uri: str | None = None):
    """Open a tracking client for ``uri`` (default ``MLFLOW_TRACKING_URI``):
    the file store for ``file:`` URIs and bare paths. An ``http(s)://`` URI
    raises ``NotImplementedError``: the HTTP client is not ported yet."""
    from fraud_detection_tpu_torch import config

    uri = uri or config.tracking_uri()
    if uri.startswith(("http://", "https://")):
        raise NotImplementedError(
            f"tracking URI {uri}: the HTTP tracking client is not ported yet "
            "(ROADMAP queue 1, item 8, the service shell); use a file: URI"
        )
    return FileTrackingClient(uri)
