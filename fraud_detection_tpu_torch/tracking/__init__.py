"""Experiment tracking and model registry, in the JAX package's layout and
on its wire. ``MLFLOW_TRACKING_URI`` selects the transport:

- ``file:./mlruns`` (or a bare path): the file store (``store.py``,
  ``registry.py``);
- ``http://host:5000``: a tracking server (``server.py``) through the HTTP
  client (``http_client.py``), so trainer, API and workers share one
  registry without a shared filesystem. Either package's client talks to
  either package's server.
"""

from fraud_detection_tpu_torch.tracking.registry import ModelRegistry  # noqa: F401
from fraud_detection_tpu_torch.tracking.store import Run  # noqa: F401
from fraud_detection_tpu_torch.tracking.store import (  # noqa: F401
    TrackingClient as FileTrackingClient,
)


def TrackingClient(uri: str | None = None):
    """Open a tracking client for ``uri`` (default ``MLFLOW_TRACKING_URI``):
    the HTTP client for ``http(s)://`` URIs, else the file store."""
    from fraud_detection_tpu_torch import config

    uri = uri or config.tracking_uri()
    if uri.startswith(("http://", "https://")):
        from fraud_detection_tpu_torch.tracking.http_client import HttpTrackingClient

        return HttpTrackingClient(uri)
    return FileTrackingClient(uri)
