"""The benchmark measures the PyTorch port only: no module of JAX, of its
libraries or of the JAX package may be loaded in a run's process."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "fraud_detection_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level
    name, the part before the first dot, is one of :data:`FORBIDDEN` as a
    whole word: ``fraud_detection_tpu_torch`` passes."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
