"""The serving mesh: the ``(data × model)`` grid the sharded flush splits
over (the JAX package's ``mesh/topology.py``).

Every shard lives on the serving device (``parallel/mesh``): the grid is
the port's counterpart of JAX's virtual host devices, so its size is not
clamped to a device count. It keeps JAX's other clamps: the data axis is
floored to a power of two (flush buckets are powers of two and every bucket
must split evenly) and capped at :data:`MAX_FLUSH_SHARDS`, the smallest
flush bucket (a lone-request flush pads to 8 rows and must still hand
every shard one). The model axis (``MESH_MODEL_DEVICES``, a power of two)
column-shards the wide family's cross table; the narrow and ledger
families split their rows over the flattened ``data × model`` grid, so the
grid as a whole stays within :data:`MAX_FLUSH_SHARDS`.
"""

from __future__ import annotations

import logging

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.parallel.mesh import Mesh, MeshSpec, create_mesh

log = logging.getLogger("fraud_detection_tpu_torch.mesh")

#: the most flush shards: the serving scorers' smallest bucket (min_bucket
#: 8) — a lone-request flush pads to it and must hand every shard a row
MAX_FLUSH_SHARDS = 8


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def serving_mesh_size(requested: int | None = None) -> int:
    """The serving mesh's data axis: ``requested`` (default
    ``MESH_FLUSH_DEVICES``) capped at :data:`MAX_FLUSH_SHARDS` and floored
    to a power of two; 0 and 1 resolve to 1 (the single-window flush)."""
    n = config.mesh_flush_devices() if requested is None else requested
    if n <= 1:
        return 1
    if n > MAX_FLUSH_SHARDS:
        log.warning(
            "MESH_FLUSH_DEVICES=%d exceeds the smallest flush bucket (%d) — "
            "clamping; a lone-request flush could not hand every shard a row",
            n, MAX_FLUSH_SHARDS,
        )
        n = MAX_FLUSH_SHARDS
    while not _is_pow2(n):
        n -= 1
    return n


def serving_mesh_model_size(requested: int | None = None) -> int:
    """The serving mesh's model axis (``MESH_MODEL_DEVICES``): 0 and 1
    resolve to 1; above 1 it must be a power of two (the wide family's
    power-of-two table column-shards evenly only then), else
    ``ValueError``."""
    m = config.mesh_model_devices() if requested is None else requested
    if m <= 1:
        return 1
    if not _is_pow2(m):
        raise ValueError(
            f"MESH_MODEL_DEVICES must be a power of two (the wide bucket "
            f"table must column-shard evenly), got {m}"
        )
    return m


def serving_mesh(
    n_shards: int | None = None, devices=None, model_devices: int | None = None
) -> Mesh:
    """The ``(data × model)`` serving grid on the serving device
    (``devices``: one repeated device, default ``DEVICE``'s). ``n_shards``
    None resolves ``MESH_FLUSH_DEVICES`` through :func:`serving_mesh_size`
    and, when the grid would exceed :data:`MAX_FLUSH_SHARDS`, clamps the
    data axis with a warning; an explicit size must be a power of two and
    the grid no larger than :data:`MAX_FLUSH_SHARDS`. ``model_devices``
    None reads ``MESH_MODEL_DEVICES``."""
    m = serving_mesh_model_size(model_devices)
    n = serving_mesh_size() if n_shards is None else n_shards
    if m > 1 and n_shards is None and n * m > MAX_FLUSH_SHARDS:
        log.warning(
            "MESH_FLUSH_DEVICES×MESH_MODEL_DEVICES = %d×%d exceeds the smallest "
            "flush bucket (%d) — clamping the data axis", n, m, MAX_FLUSH_SHARDS,
        )
        n = max(MAX_FLUSH_SHARDS // m, 1)
    if not _is_pow2(n):
        raise ValueError(
            f"serving mesh data-axis size must be a power of two (flush "
            f"buckets must divide evenly across shards), got {n}"
        )
    if n * m > MAX_FLUSH_SHARDS:
        raise ValueError(
            f"serving mesh {n}×{m} = {n * m} shards exceed the smallest flush "
            f"bucket ({MAX_FLUSH_SHARDS}) — every bucket must hand each shard a row"
        )
    if devices is None:
        devices = [resolve_device()]
    devices = list(devices)
    if len(devices) == 1:
        devices = devices * (n * m)
    return create_mesh(MeshSpec(data=n, model=m), devices=devices)
