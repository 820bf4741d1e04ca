"""The wide family's hashed entity crosses.

Each of the ``n_cross`` cross templates hashes the entity fingerprint with
one field the wire already carries — the amount bucket, the hour of day
from ``Time``, the sign pattern of the V columns, amount × hour — into a
table of ``2**log2_buckets`` learned weights. The template contributes ONE
column, ``contrib[:, c] = table[idx_c]``, so the widened block ``[x,
contrib]`` feeds the linear score body (the ``fused_score`` kernel at
``n_base + n_cross``), the drift fold and the linear-SHAP explain leg
unchanged. Rows without an entity (fingerprint 0) zero the whole wide
block: every template crosses the entity, so they score base-only.

The hash is the JAX package's multiply-shift (a Fibonacci mix, the murmur3
finalizer, one odd salt a template) on uint32. PyTorch's ``uint32`` has
almost no kernels, so here the values are ``int64`` tensors holding
0..2³²−1: every step is masked back to 32 bits, and every multiply by a
32-bit constant is split into its 16-bit halves (:func:`_mul32`), so that
no product exceeds 2⁴⁹ and the low 32 bits are exact on the CPU and the
card alike. The amount bucket ``floor(log1p(|a|)·8)`` is float32, as in
the JAX package; at exact bucket boundaries the last ulp of ``log1p``
differs between libraries, and so, rarely, does the bucket (ROADMAP queue
3). The fingerprint is ``int64`` on the device and ``uint32`` in files.

The JAX package's model-axis shard gather (``_gather_contrib_shard``) is
the sharded flush's, ROADMAP item 12.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device

WIDE_FILE = "wide_params.npz"

#: number of cross templates (the widened block gains this many columns)
N_CROSS = 4

#: names of the widened columns, in template order
CROSS_NAMES = (
    "cross_entity_amount",
    "cross_entity_hour",
    "cross_entity_signs",
    "cross_entity_amount_hour",
)

# the JAX package's constants: part of the artifact contract (the sidecar
# stamps HASH_VERSION)
_KNUTH = 2654435761
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_SALTS = (0x9E3779B1, 0x7F4A7C15, 0x94D049BB, 0xD6E8FEB9)
HASH_VERSION = 1

_MASK32 = 0xFFFFFFFF


class CrossSpec(NamedTuple):
    """Static geometry of the wide family."""

    n_base: int  # width of the wire schema the crosses derive from
    log2_buckets: int  # wide table size = 1 << log2_buckets
    amount_col: int  # Amount column in the base row (resolved, >= 0)
    time_col: int = 0  # Time column (seconds) for the hour-of-day key
    n_cross: int = N_CROSS

    @property
    def buckets(self) -> int:
        return 1 << self.log2_buckets

    @property
    def n_features(self) -> int:
        return self.n_base + self.n_cross

    @property
    def cross_names(self) -> tuple[str, ...]:
        return CROSS_NAMES[: self.n_cross]


def spec_from_config(n_base: int, amount_col: int | None = None) -> CrossSpec:
    """``WIDE_BUCKETS`` (a power of two) and ``LEDGER_AMOUNT_COL``."""
    from fraud_detection_tpu_torch import config

    buckets = config.wide_buckets()
    a = amount_col if amount_col is not None else config.ledger_amount_col()
    if a < 0:
        a += n_base
    return CrossSpec(n_base=n_base, log2_buckets=buckets.bit_length() - 1, amount_col=a)


# --------------------------------------------------------------------------
# The hash and the gather (the fused wide flush's body)
# --------------------------------------------------------------------------


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h · c mod 2³²`` for int64 ``h`` in [0, 2³²) and a 32-bit
    constant: ``h·c_lo + ((h·c_hi) mod 2¹⁶)·2¹⁶``, every term below 2⁴⁹."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on 32-bit values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _sign_cols(spec: CrossSpec) -> list[int]:
    """The (up to 24) base columns that are neither the time nor the amount
    key: the sign pattern's bits, in column order."""
    return [j for j in range(spec.n_base)
            if j not in (spec.time_col, spec.amount_col)][:24]


#: (spec, device) → the hash's constant tensors, made once: a flush then
#: copies nothing to the device for them
_CONSTANTS: dict = {}


def _constants(spec: CrossSpec, device: torch.device):
    """``(sign columns, their bit weights, the templates' salts)`` on
    ``device``, int64."""
    key = (spec, device)
    got = _CONSTANTS.get(key)
    if got is None:
        cols = _sign_cols(spec)
        got = _CONSTANTS[key] = (
            torch.tensor(cols, dtype=torch.int64, device=device),
            torch.tensor([1 << k for k in range(len(cols))], dtype=torch.int64, device=device),
            torch.tensor(_SALTS[: spec.n_cross], dtype=torch.int64, device=device),
        )
    return got


def _raw_cross_indices(xb: torch.Tensor, fp: torch.Tensor, *, spec: CrossSpec) -> torch.Tensor:
    """Per-row hashed cross indices, ``(b, n_cross)`` int64 in
    ``[0, buckets)``. ``xb`` is the f32 base block the model scores
    (dequantized on the int8 wire), ``fp`` the fingerprints (int64 holding
    0..2³²−1; 0 = none, whose rows the gather zeroes). The templates hash
    as one ``(b, n_cross)`` tensor, a handful of launches in all."""
    fp = fp.to(torch.int64)
    amount = xb[:, spec.amount_col]
    # log-spaced amount buckets, clipped to one byte (float32, as in JAX)
    abucket = torch.clamp(torch.floor(torch.log1p(amount.abs()) * 8.0), 0.0, 255.0).to(torch.int64)
    t = torch.clamp_min(xb[:, spec.time_col], 0.0)
    # fmod: exact, and the JAX package's mod for t >= 0
    hour = torch.fmod(torch.floor(t / 3600.0), 24.0).to(torch.int64)
    cols, weights, salts = _constants(spec, xb.device)
    if cols.numel():
        signs = ((xb.index_select(1, cols) > 0.0).to(torch.int64) * weights).sum(dim=1)
    else:
        signs = torch.zeros_like(fp)
    fields = torch.stack((abucket, hour, signs, abucket * 24 + hour)[: spec.n_cross], dim=1)
    h = ((fp[:, None] ^ _mul32(fields, _KNUTH)) + salts) & _MASK32
    return _mix32(h) >> (32 - spec.log2_buckets)


def _gather_contrib(wide_table: torch.Tensor, idx: torch.Tensor,
                    has_entity: torch.Tensor) -> torch.Tensor:
    """The widened block's cross columns: ``table[idx]``, zeroed for
    entity-less rows."""
    return wide_table[idx] * has_entity[:, None]


# --------------------------------------------------------------------------
# Host helpers (training, offline evaluation, tests)
# --------------------------------------------------------------------------


def _host_inputs(x, fps, device):
    """Raw base rows and uint32 fingerprints as the hash's tensors on
    ``device``."""
    xb = torch.as_tensor(np.asarray(x, np.float32), device=device)
    fp = torch.as_tensor(np.asarray(fps, np.uint32).astype(np.int64), device=device)
    return xb, fp


def cross_indices(x, fps, spec: CrossSpec, device=None) -> np.ndarray:
    """Cross indices of RAW base rows and uint32 fingerprints, as int32 —
    the values serving hashes — hashed on ``device`` (resolved as every
    entry point resolves it: ``cuda`` unless the caller asks for the
    CPU)."""
    xb, fp = _host_inputs(x, fps, resolve_device(device))
    return _raw_cross_indices(xb, fp, spec=spec).cpu().numpy().astype(np.int32)


def widen_with_crosses(x, fps, table, spec: CrossSpec, device=None) -> np.ndarray:
    """``[x, contrib]`` for offline evaluation: the widened block the fused
    flush builds, hashed and gathered on ``device`` (``cuda`` unless the
    caller asks for the CPU), so offline scores match serving's for those
    rows."""
    dev = resolve_device(device)
    xb, fp = _host_inputs(x, fps, dev)
    tbl = torch.as_tensor(table, dtype=torch.float32, device=dev)
    contrib = _gather_contrib(tbl, _raw_cross_indices(xb, fp, spec=spec),
                              (fp != 0).to(torch.float32))
    return torch.cat([xb, contrib], dim=1).cpu().numpy()


def widen_scaler(scaler, n_cross: int):
    """A base-schema scaler extended with identity columns (mean 0, scale 1)
    for the cross block: contributions are raw table weights, never
    standardized."""
    from fraud_detection_tpu_torch.ops.scaler import ScalerParams

    if scaler is None:
        return None

    def ext(t: torch.Tensor, fill: float) -> torch.Tensor:
        return torch.cat([t.float(), torch.full((n_cross,), fill, dtype=torch.float32,
                                                device=t.device)])

    return ScalerParams(mean=ext(scaler.mean, 0.0), scale=ext(scaler.scale, 1.0),
                        var=ext(scaler.var, 1.0), n_samples=scaler.n_samples)


def entity_fingerprints(entities, n: int) -> np.ndarray:
    """uint32 fingerprints of entity ids (None → 0, the null path): the
    ledger's edge hash, one keyspace across both."""
    from fraud_detection_tpu_torch.ledger.state import entity_fingerprint

    fps = np.zeros(n, np.uint32)
    for i, e in enumerate(entities or []):
        if i >= n:
            break
        if e is not None:
            fps[i] = entity_fingerprint(e)
    return fps


def save_wide(directory: str, spec: CrossSpec, table) -> str:
    """Stamp ``wide_params.npz`` (geometry + learned table) beside the
    model, with the JAX package's keys and dtypes."""
    from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez

    os.makedirs(directory, exist_ok=True)
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    return atomic_savez(
        os.path.join(directory, WIDE_FILE),
        hash_version=np.int64(HASH_VERSION),
        n_base=np.int64(spec.n_base),
        log2_buckets=np.int64(spec.log2_buckets),
        amount_col=np.int64(spec.amount_col),
        time_col=np.int64(spec.time_col),
        n_cross=np.int64(spec.n_cross),
        table=np.asarray(table, np.float32),
    )


def load_wide(directory: str) -> tuple[CrossSpec, np.ndarray] | None:
    """``(spec, table)`` from ``wide_params.npz``, or None without one.
    Raises on another ``hash_version``: such a table was learned under
    other hash constants."""
    path = os.path.join(directory, WIDE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["hash_version"]) != HASH_VERSION:
            raise ValueError(
                f"wide sidecar hash_version {int(z['hash_version'])} != "
                f"{HASH_VERSION} — the table was learned under different "
                "cross-hash constants and cannot serve"
            )
        spec = CrossSpec(
            n_base=int(z["n_base"]),
            log2_buckets=int(z["log2_buckets"]),
            amount_col=int(z["amount_col"]),
            time_col=int(z["time_col"]),
            n_cross=int(z["n_cross"]),
        )
        return spec, np.asarray(z["table"], np.float32)
