"""Ledger state: the hashed per-entity accumulator table.

The port's own copy of the JAX package's ``ledger/state.py``. A fixed-size,
power-of-two table of time-decayed aggregates keyed by a multiply-shift
hash of the request's ``entity_id`` (the card, account or device a
transaction belongs to). One slot holds:

- ``count`` — exponentially time-decayed event count,
- ``amount_sum`` / ``amount_sumsq`` — decayed sum and sum of squares of the
  (clipped) transaction amount, the z-score's inputs,
- ``last_ts`` — the slot's decay anchor (0 = never seen),
- ``fingerprint`` — the 32-bit entity hash of the slot's latest writer,
  telemetry only: colliding entities share the slot's aggregates (a
  mismatch only feeds the collision and eviction counters).

The table lives on the device as one set of tensors that every ledger
flush updates in place (the counterpart of the reference's donated
pytree). ``ledger_state.npz`` beside ``model.npz`` carries the table and
the :class:`LedgerSpec` (hash geometry, decay horizon, clock origin and the
null-entity features) with the reference's keys and dtypes, so either
package serves the other's artifact.

The fingerprint is ``uint32`` in the file; on the device it is ``int64``
holding 0..2³²−1 (PyTorch's ``uint32`` has almost no kernels), cast exactly
at save and load.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

LEDGER_FILE = "ledger_state.npz"

#: the K velocity features the ledger widens the feature vector with, in
#: column order (appended after the base schema)
LEDGER_FEATURE_NAMES = (
    "LedgerCount",      # decayed event count for the entity (pre-event)
    "LedgerAmountSum",  # decayed amount sum for the entity (pre-event)
    "LedgerTimeSince",  # log1p(seconds since the entity's last event)
    "LedgerAmountZ",    # this amount's z-score against the entity's history
)
LEDGER_K = len(LEDGER_FEATURE_NAMES)

#: poison clamp on the amount feeding the accumulators: a NaN/Inf or absurd
#: amount folds in as a bounded value; clip² bounds one sumsq term at 1e12,
#: far from float32 overflow
AMOUNT_CLIP = 1e6

#: z-score clamp — an extreme but finite amount yields a bounded feature
ZSCORE_CLIP = 8.0

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
#: Knuth's multiplicative constant — the multiply-shift slot hash
_MULT = 0x9E3779B1


def entity_fingerprint(entity_id) -> int:
    """Stable 32-bit fingerprint of an entity id (string or int): FNV-1a
    over the utf-8 of ``str(entity_id)``, folded to 32 bits. 0 is reserved
    (no entity), so an entity hashing to 0 is nudged to 1."""
    h = _FNV_OFFSET
    for b in str(entity_id).encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    fp = (h ^ (h >> 32)) & 0xFFFFFFFF
    return fp or 1


def entity_slot(fingerprint: int, log2_slots: int) -> int:
    """Multiply-shift: the top ``log2_slots`` bits of ``fp · 2654435761``
    (mod 2³²)."""
    return ((fingerprint * _MULT) & 0xFFFFFFFF) >> (32 - log2_slots)


class LedgerState(NamedTuple):
    """The table: tensors with a leading ``(slots,)`` axis, on the device
    that serves or replays (numpy arrays on the host, in the file's dtypes,
    where :func:`host_state` or :func:`load_ledger` made them). The three
    decayed accumulators live packed in one ``(S, 3)`` tensor, so the fold
    is two scatters over rank-2 updates; the properties name the columns."""

    acc: torch.Tensor          # (S, 3) f32 decayed [count, Σamount, Σamount²]
    last_ts: torch.Tensor      # (S,) f32 decay anchor; 0 = never seen
    fingerprint: torch.Tensor  # (S,) int64 (device) / uint32 (host) latest writer
    collisions: torch.Tensor   # () f32 writes into a live slot of another entity
    evictions: torch.Tensor    # () f32 takeovers of a faded slot

    @property
    def count(self):
        return self.acc[..., 0]

    @property
    def amount_sum(self):
        return self.acc[..., 1]

    @property
    def amount_sumsq(self):
        return self.acc[..., 2]


@dataclass(frozen=True)
class LedgerSpec:
    """Everything serving needs to widen the feature vector, stamped in
    ``ledger_state.npz`` beside the model so the hash geometry, decay
    horizon and null-entity features travel with the weights fitted on
    them."""

    n_base: int                 # features clients send (the wire schema)
    slots: int                  # table size, a power of two
    halflife_s: float           # decay half-life of the aggregates
    amount_col: int             # index of the Amount column in the base row
    #: subtracted from wall-clock event times before they enter the f32
    #: table: raw unix epochs (~1.7e9) are beyond float32's integer
    #: resolution, so the table keeps an origin-relative clock, stamped at
    #: train time so that serving continues the replay's clock
    ts_origin: float = 0.0
    #: (K,) raw-space features for entity-less rows: the training rows'
    #: mean velocity features, so a legacy client's rows score at the
    #: training distribution's centre
    null_features: np.ndarray = None

    def __post_init__(self):
        if self.slots & (self.slots - 1) or self.slots <= 0:
            raise ValueError(f"LEDGER_SLOTS must be a power of two, got {self.slots}")
        nf = np.asarray(
            self.null_features
            if self.null_features is not None
            else np.zeros(LEDGER_K, np.float32),
            np.float32,
        ).reshape(-1)
        if nf.shape[0] != LEDGER_K:
            raise ValueError(
                f"null_features must have {LEDGER_K} entries, got {nf.shape[0]}"
            )
        object.__setattr__(self, "null_features", nf)

    @property
    def log2_slots(self) -> int:
        return int(self.slots).bit_length() - 1

    @property
    def n_features(self) -> int:
        """The widened width the model scores."""
        return self.n_base + LEDGER_K

    @property
    def feature_names(self) -> tuple[str, ...]:
        return LEDGER_FEATURE_NAMES

    def row_keys(self, entity_id) -> tuple[int, int]:
        """(slot, fingerprint) of one request's entity: the host half of
        the hash, computed once at the edge."""
        fp = entity_fingerprint(entity_id)
        return entity_slot(fp, self.log2_slots), fp

    def widen(self, x: np.ndarray) -> np.ndarray:
        """Base-width rows widened with the null features (what an
        entity-less row scores with); rows of any other width as they
        are."""
        x = np.asarray(x, np.float32)
        if x.shape[1] != self.n_base:
            return x
        nf = np.broadcast_to(self.null_features, (x.shape[0], LEDGER_K))
        return np.concatenate([x, nf], axis=1)

    def rel_ts(self, epoch_ts: float) -> float:
        """Origin-relative event time for the f32 table, computed in
        float64 and strictly > 0 (0 is the never-seen sentinel)."""
        return max(float(epoch_ts) - self.ts_origin, 1e-3)

    @classmethod
    def from_config(cls, n_base: int, null_features=None) -> "LedgerSpec":
        from fraud_detection_tpu_torch import config

        return cls(
            n_base=n_base,
            slots=config.ledger_slots(),
            halflife_s=config.ledger_halflife_s(),
            amount_col=config.ledger_amount_col(),
            null_features=(
                np.zeros(LEDGER_K, np.float32)
                if null_features is None
                else np.asarray(null_features, np.float32)
            ),
        )


def init_state(slots: int) -> LedgerState:
    """A fresh host table, in the file's dtypes."""
    return LedgerState(
        acc=np.zeros((slots, 3), np.float32),
        last_ts=np.zeros((slots,), np.float32),
        fingerprint=np.zeros((slots,), np.uint32),
        collisions=np.zeros((), np.float32),
        evictions=np.zeros((), np.float32),
    )


def device_state(state: LedgerState | None, slots: int,
                 device: str | torch.device = "cpu") -> LedgerState:
    """A host snapshot (or None: a fresh table) copied to ``device``: new
    tensors, never views of the snapshot's arrays, since the flush updates
    them in place. The fingerprint goes to int64."""
    st = state if state is not None else init_state(slots)
    acc, last_ts, fp, coll, evic = (np.asarray(leaf) for leaf in st)
    return LedgerState(
        acc=torch.tensor(acc, dtype=torch.float32, device=device),
        last_ts=torch.tensor(last_ts, dtype=torch.float32, device=device),
        fingerprint=torch.tensor(fp.astype(np.int64), dtype=torch.int64, device=device),
        collisions=torch.tensor(coll, dtype=torch.float32, device=device),
        evictions=torch.tensor(evic, dtype=torch.float32, device=device),
    )


def host_state(state: LedgerState) -> LedgerState:
    """The table as numpy arrays in the file's dtypes (the fingerprint back
    to uint32, exactly: the device holds 0..2³²−1)."""
    acc, last_ts, fp, coll, evic = (
        t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        for t in state
    )
    return LedgerState(
        acc=np.asarray(acc, np.float32),
        last_ts=np.asarray(last_ts, np.float32),
        fingerprint=np.asarray(fp).astype(np.uint32),
        collisions=np.asarray(coll, np.float32),
        evictions=np.asarray(evic, np.float32),
    )


def save_ledger(directory: str, spec: LedgerSpec, state: LedgerState) -> str:
    """Stamp ``ledger_state.npz`` (spec + table snapshot) beside the model
    artifacts, with the reference's keys and dtypes."""
    from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez

    os.makedirs(directory, exist_ok=True)
    host = host_state(state)
    return atomic_savez(
        os.path.join(directory, LEDGER_FILE),
        n_base=np.int64(spec.n_base),
        slots=np.int64(spec.slots),
        halflife_s=np.float64(spec.halflife_s),
        amount_col=np.int64(spec.amount_col),
        ts_origin=np.float64(spec.ts_origin),
        null_features=np.asarray(spec.null_features, np.float32),
        acc=host.acc,
        last_ts=host.last_ts,
        fingerprint=host.fingerprint,
        collisions=host.collisions,
        evictions=host.evictions,
    )


def load_ledger(directory: str) -> tuple[LedgerSpec, LedgerState] | None:
    """The stamped spec + host snapshot; None when the directory carries no
    ledger (a stateless model)."""
    path = os.path.join(directory, LEDGER_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        spec = LedgerSpec(
            n_base=int(z["n_base"]),
            slots=int(z["slots"]),
            halflife_s=float(z["halflife_s"]),
            amount_col=int(z["amount_col"]),
            ts_origin=float(z["ts_origin"]) if "ts_origin" in z else 0.0,
            null_features=np.asarray(z["null_features"], np.float32),
        )
        state = LedgerState(
            acc=np.asarray(z["acc"], np.float32),
            last_ts=np.asarray(z["last_ts"], np.float32),
            fingerprint=np.asarray(z["fingerprint"], np.uint32),
            collisions=np.asarray(z["collisions"], np.float32),
            evictions=np.asarray(z["evictions"], np.float32),
        )
    return spec, state
