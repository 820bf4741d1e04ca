"""Training-side replay: materialize the widened features through the body
serving runs.

The port of the JAX package's ``ledger/replay.py``. ``materialize_features``
sorts the rows by timestamp (stable, so rows of one timestamp keep their
input order), replays them through
:func:`~fraud_detection_tpu_torch.ledger.features._ledger_read_update` in
fixed-size batches on the device, and returns the ``(n, K)`` velocity
features in the input row order with the final table. The rows' keys and
columns go to the device once; the batches are slices of them.

Base datasets (the Kaggle CSV) carry no entity ids, so
``synthesize_entities`` assigns seeded pseudo-entities and timestamps (the
``Time`` column when the schema has one, else row order) with numpy's
``default_rng``, so they equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ledger.features import _ledger_read_update
from fraud_detection_tpu_torch.ledger.state import (
    LedgerSpec,
    LedgerState,
    device_state,
    entity_fingerprint,
    entity_slot,
    host_state,
)

#: replay batch size. Rows of one batch read the pre-batch table, so the
#: batch partition is part of the replay's result; keep it stable
REPLAY_BATCH = 256


def synthesize_entities(
    x: np.ndarray,
    feature_names,
    seed: int = 0,
    events_per_entity: int = 50,
) -> tuple[list[str], np.ndarray]:
    """Seeded pseudo-entities + timestamps for an entity-less dataset: each
    row draws one of ``n / events_per_entity`` ids; timestamps come from
    the ``Time`` column when present (offset to start at 1), else one
    second a row."""
    n = x.shape[0]
    names = list(feature_names or [])
    rng = np.random.default_rng(seed)
    n_entities = max(n // max(events_per_entity, 1), 1)
    assignment = rng.integers(0, n_entities, size=n)
    entities = [f"sim-{int(e)}" for e in assignment]
    if "Time" in names:
        t = np.asarray(x[:, names.index("Time")], np.float64)
        ts = (t - t.min() + 1.0).astype(np.float32)
    else:
        ts = np.arange(n, dtype=np.float32) + 1.0
    return entities, ts


def row_keys(
    spec: LedgerSpec, entities, n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host half of the hash for a row list whose entries may be None
    (no entity): ``(slots int32, fingerprints uint32, has_entity f32)``.
    Each distinct entity is hashed once."""
    slots = np.zeros(n, np.int32)
    fps = np.zeros(n, np.uint32)
    has = np.zeros(n, np.float32)
    seen: dict = {}
    for i, e in enumerate(entities):
        if e is None:
            continue
        keys = seen.get(e)
        if keys is None:
            fp = entity_fingerprint(e)
            keys = seen[e] = (entity_slot(fp, spec.log2_slots), fp)
        slots[i], fps[i] = keys
        has[i] = 1.0
    return slots, fps, has


def materialize_features(
    spec: LedgerSpec,
    x: np.ndarray,
    entities,
    ts: np.ndarray,
    state: LedgerState | None = None,
    batch: int = REPLAY_BATCH,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, LedgerState]:
    """Replay ``x`` (n, n_base) in timestamp order through the serving body,
    from the host snapshot ``state`` (None: a fresh table), on ``device``
    (the card unless the caller asks for the CPU). Returns the features
    aligned to the input order and the final table as a host snapshot."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    ts = np.asarray(ts, np.float32).reshape(-1)
    if len(entities) != n or ts.shape[0] != n:
        raise ValueError("entities/ts must align with the rows")
    order = np.argsort(ts, kind="stable")
    slots, fps, has = row_keys(spec, [entities[i] for i in order], n)
    total = -(-n // batch) * batch  # the last batch padded with zero rows

    def col(a: np.ndarray, dtype) -> torch.Tensor:
        out = np.zeros(total, dtype)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    s_d = col(slots, np.int64)
    f_d = col(fps, np.int64)
    t_d = col(ts[order], np.float32)
    a_d = col(x[order, spec.amount_col], np.float32)
    h_d = col(has, np.float32)
    table = device_state(state, spec.slots, dev)
    null = torch.tensor(spec.null_features, dtype=torch.float32, device=dev)
    hl = torch.tensor(spec.halflife_s, dtype=torch.float32, device=dev)
    out = torch.empty((total, null.shape[0]), dtype=torch.float32, device=dev)
    for lo in range(0, total, batch):
        sl = slice(lo, lo + batch)
        out[sl] = _ledger_read_update(
            table, s_d[sl], f_d[sl], t_d[sl], a_d[sl], h_d[sl], null, hl
        )
    feats = np.zeros((n, null.shape[0]), np.float32)
    feats[order] = out[:n].cpu().numpy()
    return feats, host_state(table)
