"""The ledger's read-update body — the one place velocity features are
computed.

The port of the JAX package's ``ledger/features.py``. ``_ledger_read_update``
is called by the serving flush (``monitor/drift._fused_flush_ledger``), by
the training replay (:mod:`.replay`) and by the tests, so a model fitted on
the replay's columns is scored with the same expression. The JAX package
computes it in XLA, outside any Pallas kernel; here it is plain tensor ops
(one fused CUDA read-update kernel is later work, ROADMAP beside item 15b).

Semantics:

- **reads** see the pre-batch table decayed to each row's own timestamp:
  ``decayed = acc · 2^(−Δt/halflife)``. A first-seen entity (anchor 0)
  reads empty aggregates; an entity-less row reads the spec's
  ``null_features``.
- **writes** fold the whole batch against a per-slot anchor: the slot's new
  ``last_ts`` is the max of its rows' timestamps, the old accumulators
  decay to that anchor, and each row's contribution decays from its own
  timestamp to the anchor before it is added.
- **determinism on the card**: the maxima are ``scatter_reduce_("amax")``
  (order-free); the pre-decayed accumulators are a scatter of values that
  every row of a slot computes alike; the adds are an accumulating
  ``index_put_``, which sorts the slots and adds a slot's rows in their
  batch order, so its bits do not change from run to run as a float-atomic
  ``index_add_``'s do. On the CPU the adds are ``index_add_``, which adds
  the rows in ascending order, as XLA's CPU scatter does.
- **padding and entity-less rows** carry weight 0: they add exact zeros
  and push a 0 anchor, leaving every slot bitwise unchanged.
- **a row's bits do not depend on its position in the batch**, so the
  lifeboat's replay of a journaled flush (its entity rows alone, in
  another bucket) lands on the bits serving computed. On the CUDA card
  every element takes the same code; on the CPU ATen's loop takes a
  vectorized ``exp2`` over whole vectors and the scalar ``std::exp2`` on
  the tail, which differ in the last bit, so :func:`_exp2` pads its input
  to whole vectors there. That holds while ATen runs the op as one chunk,
  n ≤ ``GRAIN_SIZE`` (32768 elements): above it ``parallel_for`` splits
  the range at points that need not fall on a vector boundary. A replay
  batch is 256 rows and a flush at most ``SCORER_MAX_BATCH`` (1024 by
  default).
- **poison guard**: the amount is ``nan_to_num``-ed and clipped to
  ``±AMOUNT_CLIP`` before it touches an accumulator, the z-score clipped to
  ``±ZSCORE_CLIP``, the slot index clipped into the table.
"""

from __future__ import annotations

import torch

from fraud_detection_tpu_torch.ledger.state import (
    AMOUNT_CLIP,
    ZSCORE_CLIP,
    LedgerState,
)


#: elements a CPU ``exp2`` is padded to a multiple of: ATen's loop takes
#: two vectors a step, 32 floats on the widest ISA it dispatches to
#: (AVX-512: 16 floats a vector); 64 is a multiple of that and of every
#: narrower ISA's step. Position-independent bits need one chunk too:
#: n ≤ GRAIN_SIZE (32768), see the module docstring
_CPU_VECTOR_PAIR = 64


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """``torch.exp2`` of a 1-D tensor whose bits do not depend on an
    element's position: on the CPU the input is padded to whole vector
    pairs so that no element falls to the scalar tail loop."""
    pad = -x.shape[0] % _CPU_VECTOR_PAIR
    if x.device.type != "cpu" or pad == 0:
        return torch.exp2(x)
    return torch.exp2(torch.nn.functional.pad(x, (0, pad)))[: x.shape[0]]


def _ledger_read_update(
    state: LedgerState,
    slot_idx: torch.Tensor,    # (n,) integer table slot per row
    fp: torch.Tensor,          # (n,) int64 entity fingerprint (0 = none)
    ts: torch.Tensor,          # (n,) f32 event time, > 0 for entity rows
    amount: torch.Tensor,      # (n,) f32 transaction amount (pre-clamp)
    has_entity: torch.Tensor,  # (n,) f32 1.0 where the row carries an entity
    null_features: torch.Tensor,  # (K,) f32 features for entity-less rows
    halflife_s: torch.Tensor,  # () f32 decay half-life
) -> torch.Tensor:
    """Read K velocity features per row and fold the batch into ``state``,
    updated in place (the counterpart of the reference's donated table,
    which it returns beside the features). Returns the (n, K) features."""
    inv_hl = 1.0 / torch.clamp_min(halflife_s, 1e-6)
    w = has_entity.float()
    slot_idx = slot_idx.long().clamp(0, state.acc.shape[0] - 1)
    a = torch.nan_to_num(
        amount, nan=0.0, posinf=AMOUNT_CLIP, neginf=-AMOUNT_CLIP
    ).clamp(-AMOUNT_CLIP, AMOUNT_CLIP)
    ts = torch.nan_to_num(ts, nan=0.0, posinf=0.0, neginf=0.0).clamp_min(0.0)

    # ---- read: the pre-batch table decayed to each row's timestamp ------
    prev_acc = state.acc[slot_idx]  # (n, 3) one gather for all three
    prev_cnt, prev_sum, prev_ssq = prev_acc.unbind(1)
    prev_ts = state.last_ts[slot_idx]
    prev_fp = state.fingerprint[slot_idx]
    seen = (prev_ts > 0.0).float()
    dt = (ts - prev_ts).clamp_min(0.0)
    f_row = _exp2(-dt * inv_hl) * seen
    dcnt = prev_cnt * f_row
    dsum = prev_sum * f_row
    dssq = prev_ssq * f_row
    mean = dsum / dcnt.clamp_min(1.0)
    var = (dssq / dcnt.clamp_min(1.0) - mean * mean).clamp_min(0.0)
    # +1 in the denominator: a bounded z for near-degenerate histories
    z = ((a - mean) / torch.sqrt(var + 1.0)).clamp(-ZSCORE_CLIP, ZSCORE_CLIP) * (
        dcnt >= 2.0
    )
    # never-seen entities read the horizon sentinel (8 half-lives)
    tsl = torch.where(seen > 0.0, torch.log1p(dt), torch.log1p(8.0 * halflife_s))
    feats = torch.stack([dcnt, dsum, tsl, z], dim=1)
    feats = torch.where(w[:, None] > 0.0, feats, null_features[None, :])

    # ---- write: the deterministic fold ----------------------------------
    # padding and entity-less rows push a 0 anchor (a no-op under max)
    state.last_ts.scatter_reduce_(0, slot_idx, ts * w, "amax", include_self=True)
    anchor = state.last_ts[slot_idx]
    # old accumulators decay from their previous anchor to the new one: a
    # per-slot factor, so every row of a slot scatters the same value; a
    # slot touched only by weight-0 rows keeps its anchor and is rewritten
    # times exp2(-0) = 1, bitwise unchanged
    f_anchor = _exp2(-(anchor - prev_ts) * inv_hl)
    state.acc.index_put_((slot_idx,), prev_acc * f_anchor[:, None])
    # each row's event decays from its own timestamp to the slot anchor
    g = _exp2(-(anchor - ts).clamp_min(0.0) * inv_hl) * w
    ga = g * a
    upd = torch.stack([g, ga, ga * a], dim=1)
    if state.acc.device.type == "cpu":
        state.acc.index_add_(0, slot_idx, upd)
    else:
        state.acc.index_put_((slot_idx,), upd, accumulate=True)
    # fingerprint: "latest writer" telemetry, max over a slot's rows; the
    # collision accounting compares against the pre-batch owner
    fp_eff = torch.where(w > 0.0, fp, torch.zeros_like(fp))
    state.fingerprint.scatter_reduce_(0, slot_idx, fp_eff, "amax", include_self=True)
    mismatch = w * (prev_fp != fp).float() * (prev_fp != 0).float()
    live = (dcnt > 0.5).float()
    state.collisions.add_((mismatch * live).sum())
    state.evictions.add_((mismatch * (1.0 - live)).sum())
    return feats


def ledger_stats(state: LedgerState, halflife_s: float | None = None) -> dict:
    """Scrape-time table telemetry as host floats: ``slot_occupancy`` is the
    fraction of slots whose count, decayed to the table's own clock (its
    latest anchor: slots decay lazily on writes), is still ≥ 0.5 — the
    occupancy alert's input, which drops entities that stopped
    transacting; ``slots_claimed_frac`` is the ever-claimed fraction.
    ``halflife_s`` None reports the undecayed view. ``state`` may be the
    device table or a host snapshot."""
    acc, last_ts, coll, evic = (
        torch.as_tensor(state[i]) for i in (0, 1, 3, 4)
    )
    hl = torch.tensor(
        float(halflife_s) if halflife_s else float("inf"),
        dtype=torch.float32, device=last_ts.device,
    )
    claimed = (last_ts > 0.0).float()
    inv_hl = 1.0 / torch.clamp_min(hl, 1e-6)
    decayed = acc[..., 0] * torch.exp2(-(last_ts.max() - last_ts) * inv_hl)
    active = claimed * (decayed >= 0.5).float()
    n = last_ts.shape[0]
    occ, frac, c, e = torch.stack(
        [active.sum() / n, claimed.sum() / n, coll.float(), evic.float()]
    ).tolist()
    return {
        "slot_occupancy": occ,
        "slots_claimed_frac": frac,
        "hash_collisions": c,
        "evictions": e,
    }
