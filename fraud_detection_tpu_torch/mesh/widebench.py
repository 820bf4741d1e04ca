"""Broadside probe: the wide family's 2-D flush over virtual shards (the
JAX package's ``mesh/widebench.py``).

Prints exactly one JSON line with JAX's keys::

    python -m fraud_detection_tpu_torch.mesh.widebench    # on DEVICE (default cuda)

Its gates:

- **2-D parity**: the (data × model)-sharded wide flush's scores AND top-k
  reason codes bitwise-match the single-device wide flush at 2×2, 4×2 and
  2×4 (each cross index lives on exactly one model shard, so the one sum
  over the model axis adds one real value and M−1 exact zeros);
- **zero-alloc staging**: steady-state wide flushes draw the same pooled
  slot, fingerprint lanes included — allocations exactly 0;
- **cost ratio**: the wide flush (hash + 2¹⁴-bucket gather + widened fold
  + explain leg) against the narrow flush on the same bucket, floored at
  :data:`WIDE_CPU_FLOOR`;
- **model-axis scaling**: at a data axis of 2, growing the model axis
  must shard the table EXACTLY — a model shard's cross-weight bytes,
  read from the live layout (``MeshDriftMonitor._placed_wide_table``),
  halve as M doubles — and not collapse the rate below
  :data:`WIDE_MODEL_CPU_FLOOR` against M = 1.

JAX keeps a grid only while it fits ``jax.device_count()``; the port's
shards are virtual, all on the serving device, so the grids are bounded by
``topology.MAX_FLUSH_SHARDS`` and every grid is measured on one card.
"""

from __future__ import annotations

import json
import time

import numpy as np

#: wide-vs-narrow flush rate floor. JAX measured ~0.16-0.25× on
#: shared-core CPU hosts (XLA CPU runs the gather serially) and set 0.10.
#: On one card both flushes are bound by their host launches, and the
#: floor bounds the wide flush's extra launches (the hash, the gather,
#: the widened fold): a ratio below it is a collapse, not a cost.
WIDE_CPU_FLOOR = 0.10

#: model-axis non-collapse floor: rate(data=2, M) / rate(data=2, M=1).
#: Rows are replicated over the model axis and every shard shares one
#: device, so M shards add the model-axis sum and the per-shard fold
#: while sharding only the gather. On the card it bounds that overhead
#: (a stray collective or a re-layout a flush would fall below it), not a
#: speedup; JAX measured ~0.15-0.35 at M = 4 on CPU hosts.
WIDE_MODEL_CPU_FLOOR = 0.08

#: the probe's scoring calls, each one ``fused_score`` launch on the card:
#: its flushes and the two profiles' scorings in ``_build``
COUNTS = {"flushes": 0, "profile_scorings": 0}


def _build(seed: int = 9, n_rows: int = 16384, device=None):
    import torch

    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.crosses import CrossSpec, widen_with_crosses
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams
    from fraud_detection_tpu_torch.ops.scaler import ScalerParams
    from fraud_detection_tpu_torch.ops.scorer import BatchScorer

    dev = resolve_device(device)
    d = 30
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n_rows, d)).astype(np.float32)
    data[:, 0] = np.abs(data[:, 0]) * 50_000  # Time
    data[:, -1] = np.abs(data[:, -1]) * 120  # Amount
    fps = rng.integers(1, 1 << 32, n_rows, dtype=np.uint64).astype(np.uint32)
    spec = CrossSpec(n_base=d, log2_buckets=14, amount_col=d - 1, time_col=0)
    table = (rng.standard_normal(spec.buckets) * 0.05).astype(np.float32)

    def eye_scaler(width):
        return ScalerParams(mean=torch.zeros(width), scale=torch.ones(width),
                            var=torch.ones(width), n_samples=torch.tensor(1.0))

    coef = np.concatenate([rng.standard_normal(d).astype(np.float32) * 0.3,
                           np.ones(spec.n_cross, np.float32)])
    wide = BatchScorer(
        LogisticParams(coef=torch.from_numpy(coef), intercept=torch.tensor(-1.0)),
        eye_scaler(spec.n_features), device=dev, wide_spec=spec, wide_table=table,
    )
    narrow = BatchScorer(
        LogisticParams(coef=torch.from_numpy(coef[:d].copy()), intercept=torch.tensor(-1.0)),
        eye_scaler(d), device=dev,
    )
    xw = widen_with_crosses(data, fps, table, spec, device=dev)
    wide_scores, narrow_scores = wide.predict_proba(xw), narrow.predict_proba(data)
    COUNTS["profile_scorings"] += 2
    wide_profile = build_baseline_profile(
        xw, wide_scores, feature_names=[f"f{i}" for i in range(d)] + list(spec.cross_names),
        device=dev,
    )
    narrow_profile = build_baseline_profile(
        data, narrow_scores, feature_names=[f"f{i}" for i in range(d)], device=dev,
    )
    return data, fps, wide, narrow, wide_profile, narrow_profile


def _wide_flush_once(scorer, monitor, rows, fps, explain_k: int = 3):
    """One wide flush of the block ``rows`` with its fingerprints, staged
    as the micro-batcher stages an ingest block (the pool's slot, the
    scorer's ``stage_items``, the fingerprint lanes)."""
    from fraud_detection_tpu_torch.ops.scorer import _bucket
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    n = rows.shape[0]
    spec = scorer.fused_spec()
    # a block's entity triple: the wide flush reads its fingerprint column
    items = [(rows, None, None, (None, fps, None))]
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, items)
        wide_rows = MicroBatcher._stage_wide(scorer, slot, items)
        out = monitor.fused_flush(
            scorer.to_device(hx), scorer.to_device(slot.valid), n,
            spec.score_args, spec.score_fn,
            dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
            explain_args=spec.explain_args if explain_k else None,
            explain_k=explain_k, wide_args=spec.wide, wide_rows=wide_rows,
        )
        COUNTS["flushes"] += 1
        if explain_k:
            s, ei, ev = out
            return (s.cpu().numpy().astype(np.float32)[:n], ei.cpu().numpy()[:n],
                    ev.cpu().numpy().astype(np.float32)[:n])
        return out.cpu().numpy().astype(np.float32)[:n]
    finally:
        scorer.staging.release(slot)


def _narrow_flush_once(scorer, monitor, rows):
    from fraud_detection_tpu_torch.ops.scorer import _bucket

    n = rows.shape[0]
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, [(rows, None, None, None)])
        out = monitor.fused_flush(
            scorer.to_device(hx), scorer.to_device(slot.valid), n,
            spec.score_args, spec.score_fn,
        )
        COUNTS["flushes"] += 1
        return out.cpu().numpy().astype(np.float32)[:n]
    finally:
        scorer.staging.release(slot)


def run(bucket: int = 16384, reps: int = 6, device=None) -> dict:
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.mesh.topology import MAX_FLUSH_SHARDS, serving_mesh
    from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
    from fraud_detection_tpu_torch.parallel.mesh import device_count

    dev = resolve_device(device)
    data, fps, wide, narrow, wide_profile, narrow_profile = _build(n_rows=bucket, device=dev)
    rows = data[:bucket]
    f = fps[:bucket]

    def grid_monitor(d_ax: int, m_ax: int):
        return MeshDriftMonitor(wide_profile,
                                serving_mesh(d_ax, devices=[dev], model_devices=m_ax))

    # single-device wide reference: the 2-D parity target (scores + codes)
    ref_s, ref_ei, ref_ev = _wide_flush_once(wide, DriftMonitor(wide_profile, device=dev),
                                             rows, f)

    shapes = [(d, m) for d, m in ((2, 2), (4, 2), (2, 4)) if d * m <= MAX_FLUSH_SHARDS]
    parity = True
    for d_ax, m_ax in shapes:
        s, ei, ev = _wide_flush_once(wide, grid_monitor(d_ax, m_ax), rows, f)
        parity = parity and bool(
            np.array_equal(s.view(np.uint32), ref_s.view(np.uint32))
            and np.array_equal(ei, ref_ei)
            and np.array_equal(ev.view(np.uint32), ref_ev.view(np.uint32))
        )

    # zero-alloc steady state: after the warm flushes above on the
    # single-device monitor, more flushes must draw the same pooled slot
    mono = DriftMonitor(wide_profile, device=dev)
    _wide_flush_once(wide, mono, rows, f)
    base_allocs = wide.staging.allocations
    for _ in range(4):
        _wide_flush_once(wide, mono, rows, f)
    steady_allocs = wide.staging.allocations - base_allocs

    # cost ratio vs the narrow flush (single device, same bucket)
    n_mon = DriftMonitor(narrow_profile, device=dev)
    _narrow_flush_once(narrow, n_mon, rows)  # warm

    def rate(fn) -> float:
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = max(best, reps / (time.perf_counter() - t0))
        return best

    narrow_rate = rate(lambda: _narrow_flush_once(narrow, n_mon, rows))
    wide_rate = rate(lambda: _wide_flush_once(wide, mono, rows, f))
    ratio = wide_rate / max(narrow_rate, 1e-9)

    # model-axis scaling at a fixed data axis (2 × {1, 2, 4}): the table's
    # sharding read from the live layout, the rate floor-gated vs M=1
    model_rates: dict[str, float] = {}
    shard_bytes: dict[str, int] = {}
    for m_ax in (1, 2, 4):
        if 2 * m_ax > MAX_FLUSH_SHARDS:
            continue
        mon = grid_monitor(2, m_ax)
        _wide_flush_once(wide, mon, rows, f)  # warm
        placed = mon._placed_wide_table(wide.wide_spec, wide.wide_table)
        shard = placed[0] if placed.dim() == 2 else placed  # a model shard's row
        shard_bytes[str(m_ax)] = int(shard.numel() * shard.element_size())
        model_rates[str(m_ax)] = rate(lambda mon=mon: _wide_flush_once(wide, mon, rows, f))
    keys = sorted(model_rates, key=int)
    bytes_halve = all(
        shard_bytes[a] == shard_bytes[b] * (int(b) // int(a)) for a, b in zip(keys, keys[1:])
    )
    base_rate = model_rates.get("1", 0.0)
    model_ratio = (
        min(model_rates[k] for k in keys if k != "1") / max(base_rate, 1e-9)
        if len(keys) > 1 else 1.0
    )

    return {
        "device_count": device_count(dev),
        "bucket": bucket,
        "wide_buckets": 1 << 14,
        "wide_parity_ok": parity,
        "wide_shapes_measured": [f"{d}x{m}" for d, m in shapes],
        "wide_staging_steady_allocations": int(steady_allocs),
        "wide_flushes_per_sec": round(wide_rate, 2),
        "narrow_flushes_per_sec": round(narrow_rate, 2),
        "wide_cost_ratio": round(ratio, 3),
        "wide_cost_ok": ratio >= WIDE_CPU_FLOOR,
        "wide_cpu_floor": WIDE_CPU_FLOOR,
        "wide_model_axis_flushes_per_sec": {k: round(v, 2) for k, v in model_rates.items()},
        "wide_model_shard_bytes": shard_bytes,
        "wide_model_shards_exact": bytes_halve,
        "wide_model_ratio": round(model_ratio, 3),
        "wide_model_ratio_ok": model_ratio >= WIDE_MODEL_CPU_FLOOR,
        "wide_model_cpu_floor": WIDE_MODEL_CPU_FLOOR,
    }


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
