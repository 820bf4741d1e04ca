"""Switchyard probe: the sharded flush at 1/2/4/8 shards (the JAX package's
``mesh/bench.py``).

Measures the fused flush's rate at mesh sizes 1/2/4/8 on one bucket shape
and gates single-device parity: the N-shard flush's scores must bitwise
match the single-device flush on the same batch, on the f32 and the int8
wire. Prints exactly one JSON line with JAX's keys::

    python -m fraud_detection_tpu_torch.mesh.bench        # on DEVICE (default cuda)

JAX keeps a size only while it fits ``jax.device_count()``. The port's
shards are virtual, all on the serving device (``parallel/mesh``), so the
sizes are bounded by ``topology.MAX_FLUSH_SHARDS`` instead and every size
is measured on one card; ``device_count`` reports the physical devices.
The shards share that device, so the curve says what the mechanism costs
there (the per-shard fold), not a speedup; ``monotone`` applies a noise
margin rather than demanding growth, and the hard gate is parity and the
curve existing.
"""

from __future__ import annotations

import json
import time

import numpy as np

#: throughput may dip within this factor step-to-step before the curve
#: stops counting as monotone — on one card every shard shares the device
#: and the host, so the curve measures the per-shard fold's cost, and
#: noise a step must not fail a mechanism gate.
MONOTONE_SLACK = 0.85

#: the probe's scoring calls, each one ``fused_score`` launch on the card:
#: its flushes and the profile's scoring in ``_build``
COUNTS = {"flushes": 0, "profile_scorings": 0}


def _build(seed: int = 7, n_rows: int = 4096, device=None):
    import torch

    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams
    from fraud_detection_tpu_torch.ops.scaler import ScalerParams
    from fraud_detection_tpu_torch.ops.scorer import BatchScorer

    dev = resolve_device(device)
    d = 30
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n_rows, d)).astype(np.float32)
    params = LogisticParams(
        coef=torch.from_numpy(rng.standard_normal(d).astype(np.float32)),
        intercept=torch.tensor(-1.0),
    )
    scaler = ScalerParams(
        mean=torch.zeros(d), scale=torch.ones(d), var=torch.ones(d), n_samples=torch.tensor(1.0),
    )
    scorer = BatchScorer(params, scaler, device=dev)
    quant_scorer = BatchScorer(params, scaler, io_dtype="int8", device=dev)
    scores = scorer.predict_proba(data)
    COUNTS["profile_scorings"] += 1
    profile = build_baseline_profile(
        data, scores, feature_names=[f"f{i}" for i in range(d)], device=dev,
    )
    return data, scorer, quant_scorer, profile


def _flush_once(scorer, monitor, rows) -> np.ndarray:
    """One fused flush of ``rows`` (single rows, staged as the
    micro-batcher stages requests) through ``monitor``; the scores."""
    from fraud_detection_tpu_torch.ops.scorer import _bucket

    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, [(r, None, None, None) for r in rows])
        out = monitor.fused_flush(
            scorer.to_device(hx), scorer.to_device(slot.valid), n,
            spec.score_args, spec.score_fn,
            dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
        )
        COUNTS["flushes"] += 1
        return out.cpu().numpy().astype(np.float32)[:n]
    finally:
        scorer.staging.release(slot)


def run(bucket: int = 65536, reps: int = 8, sizes=(1, 2, 4, 8), device=None) -> dict:
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.mesh.topology import MAX_FLUSH_SHARDS, serving_mesh
    from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
    from fraud_detection_tpu_torch.parallel.mesh import device_count

    dev = resolve_device(device)
    sizes = tuple(s for s in sizes if s <= MAX_FLUSH_SHARDS)
    data, scorer, quant_scorer, profile = _build(n_rows=bucket, device=dev)
    rows = [data[i] for i in range(bucket)]

    def mesh_monitor(n_sh: int):
        return MeshDriftMonitor(profile, serving_mesh(n_sh, devices=[dev], model_devices=1))

    # single-device reference: the parity target (f32 and the int8 wire —
    # the quantized mesh flush must bitwise-match the single-device one)
    ref = _flush_once(scorer, DriftMonitor(profile, device=dev), rows)
    quant_ref = _flush_once(quant_scorer, DriftMonitor(profile, device=dev), rows)

    rates: dict[str, float] = {}
    parity = True
    quant_parity = True
    for n_sh in sizes:
        monitor = mesh_monitor(n_sh)
        scores = _flush_once(scorer, monitor, rows)  # warm + parity
        parity = parity and bool(np.array_equal(scores.view(np.uint32), ref.view(np.uint32)))
        q_scores = _flush_once(quant_scorer, mesh_monitor(n_sh), rows)
        quant_parity = quant_parity and bool(
            np.array_equal(q_scores.view(np.uint32), quant_ref.view(np.uint32))
        )
        best = 0.0
        for _ in range(3):  # max-of-rounds damps shared-host noise
            t0 = time.perf_counter()
            for _ in range(reps):
                _flush_once(scorer, monitor, rows)
            monitor.shard_window.n_rows.cpu()  # drain the chain
            best = max(best, reps / (time.perf_counter() - t0))
        rates[str(n_sh)] = best

    # quantized rate at the top size only (the parity loop above is the
    # gate; one rate shows the quantized mesh flush is in family)
    top_sh = sizes[-1]
    q_monitor = mesh_monitor(top_sh)
    _flush_once(quant_scorer, q_monitor, rows)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        _flush_once(quant_scorer, q_monitor, rows)
    q_monitor.shard_window.n_rows.cpu()
    quant_top_rate = reps / (time.perf_counter() - t0)

    order = [rates[str(s)] for s in sizes]
    monotone = all(b >= a * MONOTONE_SLACK for a, b in zip(order, order[1:]))
    top = str(sizes[-1])
    return {
        "device_count": device_count(dev),
        "bucket": bucket,
        "mesh_flushes_per_sec": {k: round(v, 2) for k, v in rates.items()},
        "mesh_rows_per_sec_top": round(rates[top] * bucket),
        "mesh_speedup_top_vs_1": round(rates[top] / max(rates["1"], 1e-9), 3),
        "mesh_parity_ok": parity,
        "mesh_quant_parity_ok": quant_parity,
        "mesh_quant_flushes_per_sec_top": round(quant_top_rate, 2),
        "mesh_scaling_monotone": monotone,
        "mesh_sizes_measured": list(sizes),
    }


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
