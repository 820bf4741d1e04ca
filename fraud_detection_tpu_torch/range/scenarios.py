"""The fraud range: named chaos scenarios against the live in-process stack.

The port's counterpart of the JAX package's ``range/scenarios.py``, the
scenarios that run on one host without sockets. Each scenario builds the
REAL serving pieces (``BatchScorer`` behind the micro-batcher, the
watchtower's drift window, the conductor's CAS state machine, the sqlite
broker, the shard front) on ``device`` — the card unless the caller asks
for the CPU (``DEVICE=cpu`` or ``device="cpu"``) — replays a seeded
synthetic campaign (range/traffic.py), optionally arms a
:class:`~.faults.FaultPlan` (range/faults.py), and asserts the end-to-end
invariants (range/invariants.py).

The suite (``run_scenario(name)``):

========================  ==================================================
``burst``                 heavy-tailed diurnal arrival bursts through the
                          micro-batcher; p99 holds, every row scored
``drift_onset``           covariate drift at a known onset row; detected
                          within the row budget, drift window ends
                          bitwise-consistent across two seeded runs
``fraud_ring``            coordinated correlated-feature rings; the model
                          separates ring rows AND the drift monitor flags
                          the contamination within budget
``label_delay``           delayed + noisy labels, one poisoned feedback
                          batch; the store rejects poison, clean rows land
                          durably and in the calibration window, ECE stays
                          finite
``control_plane_chaos``   replica killed mid-promotion + duplicate task
                          delivery past the visibility timeout; promotion
                          converges to exactly-once on resume
``hot_swap``              champion hot-swapped mid-burst; p99 holds across
                          the swap, no kernel library loads after it (no
                          recompile storm), every row scored
``shard_kill_mid_swap``   a shard killed WHILE a promotion lands; load
                          sheds to healthy shards, exactly one swap
                          applies, the ladder stays warm, p99 holds
``replica_burst``         burst across replica shards while one drains;
                          p99 holds, in-flight empties cleanly, survivors
                          share the load
``explain_under_burst``   Pareto burst with the top-k explain leg fused
                          into every flush + a shard killed mid-burst; p99
                          holds, EVERY scored row carries its k reason
                          codes
``gbt_explain_under_burst``  a GBT champion on the int8 wire with the fused
                          TreeSHAP reason codes, Pareto burst + shard kill;
                          the same invariants, and both fusion gauges at 1
``poison_entity_state``   one entity hammered with NaN/extreme amounts via
                          the ``ledger.update`` injection point; the poison
                          clamp bounds the victim slot, every other
                          entity's aggregates stay bitwise-unaffected,
                          scores stay finite, p99 holds
========================  ==================================================

JAX counts a recompile as a miss of the fused flush's executable cache;
eager PyTorch has no such cache, and the port's counterpart of a miss is a
kernel library built or loaded into the process (``ops/kernels.
LOAD_EVENTS``, as in ``telemetry/compile_sentinel``). ``hot_swap`` and
``shard_kill_mid_swap`` hold no such load from the swap to the end of the
burst (vacuous on the CPU, where no kernel library exists); on the card
they also report the allocator's ``num_device_alloc`` across the same span,
the other half of what the pre-swap warm-up buys here.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass

import numpy as np

from fraud_detection_tpu_torch.range import faults
from fraud_detection_tpu_torch.range.invariants import (
    AlertFlapDetector,
    InvariantOutcome,
    ScenarioResult,
    drift_detected_within,
    exactly_once_promotion,
    p99_within,
    windows_bitwise_equal,
)
from fraud_detection_tpu_torch.range.traffic import (
    ArrivalProcess,
    CampaignSpec,
    CampaignTraffic,
    DelayedLabelJoiner,
    DriftCampaign,
    FraudRing,
    LabelFeedback,
)

KAGGLE = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
D = 30


# -- environment builders ----------------------------------------------------

@dataclass
class RangeModel:
    """A trained-for-real champion + its baseline profile + the ground
    truth boundary the traffic generators share."""

    model: object
    profile: object
    w_true: np.ndarray
    x_base: np.ndarray
    y_base: np.ndarray


def _make_rows(n: int, rng: np.random.Generator, w_true: np.ndarray):
    x = rng.standard_normal((n, D)).astype(np.float32)
    logits = x @ w_true - 2.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int32)
    return x, y


def build_model(seed: int = 7, n_base: int = 2400, device=None) -> RangeModel:
    """Fit a small logistic champion on synthetic Kaggle-schema data and
    profile it — the real scorer/profile pair every scenario serves — on
    ``device``."""
    import torch

    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.logistic import logistic_fit_lbfgs
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(D).astype(np.float32)
    x, y = _make_rows(n_base, rng, w_true)
    xt = torch.as_tensor(x, device=dev)
    scaler = scaler_fit(xt)
    params = logistic_fit_lbfgs(scaler_transform(scaler, xt), y, max_iter=100)
    model = FraudLogisticModel(params, scaler, KAGGLE, device=dev)
    scores = model.scorer.predict_proba(x[:1024])
    profile = build_baseline_profile(x, scores, feature_names=KAGGLE, device=dev)
    return RangeModel(model, profile, w_true, x, y)


def _watchtower(profile, min_rows: int = 256, halflife: float = 1500.0,
                device=None):
    from fraud_detection_tpu_torch.monitor.watchtower import Thresholds, Watchtower

    thr = Thresholds(
        psi=0.2, ks=0.15, ece=0.2, disagree=0.05, min_rows=min_rows
    )
    return Watchtower(
        profile, thresholds=thr, halflife_rows=halflife, max_backlog=256,
        device=device,
    )


def _kernel_loads() -> int:
    """Kernel libraries built or loaded by this process so far: the port's
    count of executable-cache misses."""
    from fraud_detection_tpu_torch.ops import kernels

    return len(kernels.LOAD_EVENTS)


def _device_allocs(device) -> int | None:
    """The caching allocator's ``num_device_alloc`` on a card; None on the
    CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.memory_stats(device).get("num_device_alloc", 0))


# -- shared drivers ----------------------------------------------------------

async def _timed_score(batcher, row, lat: list[float]) -> float:
    t0 = time.perf_counter()
    s = await batcher.score(row)
    lat.append(time.perf_counter() - t0)
    return s


async def _baseline_p99(batcher, rows: np.ndarray) -> float:
    """Quiet-traffic per-request latency floor: sequential lone requests."""
    lat: list[float] = []
    for r in rows:
        await _timed_score(batcher, r, lat)
    return float(np.percentile(np.asarray(lat), 99))


def _drive_bursts(
    batcher_factory,
    traffic: CampaignTraffic,
    on_batch=None,
    mid_stream=None,
) -> dict:
    """Replay a campaign through a micro-batcher on a private event loop.

    ``on_batch(batch, scores)`` runs after each batch resolves;
    ``mid_stream(batcher)`` fires once, halfway through the campaign (the
    hot-swap hook). Returns latencies, scores and counters.
    """

    async def run() -> dict:
        batcher = batcher_factory()
        await batcher.start()
        try:
            warm = traffic.rng.standard_normal((64, D)).astype(np.float32)
            base_p99 = await _baseline_p99(batcher, warm)
            lat: list[float] = []
            n_scored = 0
            batches = list(traffic.batches())
            fire_mid = len(batches) // 2
            mid_fut = None
            for bi, batch in enumerate(batches):
                if mid_stream is not None and bi == fire_mid:
                    # launch WITHOUT awaiting: requests must genuinely
                    # overlap the swap, or the p99-across-swap invariant
                    # passes vacuously (a swap that blocks serving would
                    # add zero latency to any measured request otherwise)
                    mid_fut = asyncio.get_running_loop().run_in_executor(
                        None, mid_stream, batcher
                    )
                scores = await asyncio.gather(
                    *(_timed_score(batcher, r, lat) for r in batch.rows)
                )
                n_scored += len(scores)
                if on_batch is not None:
                    on_batch(batch, np.asarray(scores, np.float32))
                await asyncio.sleep(traffic.spec.arrivals.window_s)
            if mid_fut is not None:
                await mid_fut
            return {
                "baseline_p99_s": base_p99,
                "latencies_s": lat,
                "rows_scored": n_scored,
            }
        finally:
            await batcher.stop()

    return asyncio.run(run())


def _fold_campaign(
    wt,
    model,
    traffic: CampaignTraffic,
    sample_every: int = 4,
    status_hook=None,
    on_batch=None,
) -> dict:
    """Synchronous replay: score each batch with the real scorer, hand it
    to the watchtower, drain, and sample status — the deterministic driver
    the detection-latency and bitwise invariants need."""
    flap = AlertFlapDetector()
    detected_row: int | None = None
    rows = 0
    for bi, batch in enumerate(traffic.batches()):
        scores = np.asarray(model.scorer.predict_proba(batch.rows), np.float32)
        if on_batch is not None:
            on_batch(batch, scores)
        wt.observe(batch.rows, scores)
        # drain per batch: the bounded ingest backlog must never drop a
        # batch here — determinism (the bitwise invariant) depends on every
        # batch folding, in order
        wt.drain(timeout=30.0)
        rows = batch.start_row + batch.rows.shape[0]
        if bi % sample_every == 0:
            status = wt.status()
            flap.sample(drift=status["status"] == "drift")
            if status["status"] == "drift" and detected_row is None:
                detected_row = rows
            if status_hook is not None:
                status_hook(batch, scores, status)
    wt.drain(timeout=30.0)
    status = wt.status()
    flap.sample(drift=status["status"] == "drift")
    if status["status"] == "drift" and detected_row is None:
        detected_row = rows
    return {
        "detected_row": detected_row,
        "rows": rows,
        "flap": flap,
        "final_status": status,
    }


# -- scenarios ---------------------------------------------------------------

def scenario_burst(seed: int = 2026, total_rows: int = 6144,
                   device=None) -> ScenarioResult:
    """Heavy-tailed diurnal bursts; the serving path holds its latency SLO
    and loses nothing."""
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    rm = build_model(seed=seed, device=device)
    wt = _watchtower(rm.profile, device=device)
    spec = CampaignSpec(
        total_rows=total_rows, seed=seed, w_true=rm.w_true,
        arrivals=ArrivalProcess(rate_hz=4000.0, window_s=0.01),
    )
    result = ScenarioResult("burst")
    try:
        out = _drive_bursts(
            lambda: MicroBatcher(
                scorer=rm.model.scorer, watchtower=wt,
                max_batch=512, max_wait_ms=2.0, telemetry=False,
            ),
            CampaignTraffic(spec),
        )
    finally:
        wt.close()
    result.metrics = {
        "rows": total_rows,
        "rows_scored": out["rows_scored"],
        "baseline_p99_ms": round(out["baseline_p99_s"] * 1e3, 3),
        "burst_p99_ms": round(
            float(np.percentile(out["latencies_s"], 99)) * 1e3, 3
        ),
    }
    result.add(
        p99_within(
            out["latencies_s"], out["baseline_p99_s"],
            factor=10.0, absolute_floor_s=0.25,
        )
    )
    result.add(
        InvariantOutcome(
            "all-rows-scored",
            out["rows_scored"] == total_rows,
            f"{out['rows_scored']}/{total_rows} rows returned a score",
        )
    )
    return result


def scenario_drift_onset(
    seed: int = 2026, total_rows: int = 6144, onset_row: int = 2048,
    budget_rows: int = 2048, device=None,
) -> ScenarioResult:
    """Covariate drift with a known onset; detection latency is bounded and
    the window state is bitwise-reproducible per seed."""
    rm = build_model(seed=seed, device=device)
    drift = DriftCampaign(onset_row=onset_row, mean_shift=3.0)

    def one_run():
        wt = _watchtower(rm.profile, device=device)
        spec = CampaignSpec(
            total_rows=total_rows, seed=seed, w_true=rm.w_true, drift=drift
        )
        try:
            out = _fold_campaign(wt, rm.model, CampaignTraffic(spec))
            window = wt.drift.window_snapshot()
        finally:
            wt.close()
        return out, window

    out, window_a = one_run()
    _, window_b = one_run()  # same seed → must end bitwise identical

    result = ScenarioResult("drift_onset")
    result.metrics = {
        "rows": out["rows"],
        "onset_row": onset_row,
        "detected_row": out["detected_row"],
        "feature_psi_max": round(
            out["final_status"]["drift"]["feature_psi_max"], 4
        ),
    }
    result.add(drift_detected_within(onset_row, out["detected_row"], budget_rows))
    result.add(out["flap"].check())
    result.add(windows_bitwise_equal(window_a, window_b))
    return result


def scenario_fraud_ring(
    seed: int = 2026, total_rows: int = 6144, ring_start: int = 1536,
    budget_rows: int = 3072, device=None,
) -> ScenarioResult:
    """Coordinated rings (correlated feature clusters): the scorer must
    separate ring rows from background AND the drift monitor must flag the
    contamination."""
    rm = build_model(seed=seed, device=device)
    # ~25% of post-onset traffic is ring rows (96 per 288 background): a
    # mule-network burst heavy enough that NOT flagging it is a monitoring
    # failure, not a threshold judgement call
    ring = FraudRing(start_row=ring_start, n_rings=3, ring_size=96,
                     every_rows=288, center_scale=5.0)
    spec = CampaignSpec(
        total_rows=total_rows, seed=seed, w_true=rm.w_true, ring=ring
    )
    wt = _watchtower(rm.profile, device=device)
    ring_scores: list[float] = []
    bg_scores: list[float] = []

    def collect(batch, scores):
        ring_scores.extend(scores[batch.ring_mask].tolist())
        bg_scores.extend(scores[~batch.ring_mask].tolist())

    try:
        out = _fold_campaign(
            wt, rm.model, CampaignTraffic(spec), on_batch=collect
        )
    finally:
        wt.close()

    result = ScenarioResult("fraud_ring")
    ring_mean = float(np.mean(ring_scores)) if ring_scores else float("nan")
    bg_mean = float(np.mean(bg_scores)) if bg_scores else float("nan")
    result.metrics = {
        "rows": out["rows"],
        "ring_rows": len(ring_scores),
        "ring_mean_score": round(ring_mean, 4),
        "background_mean_score": round(bg_mean, 4),
        "detected_row": out["detected_row"],
    }
    result.add(
        InvariantOutcome(
            "ring-rows-injected",
            len(ring_scores) > 0,
            f"{len(ring_scores)} ring rows generated",
        )
    )
    result.add(
        InvariantOutcome(
            "ring-separable",
            bool(ring_scores) and abs(ring_mean - bg_mean) > 0.05,
            f"ring mean score {ring_mean:.4f} vs background {bg_mean:.4f} — "
            "a coordinated cluster must not score like background traffic",
        )
    )
    result.add(drift_detected_within(ring_start, out["detected_row"], budget_rows))
    result.add(out["flap"].check())
    return result


def scenario_label_delay(
    tmpdir: str, seed: int = 2026, total_rows: int = 4096,
    delay_rows: int = 1024, noise_rate: float = 0.05, device=None,
) -> ScenarioResult:
    """Delayed, noisy labels with one poisoned batch in flight: durable
    feedback stays consistent, poison is rejected at the store boundary,
    and calibration state stays finite."""
    from fraud_detection_tpu_torch.lifecycle.store import LifecycleStore

    rm = build_model(seed=seed, device=device)
    fb = LabelFeedback(delay_rows=delay_rows, noise_rate=noise_rate, batch=256)
    spec = CampaignSpec(
        total_rows=total_rows, seed=seed, w_true=rm.w_true, feedback=fb,
    )
    # huge half-life: decayed n_labeled ≈ true labeled count, so the
    # bookkeeping invariant below is exact-ish
    wt = _watchtower(rm.profile, halflife=10_000_000.0, device=device)
    joiner = DelayedLabelJoiner(fb, seed)
    store = LifecycleStore(
        f"sqlite:///{os.path.join(tmpdir, 'range-lifecycle.db')}",
        window_size=total_rows, reservoir_size=256,
    )
    delivered = 0
    rejected_batches = 0

    def poison(features=None, scores=None, labels=None, **_):
        # corrupt the scores array in flight (review pipeline bug)
        if scores is not None:
            scores[:] = np.nan

    plan = faults.FaultPlan().call(
        "lifecycle.store.add_feedback", poison, times=1
    )
    try:
        with plan.armed():
            for batch in CampaignTraffic(spec).batches():
                scores = np.asarray(
                    rm.model.scorer.predict_proba(batch.rows), np.float32
                )
                wt.observe(batch.rows, scores)
                joiner.observe(batch, scores)
                current = batch.start_row + batch.rows.shape[0]
                for fx, fs, fy in joiner.due(current):
                    fs = fs.copy()  # the poison fault mutates in flight
                    try:
                        store.add_feedback(fx, fs, fy)
                    except ValueError:
                        rejected_batches += 1
                        continue
                    wt.observe(fx, fs, fy, calibration_only=True)
                    delivered += fy.shape[0]
        wt.drain(timeout=30.0)
        status = wt.status()
    finally:
        counts = store.feedback_counts()
        store.close()
        wt.close()

    result = ScenarioResult("label_delay")
    n_labeled = float(status["drift"]["n_labeled"])
    ece = float(status["drift"]["ece"])
    result.metrics = {
        "rows": total_rows,
        "labels_released": joiner.released_rows,
        "labels_flipped": joiner.flipped_rows,
        "labels_delivered": delivered,
        "poisoned_batches_rejected": rejected_batches,
        "store_window_rows": counts["window"],
        "ece": round(ece, 4),
    }
    result.add(
        InvariantOutcome(
            "poison-rejected",
            rejected_batches == 1 and plan.fired() == 1,
            f"{rejected_batches} poisoned batch(es) rejected at the store "
            f"boundary ({plan.fired()} fault(s) fired)",
        )
    )
    result.add(
        InvariantOutcome(
            "feedback-durable",
            counts["window"] == delivered and counts["seen"] == delivered,
            f"store window {counts['window']} / seen {counts['seen']} vs "
            f"{delivered} delivered rows",
        )
    )
    result.add(
        InvariantOutcome(
            "calibration-bookkeeping",
            abs(n_labeled - delivered) <= max(2.0, 0.01 * delivered),
            f"calibration window holds {n_labeled:.0f} labeled rows, "
            f"{delivered} delivered",
        )
    )
    result.add(
        InvariantOutcome(
            "ece-finite",
            np.isfinite(ece),
            f"windowed ECE = {ece} over noisy delayed labels",
        )
    )
    return result


# -- lifecycle scenarios -----------------------------------------------------

def build_lifecycle_env(tmpdir: str, seed: int = 7, device=None) -> dict:
    """Registered champion + lifecycle store + conductor, self-contained in
    ``tmpdir`` (no environment variables touched), on ``device``."""
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.lifecycle import (
        Conductor,
        GateThresholds,
        LifecycleStore,
    )
    from fraud_detection_tpu_torch.monitor.baseline import (
        build_baseline_profile,
        save_profile,
    )
    from fraud_detection_tpu_torch.tracking.store import TrackingClient

    dev = resolve_device(device)
    rm = build_model(seed=seed, device=dev)
    csv = os.path.join(tmpdir, "base.csv")
    with open(csv, "w") as f:
        f.write(",".join(KAGGLE + ["Class"]) + "\n")
        for row, label in zip(rm.x_base, rm.y_base):
            f.write(",".join(f"{v:.6f}" for v in row) + f",{int(label)}\n")
    art = os.path.join(tmpdir, "champion")
    rm.model.save(art, joblib_too=False)
    scores = rm.model.scorer.predict_proba(rm.x_base[:512])
    save_profile(
        art,
        build_baseline_profile(rm.x_base, scores, feature_names=KAGGLE, device=dev),
    )
    client = TrackingClient(uri=f"file:{os.path.join(tmpdir, 'mlruns')}")
    v1 = client.registry.register("fraud", art)
    client.registry.set_alias("fraud", "prod", v1)
    store = LifecycleStore(
        f"sqlite:///{os.path.join(tmpdir, 'lifecycle.db')}",
        window_size=600, reservoir_size=200, seed=3,
    )
    loose = GateThresholds(
        auc_margin=0.05, ece_bound=0.5, psi_bound=2.0, min_eval_rows=64
    )
    conductor = Conductor(
        store=store,
        tracking_client=client,
        retrain_kwargs={
            "data_csv": csv, "use_smote": False, "max_iter": 100,
            "thresholds": loose,
        },
        device=dev,
    )
    return {
        "rm": rm, "client": client, "registry": client.registry,
        "store": store, "conductor": conductor, "v1": v1, "tmp": tmpdir,
        "device": dev,
    }


def _feed_store(env, n: int = 512, seed: int = 99) -> None:
    rng = np.random.default_rng(seed)
    x, y = _make_rows(n, rng, env["rm"].w_true)
    s = 1.0 / (1.0 + np.exp(-(x @ env["rm"].w_true - 2.0)))
    env["store"].add_feedback(x, s.astype(np.float32), y)


def scenario_control_plane_chaos(
    tmpdir: str, seed: int = 7, kill_point: str = "conductor.promoting.pre_alias",
    device=None,
) -> ScenarioResult:
    """The mid-promotion kill + duplicate-delivery drill: a replica dies at
    ``kill_point`` with the promotion intent persisted; the promote task is
    redelivered past a collapsed visibility window AND a second replica
    resumes — the CAS machine must converge to exactly one promotion."""
    from fraud_detection_tpu_torch.lifecycle import Conductor
    from fraud_detection_tpu_torch.lifecycle import store as lst
    from fraud_detection_tpu_torch.service import metrics
    from fraud_detection_tpu_torch.service.taskq import SqliteBroker

    env = build_lifecycle_env(tmpdir, seed=seed, device=device)
    result = ScenarioResult("control_plane_chaos")
    _feed_store(env, n=512, seed=seed + 1)

    out = env["conductor"].handle_retrain("range: control-plane drill")
    result.add(
        InvariantOutcome(
            "retrain-gated",
            out.get("outcome") == "gated",
            f"retrain outcome {out.get('outcome')!r}",
        )
    )
    if out.get("outcome") != "gated":
        env["store"].close()
        return result
    v2 = out["version"]
    versions_before = env["registry"].latest_version("fraud")
    promos_before = metrics.lifecycle_promotions.get()

    # --- duplicate delivery: the promote task redelivered past a collapsed
    # visibility window (simulating a worker that claimed, then stalled)
    broker = SqliteBroker(f"sqlite:///{os.path.join(tmpdir, 'taskq.db')}")
    redeliveries_before = broker.redeliveries
    plan = (
        faults.FaultPlan()
        .kill(kill_point)
        .patch("taskq.visibility_timeout", 0.0, times=1)
    )
    killed = False
    with plan.armed():
        broker.send_task("lifecycle.promote_challenger", ["range drill"])
        first = broker.claim("worker-a")  # visibility collapsed to 0 → stays deliverable
        second = broker.claim("worker-b")  # the at-least-once redelivery
        try:
            env["conductor"].handle_promote("range drill")
        except faults.ReplicaKilled:
            killed = True  # replica died mid-promotion, intent persisted
    result.add(
        InvariantOutcome(
            "fault-fired",
            killed and plan.fired(kill_point) == 1,
            f"kill at {kill_point}: fired={plan.fired(kill_point)}",
        )
    )
    result.add(
        InvariantOutcome(
            "task-redelivered",
            first is not None and second is not None
            and second.id == first.id
            and broker.redeliveries - redeliveries_before >= 1,
            "collapsed visibility window produced an observable redelivery "
            f"(redeliveries +{broker.redeliveries - redeliveries_before})",
        )
    )
    state = env["store"].get_state("fraud")["state"]
    result.add(
        InvariantOutcome(
            "intent-persisted",
            state in (lst.PROMOTING, lst.SHADOWING),
            f"state after kill = {state!r} (intent must be durable)",
        )
    )

    # --- two replicas resume concurrently-ish: the first completes the
    # promotion, the second finds nothing to do
    dev = env["device"]
    replica_b = Conductor(store=env["store"], tracking_client=env["client"], device=dev)
    resumed = replica_b.resume()
    replica_c = Conductor(store=env["store"], tracking_client=env["client"], device=dev)
    resumed_again = replica_c.resume()
    dup = env["conductor"].handle_promote("duplicate delivery replay")
    broker.ack(second.id)
    broker.close()

    result.metrics = {
        "kill_point": kill_point,
        "challenger_version": v2,
        "resume_outcome": (resumed or {}).get("outcome"),
        "second_resume": resumed_again,
        "duplicate_promote_outcome": dup.get("outcome"),
        "redeliveries": broker.redeliveries - redeliveries_before,
    }
    result.add(
        InvariantOutcome(
            "resume-completes",
            (resumed or {}).get("outcome") == "promoted"
            and resumed_again is None,
            f"first resume {resumed!r}, second resume {resumed_again!r}",
        )
    )
    result.add(
        InvariantOutcome(
            "duplicate-promote-dropped",
            dup.get("outcome") in ("skipped", "no_challenger"),
            f"replayed promote task outcome {dup.get('outcome')!r}",
        )
    )
    promos_delta = metrics.lifecycle_promotions.get() - promos_before
    result.add(
        exactly_once_promotion(
            env["registry"], env["store"], "fraud",
            challenger_version=v2, versions_before=versions_before,
            promotions_delta=promos_delta,
        )
    )
    env["store"].close()
    return result


def _swap_span(swap_state: dict, device) -> tuple:
    """``(post_swap_compiles, post_swap_device_allocs)``: kernel library
    loads and, on a card, allocator allocations from the slot write to now;
    ``(None, None)`` when the swap never ran."""
    if not swap_state["swapped"]:
        return None, None
    allocs = _device_allocs(device)
    before = swap_state["allocs_before"]
    return (
        _kernel_loads() - swap_state["compiles_before"],
        None if allocs is None or before is None else allocs - before,
    )


def scenario_hot_swap(
    seed: int = 2026, total_rows: int = 4096, device=None,
) -> ScenarioResult:
    """Champion hot swap under burst traffic: the slot flip lands between
    flushes with p99 intact and NO kernel library built or loaded after it
    (the ladder was pre-warmed — a swap must never page RecompileStorm)."""
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.lifecycle.swap import ModelSlot, warm_scorer
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    dev = resolve_device(device)
    rm = build_model(seed=seed, device=dev)
    challenger = build_model(seed=seed + 1, device=dev)
    wt = _watchtower(rm.profile, device=dev)
    slot = ModelSlot(rm.model, "range:champion", 1)
    spec = CampaignSpec(
        total_rows=total_rows, seed=seed, w_true=rm.w_true,
        arrivals=ArrivalProcess(rate_hz=4000.0, window_s=0.01),
    )
    swap_state = {"swapped": False}

    def swap(batcher) -> None:
        # what ModelReloader does on an alias flip, minus the registry:
        # warm the incoming ladder off-path, THEN flip the slot
        warm_scorer(challenger.model.scorer, max_batch=512)
        swap_state["compiles_before"] = _kernel_loads()
        swap_state["allocs_before"] = _device_allocs(dev)
        slot.swap(challenger.model, "range:challenger", 2)
        swap_state["swapped"] = True

    result = ScenarioResult("hot_swap")
    try:
        out = _drive_bursts(
            lambda: MicroBatcher(
                slot=slot, watchtower=wt,
                max_batch=512, max_wait_ms=2.0, telemetry=False,
            ),
            CampaignTraffic(spec),
            mid_stream=swap,
        )
        compiles_delta, allocs_delta = _swap_span(swap_state, dev)
    finally:
        wt.close()

    result.metrics = {
        "rows": total_rows,
        "rows_scored": out["rows_scored"],
        "baseline_p99_ms": round(out["baseline_p99_s"] * 1e3, 3),
        "swap_p99_ms": round(
            float(np.percentile(out["latencies_s"], 99)) * 1e3, 3
        ),
        "post_swap_compiles": compiles_delta,
        "post_swap_device_allocs": allocs_delta,
    }
    result.add(
        InvariantOutcome(
            "swap-applied",
            swap_state["swapped"] and slot.version == 2,
            f"slot now serves v{slot.version}",
        )
    )
    result.add(
        p99_within(
            out["latencies_s"], out["baseline_p99_s"],
            factor=10.0, absolute_floor_s=0.25,
        )
    )
    result.add(
        InvariantOutcome(
            "no-recompile-storm",
            compiles_delta == 0,
            f"{compiles_delta} kernel libraries built or loaded after the "
            "pre-warmed swap (must be 0)",
        )
    )
    result.add(
        InvariantOutcome(
            "all-rows-scored",
            out["rows_scored"] == total_rows,
            f"{out['rows_scored']}/{total_rows} rows returned a score",
        )
    )
    return result


# -- shard-front scenarios ---------------------------------------------------

def _shard_front(rm, wt, n_shards: int, slot=None, max_batch: int = 512):
    from fraud_detection_tpu_torch.mesh.front import ShardFront
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    kw = dict(max_batch=max_batch, max_wait_ms=2.0, telemetry=False)
    if slot is not None:
        batchers = [
            MicroBatcher(slot=slot, watchtower=wt, **kw)
            for _ in range(n_shards)
        ]
    else:
        batchers = [
            MicroBatcher(scorer=rm.model.scorer, watchtower=wt, **kw)
            for _ in range(n_shards)
        ]
    return ShardFront(batchers, max_consecutive_errors=3)


def scenario_shard_kill_mid_swap(
    seed: int = 2026, total_rows: int = 4096, n_shards: int = 3,
    victim: int = 1, device=None,
) -> ScenarioResult:
    """Kill a shard WHILE a promotion hot-swap lands: the dead shard must
    shed its load to the healthy shards (every row still scored), exactly
    one swap must apply across all shards (they share the slot), the
    pre-warmed ladder must hold (no kernel library loaded after the swap),
    and p99 must survive both disturbances at once."""
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.lifecycle.swap import ModelSlot, warm_scorer
    from fraud_detection_tpu_torch.mesh.front import DEAD

    dev = resolve_device(device)
    rm = build_model(seed=seed, device=dev)
    challenger = build_model(seed=seed + 1, device=dev)
    wt = _watchtower(rm.profile, device=dev)
    slot = ModelSlot(rm.model, "range:champion", 1)
    spec = CampaignSpec(
        total_rows=total_rows, seed=seed, w_true=rm.w_true,
        arrivals=ArrivalProcess(rate_hz=4000.0, window_s=0.01),
    )
    swap_state = {"swapped": False}
    kill_armed = {"on": False}
    injected = {"n": 0}  # ACTUAL injected failures — the call rule fires
    # (and counts in plan.fired()) on every routed row, raising only for
    # the armed victim, so plan.fired() alone would be routing volume
    fronts: list = []

    def shard_fault(shard=None, **_):
        if kill_armed["on"] and shard == victim:
            injected["n"] += 1
            raise RuntimeError("range: injected shard flush failure")

    def swap_and_kill(front) -> None:
        # the ModelReloader sequence minus the registry (warm off-path,
        # then flip) — with the victim shard dying in the same window
        kill_armed["on"] = True
        warm_scorer(challenger.model.scorer, max_batch=512)
        swap_state["compiles_before"] = _kernel_loads()
        swap_state["allocs_before"] = _device_allocs(dev)
        slot.swap(challenger.model, "range:challenger", 2)
        swap_state["swapped"] = True

    def factory():
        front = _shard_front(rm, wt, n_shards, slot=slot)
        fronts.append(front)
        return front

    plan = faults.FaultPlan().call("mesh.shard_flush", shard_fault, times=-1)
    result = ScenarioResult("shard_kill_mid_swap")
    try:
        with plan.armed():
            out = _drive_bursts(
                factory, CampaignTraffic(spec), mid_stream=swap_and_kill
            )
        compiles_delta, allocs_delta = _swap_span(swap_state, dev)
    finally:
        wt.close()
    front = fronts[0]
    status = front.status()
    result.metrics = {
        "rows": total_rows,
        "rows_scored": out["rows_scored"],
        "shards": n_shards,
        "victim": victim,
        "victim_state": status["per_shard"][victim]["state"],
        "victim_errors": status["per_shard"][victim]["errors_total"],
        "healthy_after": status["healthy"],
        "baseline_p99_ms": round(out["baseline_p99_s"] * 1e3, 3),
        "chaos_p99_ms": round(
            float(np.percentile(out["latencies_s"], 99)) * 1e3, 3
        ),
        "post_swap_compiles": compiles_delta,
        "post_swap_device_allocs": allocs_delta,
        "failures_injected": injected["n"],
    }
    result.add(
        InvariantOutcome(
            "shard-killed",
            status["per_shard"][victim]["state"] == DEAD
            and injected["n"] > 0,
            f"victim shard {victim} ended {status['per_shard'][victim]['state']!r} "
            f"after {injected['n']} injected failure(s)",
        )
    )
    result.add(
        InvariantOutcome(
            "load-shed",
            out["rows_scored"] == total_rows,
            f"{out['rows_scored']}/{total_rows} rows scored with a shard "
            "dead — the front must shed, not drop",
        )
    )
    result.add(
        InvariantOutcome(
            "exactly-once-swap",
            swap_state["swapped"] and slot.version == 2,
            f"slot serves v{slot.version} (one swap, shared by all shards)",
        )
    )
    result.add(
        InvariantOutcome(
            "ladder-stays-warm",
            compiles_delta == 0,
            f"{compiles_delta} kernel libraries built or loaded after the "
            "pre-warmed swap (must be 0 — the shards share the ladder)",
        )
    )
    result.add(
        p99_within(
            out["latencies_s"], out["baseline_p99_s"],
            factor=10.0, absolute_floor_s=0.25,
        )
    )
    return result


def scenario_replica_burst(
    seed: int = 2026, total_rows: int = 4096, n_shards: int = 4,
    drain_shard: int = 0, device=None,
) -> ScenarioResult:
    """Burst traffic across replica shards while one shard drains: p99
    holds through the drain, every row is scored, the drained shard's
    in-flight count empties, and the survivors share the load without a
    pathological skew (least-in-flight routing)."""
    from fraud_detection_tpu_torch.mesh.front import DRAINING

    rm = build_model(seed=seed, device=device)
    wt = _watchtower(rm.profile, device=device)
    spec = CampaignSpec(
        total_rows=total_rows, seed=seed, w_true=rm.w_true,
        arrivals=ArrivalProcess(rate_hz=4000.0, window_s=0.01),
    )
    fronts: list = []
    drained = {"ok": None, "rows_at_drain": None}

    def factory():
        front = _shard_front(rm, wt, n_shards, max_batch=256)
        fronts.append(front)
        return front

    def drain_mid(front) -> None:
        # snapshot BEFORE draining: the load-sharing invariant must hold
        # on post-drain deltas — cumulative totals would pass vacuously
        # on pre-drain traffic alone
        drained["rows_at_drain"] = [h.rows_total for h in front.shards]
        front.drain(drain_shard)
        drained["ok"] = front.wait_drained(drain_shard, timeout=15.0)

    result = ScenarioResult("replica_burst")
    try:
        out = _drive_bursts(
            factory, CampaignTraffic(spec), mid_stream=drain_mid
        )
    finally:
        wt.close()
    front = fronts[0]
    status = front.status()
    at_drain = drained["rows_at_drain"] or [0] * n_shards
    survivor_rows = [
        s["rows_total"] - at_drain[s["shard"]]
        for s in status["per_shard"]
        if s["shard"] != drain_shard
    ]
    result.metrics = {
        "rows": total_rows,
        "rows_scored": out["rows_scored"],
        "shards": n_shards,
        "drained_shard": drain_shard,
        "drained_state": status["per_shard"][drain_shard]["state"],
        "rows_per_shard": [s["rows_total"] for s in status["per_shard"]],
        "post_drain_rows_per_survivor": survivor_rows,
        "baseline_p99_ms": round(out["baseline_p99_s"] * 1e3, 3),
        "burst_p99_ms": round(
            float(np.percentile(out["latencies_s"], 99)) * 1e3, 3
        ),
    }
    result.add(
        InvariantOutcome(
            "drain-clean",
            drained["ok"] is True
            and status["per_shard"][drain_shard]["state"] == DRAINING
            and status["per_shard"][drain_shard]["inflight"] == 0,
            f"shard {drain_shard} drained to 0 in-flight "
            f"(state {status['per_shard'][drain_shard]['state']!r})",
        )
    )
    result.add(
        InvariantOutcome(
            "all-rows-scored",
            out["rows_scored"] == total_rows,
            f"{out['rows_scored']}/{total_rows} rows returned a score "
            "across the drain",
        )
    )
    result.add(
        InvariantOutcome(
            "survivors-share-load",
            drained["rows_at_drain"] is not None
            and all(r > 0 for r in survivor_rows),
            f"post-drain routed rows per survivor {survivor_rows} — every "
            "healthy shard must carry traffic AFTER the drain (deltas "
            "from the drain-time snapshot, not cumulative totals)",
        )
    )
    result.add(
        p99_within(
            out["latencies_s"], out["baseline_p99_s"],
            factor=10.0, absolute_floor_s=0.25,
        )
    )
    return result


def _drive_explain_burst(
    rm: RangeModel, seed: int, total_rows: int, n_shards: int,
    victim: int, explain_k: int, device=None,
) -> tuple[dict, dict, int]:
    """The shared explain-under-burst harness (the logistic AND the forest
    scenarios): an explain-on shard front over ``rm``'s scorer, warmed,
    driven with a Pareto burst, the victim shard killed mid-burst.
    Returns ``(out, front_status, failures_injected)``. A row counts as
    explained only when it carries k FINITE reason codes — ONE counting
    rule for every family, so a NaN-attribution regression fails whichever
    scenario serves it."""
    from fraud_detection_tpu_torch.mesh.front import ShardFront
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    wt = _watchtower(rm.profile, device=device)
    spec = CampaignSpec(
        total_rows=total_rows, seed=seed, w_true=rm.w_true,
        arrivals=ArrivalProcess(rate_hz=4000.0, window_s=0.01),
    )
    kill_armed = {"on": False}
    injected = {"n": 0}
    fronts: list = []

    def shard_fault(shard=None, **_):
        if kill_armed["on"] and shard == victim:
            injected["n"] += 1
            raise RuntimeError("range: injected shard flush failure")

    def factory():
        front = ShardFront(
            [
                MicroBatcher(
                    scorer=rm.model.scorer, watchtower=wt,
                    max_batch=512, max_wait_ms=2.0, telemetry=False,
                    explain=True, explain_k=explain_k,
                )
                for _ in range(n_shards)
            ],
            max_consecutive_errors=3,
        )
        fronts.append(front)
        return front

    async def run() -> dict:
        front = factory()
        await front.start()
        try:
            traffic = CampaignTraffic(spec)
            warm = traffic.rng.standard_normal((64, D)).astype(np.float32)
            base_lat: list[float] = []
            for r in warm:
                t0 = time.perf_counter()
                s, reasons = await front.score_ex(r)
                base_lat.append(time.perf_counter() - t0)
                assert reasons is not None
            base_p99 = float(np.percentile(np.asarray(base_lat), 99))
            lat: list[float] = []
            n_scored = 0
            n_with_reasons = 0

            async def one(row) -> None:
                nonlocal n_scored, n_with_reasons
                t0 = time.perf_counter()
                s, reasons = await front.score_ex(row)
                lat.append(time.perf_counter() - t0)
                n_scored += 1
                if (
                    reasons is not None
                    and len(reasons[0]) == explain_k
                    and len(reasons[1]) == explain_k
                    and np.all(np.isfinite(np.asarray(reasons[1])))
                ):
                    n_with_reasons += 1

            batches = list(traffic.batches())
            fire_mid = len(batches) // 2
            for bi, batch in enumerate(batches):
                if bi == fire_mid:
                    kill_armed["on"] = True  # the victim dies under load
                await asyncio.gather(*(one(r) for r in batch.rows))
                await asyncio.sleep(traffic.spec.arrivals.window_s)
            return {
                "baseline_p99_s": base_p99,
                "latencies_s": lat,
                "rows_scored": n_scored,
                "rows_with_reasons": n_with_reasons,
            }
        finally:
            await front.stop()

    plan = faults.FaultPlan().call("mesh.shard_flush", shard_fault, times=-1)
    try:
        with plan.armed():
            out = asyncio.run(run())
    finally:
        wt.close()
    return out, fronts[0].status(), injected["n"]


def _explain_burst_result(
    name: str, out: dict, status: dict, injected_n: int,
    total_rows: int, n_shards: int, victim: int, explain_k: int,
) -> ScenarioResult:
    """Common metrics + invariants of the explain-under-burst scenarios:
    p99 within budget, every row scored, every row explained (k finite
    reason codes), victim shard dead-and-shed. Family-specific scenarios
    add their own metrics/invariants on top."""
    from fraud_detection_tpu_torch.mesh.front import DEAD

    result = ScenarioResult(name)
    result.metrics = {
        "rows": total_rows,
        "rows_scored": out["rows_scored"],
        "rows_with_reasons": out["rows_with_reasons"],
        "explain_k": explain_k,
        "shards": n_shards,
        "victim": victim,
        "victim_state": status["per_shard"][victim]["state"],
        "failures_injected": injected_n,
        "baseline_p99_ms": round(out["baseline_p99_s"] * 1e3, 3),
        "burst_p99_ms": round(
            float(np.percentile(out["latencies_s"], 99)) * 1e3, 3
        ),
    }
    result.add(
        p99_within(
            out["latencies_s"], out["baseline_p99_s"],
            factor=10.0, absolute_floor_s=0.25,
        )
    )
    result.add(
        InvariantOutcome(
            "all-rows-scored",
            out["rows_scored"] == total_rows,
            f"{out['rows_scored']}/{total_rows} rows returned a score "
            "with the explain leg fused and a shard dying mid-burst",
        )
    )
    result.add(
        InvariantOutcome(
            "reasons-on-every-row",
            out["rows_with_reasons"] == total_rows,
            f"{out['rows_with_reasons']}/{total_rows} rows carried "
            f"{explain_k} finite reason codes — the contract is every "
            "scored row, including rows re-routed off the dead shard",
        )
    )
    result.add(
        InvariantOutcome(
            "shard-killed-and-shed",
            status["per_shard"][victim]["state"] == DEAD
            and injected_n > 0,
            f"victim shard {victim} ended "
            f"{status['per_shard'][victim]['state']!r} after "
            f"{injected_n} injected failure(s); load shed without "
            "dropping explain output",
        )
    )
    return result


def scenario_explain_under_burst(
    seed: int = 2026, total_rows: int = 4096, n_shards: int = 3,
    victim: int = 1, explain_k: int = 3, device=None,
) -> ScenarioResult:
    """Pareto burst with the top-k explain leg on a shard front, a shard
    killed mid-burst: the p99 invariant holds with the explain leg fused
    into every flush, EVERY scored row carries its k reason codes
    (explanations at flush latency, not minutes behind), and the mid-burst
    shard kill sheds load WITHOUT dropping the explain output (a re-routed
    row gets its reason codes from the surviving shard)."""
    out, status, injected_n = _drive_explain_burst(
        build_model(seed=seed, device=device), seed, total_rows, n_shards,
        victim, explain_k, device=device,
    )
    return _explain_burst_result(
        "explain_under_burst", out, status, injected_n,
        total_rows, n_shards, victim, explain_k,
    )


def build_gbt_model(seed: int = 7, n_base: int = 2400, device=None) -> RangeModel:
    """Fit a small GBT champion on the same synthetic Kaggle-schema data —
    served on the int8 wire with the fused TreeSHAP explain leg
    (calibration derived from the training scaler before the bin-edge
    fold, exactly what ``train --model gbt`` stamps). On the card the fit
    runs through the ``gbt_hist`` kernel."""
    import torch

    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.models.gbt import FraudGBTModel
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(D).astype(np.float32)
    x, y = _make_rows(n_base, rng, w_true)
    xt = torch.as_tensor(x, device=dev)
    scaler = scaler_fit(xt)
    # fit on SCALED inputs — fold_scaler_into_gbt maps the bin edges back
    # to raw space at wrap time, so the served forest scores raw rows
    # identically to this fit (the train --model gbt pipeline)
    forest = gbt_fit(
        scaler_transform(scaler, xt), y.astype(np.float32),
        GBTConfig(n_trees=16, max_depth=3, n_bins=32),
    )
    model = FraudGBTModel(
        forest, KAGGLE, scaler=scaler, background=x[:64], io_dtype="int8",
        device=dev,
    )
    scores = model.scorer.predict_proba(x[:1024])
    profile = build_baseline_profile(x, scores, feature_names=KAGGLE, device=dev)
    return RangeModel(model, profile, w_true, x, y)


def scenario_gbt_explain_under_burst(
    seed: int = 2027, total_rows: int = 4096, n_shards: int = 3,
    victim: int = 1, explain_k: int = 3, device=None,
) -> ScenarioResult:
    """A GBT champion serving the int8 wire with in-flush TreeSHAP reason
    codes, Pareto burst, a shard killed mid-burst. Same harness and
    invariants as ``explain_under_burst`` (the shared
    ``_drive_explain_burst`` — the two scenarios cannot diverge), plus both
    fusion gauges holding 1 throughout."""
    from fraud_detection_tpu_torch.service import metrics as svc_metrics

    rm = build_gbt_model(seed=seed, device=device)
    assert rm.model.scorer.io_dtype == "int8", "the forest serves int8"
    # process-wide gauges: zeroed, so only this scenario's batchers can
    # raise them
    svc_metrics.scorer_explain_fused.set(0)
    svc_metrics.scorer_wire_fused.set(0)
    out, status, injected_n = _drive_explain_burst(
        rm, seed, total_rows, n_shards, victim, explain_k, device=device
    )
    result = _explain_burst_result(
        "gbt_explain_under_burst", out, status, injected_n,
        total_rows, n_shards, victim, explain_k,
    )
    explain_fused = svc_metrics.scorer_explain_fused.get()
    wire_fused = svc_metrics.scorer_wire_fused.get()
    result.metrics.update(
        wire=rm.model.scorer.io_dtype,
        explain_fused_gauge=float(explain_fused),
        wire_fused_gauge=float(wire_fused),
    )
    result.add(
        InvariantOutcome(
            "fused-end-to-end",
            explain_fused == 1 and wire_fused == 1,
            "scorer_explain_fused and scorer_wire_fused must BOTH hold 1 "
            "with a GBT champion on the int8 wire (demotion can only be "
            "config error)",
        )
    )
    return result


def build_ledger_model(seed: int = 7, n_base: int = 2400, device=None):
    """A trained-for-real WIDENED champion (ledger velocity features
    replayed through the serving body) + its widened profile — the stack
    the stateful-feature scenarios serve — on ``device``. Returns
    ``(RangeModel, spec, state, t_max)``: ``state`` the replayed table as a
    host snapshot."""
    import dataclasses

    import torch

    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.ledger import (
        LEDGER_FEATURE_NAMES,
        LedgerSpec,
        materialize_features,
    )
    from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.logistic import logistic_fit_lbfgs
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(D).astype(np.float32)
    x, y = _make_rows(n_base, rng, w_true)
    x[:, -1] = np.abs(x[:, -1]) * 40.0  # a plausible Amount column
    spec0 = LedgerSpec(
        n_base=D, slots=1024, halflife_s=900.0, amount_col=-1,
        null_features=np.zeros(4, np.float32),
    )
    ents = [f"card-{i % 60}" for i in range(n_base)]
    ts = np.arange(1.0, n_base + 1.0, dtype=np.float32)
    feats, state = materialize_features(spec0, x, ents, ts, device=dev)
    spec = dataclasses.replace(spec0, null_features=feats.mean(axis=0))
    xw = np.concatenate([x, feats], axis=1).astype(np.float32)
    xwt = torch.as_tensor(xw, device=dev)
    scaler = scaler_fit(xwt)
    params = logistic_fit_lbfgs(scaler_transform(scaler, xwt), y, max_iter=100)
    names = KAGGLE + list(LEDGER_FEATURE_NAMES)
    model = FraudLogisticModel(
        params, scaler, names, ledger_spec=spec, ledger_state=state, device=dev,
    )
    scores = model.scorer.predict_proba(xw[:1024])
    profile = build_baseline_profile(xw, scores, feature_names=names, device=dev)
    return RangeModel(model, profile, w_true, x, y), spec, state, float(ts.max())


def scenario_poison_entity_state(
    seed: int = 2026, n_batches: int = 24, batch: int = 64, device=None,
) -> ScenarioResult:
    """One entity hammered with NaN/extreme amounts through the
    ``ledger.update`` injection point (a FraudRing-style mule account gone
    adversarial): the flush's poison clamp must bound the victim slot's
    aggregates, every OTHER entity's aggregates must stay BITWISE
    untouched relative to a clean run, scores stay finite, and the flush
    latency holds.

    Determinism by construction: both runs drive the REAL micro-batcher
    flush body (``MicroBatcher._flush_device`` — staging, the injection
    point, the fused ledger flush) synchronously over identical fixed
    batches, so the only difference between them is the poison itself.
    The flush's scores are views into its pooled staging slot: each batch
    copies them and releases the slot, as the batcher does after resolving
    its waiters."""
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.ledger.state import (
        AMOUNT_CLIP,
        entity_fingerprint,
        entity_slot,
        host_state,
    )
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    dev = resolve_device(device)
    rmodel, spec, state0, t0 = build_ledger_model(seed=seed, device=dev)
    target_fp = entity_fingerprint("mule-1")
    rng = np.random.default_rng(seed)
    # the campaign: background entities + the hammered mule account
    batches = []
    t = t0 + 10.0
    for b in range(n_batches):
        rows = rng.standard_normal((batch, D)).astype(np.float32)
        rows[:, -1] = np.abs(rows[:, -1]) * 40.0
        ents = []
        for i in range(batch):
            if i % 4 == 0:
                ents.append("mule-1")  # 25% of traffic is the mule
            elif i % 11 == 0:
                ents.append(None)  # legacy rows ride the null slot
            else:
                ents.append(f"card-{int(rng.integers(0, 60))}")
        ts = np.asarray([t + i * 0.25 for i in range(batch)], np.float32)
        t += batch * 0.25
        batches.append((rows, ents, ts))

    poisoned: set[tuple[int, int, str]] = set()  # (batch_idx, row_idx, kind)
    fire_count = {"b": 0}

    def poison(slot=None, batch=None, placement=None, **_):
        # alternate genuine NaN and absurd-magnitude amounts on a third of
        # the mule's staged rows (k-indexed over MULE rows, so both
        # branches are actually reachable — the mule sits at fixed batch
        # positions). The untouched mule rows then score off the CLAMPED
        # slot state, which is the containment the invariants pin.
        b = fire_count["b"]
        fire_count["b"] += 1
        k = 0
        for j in range(len(batch)):
            if slot.lf[j] == target_fp:
                if k % 3 == 0:
                    use_nan = (k // 3) % 2 == 1
                    slot.f32[j, -1] = np.nan if use_nan else 1e30
                    poisoned.add((b, j, "nan" if use_nan else "big"))
                k += 1

    def drive():
        rm, spec_, state_, _ = build_ledger_model(seed=seed, device=dev)
        wt = _watchtower(rm.profile, halflife=50_000.0, device=dev)
        wt.drift.bind_ledger(spec_, state_)
        mb = MicroBatcher(
            scorer=rm.model.scorer, watchtower=wt, telemetry=False,
            max_batch=batch,
        )
        scorer = rm.model.scorer
        tgt = mb._fused_target(scorer)
        lat: list[float] = []
        all_scores: list[float] = []
        try:
            for rows, ents, ts in batches:
                items = []
                for i in range(batch):
                    ent = None
                    if ents[i] is not None:
                        s, fp = spec_.row_keys(ents[i])
                        ent = (s, fp, float(ts[i]))
                    items.append((rows[i], None, None, ent))
                t_start = time.perf_counter()
                out = mb._flush_device(scorer, tgt, items, False)
                lat.append(time.perf_counter() - t_start)
                all_scores.extend(np.asarray(out[0], np.float64).tolist())
                scorer.staging.release(out[-1])
            snap = host_state(wt.drift.ledger_snapshot())
        finally:
            wt.close()
        return snap, lat, all_scores

    clean_snap, clean_lat, _ = drive()
    plan = faults.FaultPlan().call("ledger.update", poison)
    with plan.armed():
        poison_snap, poison_lat, poison_scores = drive()

    result = ScenarioResult("poison_entity_state")
    mule_slot = entity_slot(target_fp, spec.log2_slots)
    result.metrics = {
        "batches": n_batches,
        "poison_fired": plan.fired("ledger.update"),
        "mule_slot": mule_slot,
        "mule_count": float(poison_snap.count[mule_slot]),
        "mule_amount_sum": float(poison_snap.amount_sum[mule_slot]),
    }
    kinds = {kind for _, _, kind in poisoned}
    result.add(
        InvariantOutcome(
            "poison-injected",
            plan.fired("ledger.update") > 0 and kinds == {"nan", "big"},
            f"{plan.fired('ledger.update')} ledger.update firings, "
            f"{len(poisoned)} rows poisoned ({sorted(kinds)}) — both the "
            "NaN and extreme-amount branches must actually land",
        )
    )
    finite = all(
        bool(np.all(np.isfinite(np.asarray(leaf))))
        for leaf in (
            poison_snap.count, poison_snap.amount_sum,
            poison_snap.amount_sumsq, poison_snap.last_ts,
        )
    )
    bounded = abs(float(poison_snap.amount_sum[mule_slot])) <= (
        AMOUNT_CLIP * max(float(poison_snap.count[mule_slot]), 1.0) + 1.0
    )
    result.add(
        InvariantOutcome(
            "poison-guard-clamps",
            finite and bounded,
            "victim slot stayed finite and clamp-bounded"
            if finite and bounded
            else f"finite={finite} bounded={bounded} "
            f"sum={float(poison_snap.amount_sum[mule_slot])}",
        )
    )
    # every slot EXCEPT the mule's must be bitwise the clean run's
    others_ok = True
    detail = "all non-victim slots bitwise identical to the clean run"
    for name in ("count", "amount_sum", "amount_sumsq", "last_ts"):
        a = np.asarray(getattr(clean_snap, name)).copy()
        b = np.asarray(getattr(poison_snap, name)).copy()
        a[mule_slot] = 0
        b[mule_slot] = 0
        if a.tobytes() != b.tobytes():
            others_ok = False
            n_diff = int(np.sum(a != b))
            detail = f"{name}: {n_diff} non-victim slots differ"
            break
    result.add(InvariantOutcome("other-entities-unaffected", others_ok, detail))
    # a poisoned row's OWN score may be NaN (its staged feature is NaN —
    # request-input garbage, the service edge's concern); the containment
    # claim is that every NON-poisoned row — including the mule's clean
    # rows, which score off the clamped slot state — stays finite
    flat_poisoned = {b * batch + j for b, j, _ in poisoned}
    clean = [
        s for i, s in enumerate(poison_scores) if i not in flat_poisoned
    ]
    result.add(
        InvariantOutcome(
            "scores-finite",
            bool(np.all(np.isfinite(np.asarray(clean)))),
            f"all {len(clean)} non-poisoned rows' scores finite (incl. the "
            "mule's clean rows scoring off the clamped slot)",
        )
    )
    base_p99 = float(np.percentile(np.asarray(clean_lat), 99))
    result.add(p99_within(poison_lat, base_p99, factor=5.0))
    return result


SCENARIOS = {
    "burst": scenario_burst,
    "drift_onset": scenario_drift_onset,
    "fraud_ring": scenario_fraud_ring,
    "label_delay": scenario_label_delay,
    "control_plane_chaos": scenario_control_plane_chaos,
    "hot_swap": scenario_hot_swap,
    "shard_kill_mid_swap": scenario_shard_kill_mid_swap,
    "replica_burst": scenario_replica_burst,
    "explain_under_burst": scenario_explain_under_burst,
    "gbt_explain_under_burst": scenario_gbt_explain_under_burst,
    "poison_entity_state": scenario_poison_entity_state,
}

#: scenarios that need a scratch directory as their first argument
NEEDS_TMPDIR = (
    "label_delay",
    "control_plane_chaos",
)


def run_scenario(name: str, tmpdir: str | None = None, **kw) -> ScenarioResult:
    """Run the named scenario; ``kw`` goes to it (``device``, ``seed``,
    sizes). A scenario that needs a scratch directory gets ``tmpdir``, or
    a temporary one removed after the run."""
    fn = SCENARIOS[name]
    if name in NEEDS_TMPDIR:
        if tmpdir is None:
            import tempfile

            with tempfile.TemporaryDirectory(prefix=f"range-{name}-") as td:
                return fn(td, **kw)
        return fn(tmpdir, **kw)
    return fn(**kw)
