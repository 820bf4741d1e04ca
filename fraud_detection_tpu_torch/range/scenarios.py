"""The fraud range: named chaos scenarios against the live in-process stack.

The port's counterpart of the JAX package's ``range/scenarios.py``, all
eighteen of its scenarios. Each scenario builds the REAL serving
pieces (``BatchScorer`` behind the micro-batcher, the watchtower's drift
window, the conductor's CAS state machine, the sqlite broker, the shard
front, the binary lane on localhost sockets, the lifeboat, the app, the
longhaul fleet's directory and hosts on localhost sockets) on
``device`` — the card unless the caller asks
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
``ingest_storm``          Pareto-sized frames over the binary lane's real
                          sockets into a 2-shard front, a drain mid-burst;
                          bounded sheds with Retry-After, every admitted
                          row answered, the drift window bitwise a
                          closed-loop replay of the same flush groupings
``slo_burn_under_shed``   a burst past the admission bound on a slowed
                          legacy scorer; the SLO engine's fast burn fires
                          within its window and clears without flapping
``crash_warm_restart``    killed at ``lifeboat.journal`` mid-flush; the
                          warm restart bitwise the journal's replay and a
                          clean drive, the app's 503 gate then ready, no
                          kernel library loaded after the recovery
``kill_mid_snapshot``     killed at ``lifeboat.snapshot``, a torn newest
                          generation and a torn journal tail; the previous
                          generation loads, nothing lost, the torn flush
                          counted
``ledger_owner_failover_mid_traffic``  one host of a 2-host longhaul fleet
                          killed mid-traffic; routed scores bitwise a single
                          host's, the dead segment's 503 + Retry-After, the
                          survivor inherits from the peer's journal and its
                          table lands bitwise the single host's
``host_partition_mid_promotion``  a host partitioned from the directory
                          mid-promotion; every stale-epoch finalize fenced,
                          the post-rejoin finalize lands
``split_brain_scrape``    a partitioned host keeps answering scrapes under
                          its frozen epoch; the fleet merge drops and
                          counts it, never double-counts its window
========================  ==================================================

JAX counts a recompile as a miss of the fused flush's executable cache;
eager PyTorch has no such cache, and the port's counterpart of a miss is a
kernel library built or loaded into the process (``ops/kernels.
LOAD_EVENTS``, as in ``telemetry/compile_sentinel``). ``hot_swap`` and
``shard_kill_mid_swap`` hold no such load from the swap to the end of the
burst (vacuous on the CPU, where no kernel library exists); on the card
they also report the allocator's ``num_device_alloc`` across the same span,
the other half of what the pre-swap warm-up buys here; ``crash_warm_restart``
counts both across the recovered table's first flushes.
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


def scenario_ingest_storm(
    seed: int = 2026, n_frames: int = 48, frame_rows: int = 64,
    admit_max: int = 192, device=None,
) -> ScenarioResult:
    """Open-loop Pareto-burst frames on the REAL binary ingest lane
    (sockets on localhost, not the in-process shortcut) against a 2-shard
    front, with a mid-burst shard drain. Eight client connections drain
    the frame queue (the reference's four: a lane connection has one frame
    in flight, and four frames of 64-128 rows overrun a shard's pipeline
    of 4 flushes and the 192-row bound only when two large ones meet, so
    its sheds are a race the host's timing decides). Invariants:

    - **sheds-bounded**: the bounded admission queue sheds with busy
      frames carrying a Retry-After hint (the binary twin of HTTP 429) and
      the queued-row count never exceeds the bound — overload backs off,
      it never grows an unbounded queue;
    - **all-admitted-answered**: every frame the lane ACCEPTED returned
      exactly its row count of finite scores, through the drain;
    - **drain-clean**: the drained shard empties, the survivor keeps
      scoring;
    - **p99-holds**: accepted-frame p99 stays within budget of the quiet
      baseline;
    - **bitwise-consistent**: a single-shard open-loop socket run's drift
      window bitwise-matches a closed-loop replay of the same rows in the
      same flush groupings (continuous batching changes WHEN rows flush,
      never what the monitor sees). The port's window is updated in place,
      so each run's window is read as a ``window_snapshot()`` copy.
    """
    import asyncio as aio
    import threading

    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.mesh.front import DRAINING, ShardFront
    from fraud_detection_tpu_torch.service.binlane import (
        BinaryIngestServer,
        BinLaneClient,
        LaneBusy,
    )
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    dev = resolve_device(device)
    rm = build_model(seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    # Pareto-burst frame sizes: heavy-tailed like ArrivalProcess, clamped
    # to the frame ceiling
    sizes = np.clip(
        (frame_rows * (1.0 + rng.pareto(2.5, n_frames))).astype(int),
        8, 2 * frame_rows,
    )
    frames = [
        rng.standard_normal((int(k), D)).astype(np.float32) for k in sizes
    ]

    def loop_thread():
        loop = aio.new_event_loop()
        t = threading.Thread(
            target=lambda: (aio.set_event_loop(loop), loop.run_forever()),
            daemon=True,
        )
        t.start()
        return loop, t

    def run_on(loop, coro):
        return aio.run_coroutine_threadsafe(coro, loop).result(60.0)

    result = ScenarioResult("ingest_storm")

    # -- phase A: overload + shed + mid-burst drain on a 2-shard front ----
    wt = _watchtower(rm.profile, device=dev)
    batchers = [
        MicroBatcher(
            scorer=rm.model.scorer, watchtower=wt, telemetry=False,
            max_batch=128, max_wait_ms=20.0, admit_max_rows=admit_max,
        )
        for _ in range(2)
    ]
    front = ShardFront(batchers)
    loop, _t = loop_thread()
    srv = None
    try:
        run_on(loop, front.start())
        srv = BinaryIngestServer(
            front, scorer_fn=lambda: rm.model.scorer,
            host="127.0.0.1", port=0, max_rows=128,
        )
        srv.start(loop)

        # quiet baseline: sequential lone frames
        base_lat: list[float] = []
        with BinLaneClient("127.0.0.1", srv.port) as cli:
            for f in frames[:6]:
                t0 = time.perf_counter()
                cli.score_batch(f[:64])
                base_lat.append(time.perf_counter() - t0)
        base_p99 = float(np.percentile(np.asarray(base_lat), 99))

        # open-loop burst: the connections drain a shared frame queue at
        # max rate (no response pacing across the fleet), splitting
        # oversized frames to the lane ceiling
        work: list[np.ndarray] = []
        for f in frames:
            for lo in range(0, f.shape[0], 128):
                work.append(f[lo:lo + 128])
        qlock = threading.Lock()
        stats = {
            "answered_rows": 0, "accepted_rows": 0, "accepted": 0,
            "shed": 0, "retry_hints": [], "errors": 0, "lat": [],
        }
        queue_peaks: list[int] = []

        def sample_queues(stop_evt):
            while not stop_evt.is_set():
                queue_peaks.append(max(b._queued_rows for b in batchers))
                time.sleep(0.002)

        def client_worker():
            with BinLaneClient("127.0.0.1", srv.port) as c:
                while True:
                    with qlock:
                        if not work:
                            return
                        f = work.pop()
                    t0 = time.perf_counter()
                    try:
                        scores, _ = c.score_batch(f)
                        ok = (
                            scores.shape[0] == f.shape[0]
                            and bool(np.all(np.isfinite(scores)))
                        )
                        with qlock:
                            stats["accepted"] += 1
                            stats["accepted_rows"] += f.shape[0]
                            stats["lat"].append(time.perf_counter() - t0)
                            if ok:
                                stats["answered_rows"] += f.shape[0]
                    except LaneBusy as e:
                        with qlock:
                            stats["shed"] += 1
                            stats["retry_hints"].append(e.retry_after_s)
                    # counted into stats["errors"]; the invariant asserts 0
                    except Exception:  # lockcheck: ignore[silent-except] (the reason above)
                        with qlock:
                            stats["errors"] += 1

        stop_evt = threading.Event()
        sampler = threading.Thread(
            target=sample_queues, args=(stop_evt,), daemon=True
        )
        sampler.start()
        threads = [
            threading.Thread(target=client_worker, daemon=True)
            for _ in range(8)
        ]
        n_before_drain = len(work) // 2
        for th in threads:
            th.start()
        # mid-burst drain: wait until roughly half the work is consumed
        while True:
            with qlock:
                if len(work) <= n_before_drain:
                    break
            time.sleep(0.002)
        rows_at_drain = [h.rows_total for h in front.shards]
        front.drain(0)
        drained = front.wait_drained(0, timeout=20.0)
        for th in threads:
            th.join(timeout=60.0)
        stop_evt.set()
        sampler.join(timeout=5.0)
    finally:
        if srv is not None:
            srv.stop()
        run_on(loop, front.stop())
        wt.close()
        loop.call_soon_threadsafe(loop.stop)

    survivor_delta = front.shards[1].rows_total - rows_at_drain[1]
    peak = max(queue_peaks) if queue_peaks else 0
    result.metrics = {
        "frames_offered": len(stats["lat"]) + stats["shed"] + stats["errors"],
        "frames_accepted": stats["accepted"],
        "frames_shed": stats["shed"],
        "errors": stats["errors"],
        "answered_rows": stats["answered_rows"],
        "admit_max_rows": admit_max,
        "peak_queued_rows": peak,
        "drained_shard_state": front.shards[0].state,
        "survivor_rows_post_drain": survivor_delta,
        "baseline_p99_ms": round(base_p99 * 1e3, 3),
        "burst_p99_ms": round(
            float(np.percentile(stats["lat"], 99)) * 1e3, 3
        ) if stats["lat"] else None,
    }
    result.add(
        InvariantOutcome(
            "sheds-bounded",
            stats["shed"] > 0
            and all(r > 0 for r in stats["retry_hints"])
            and peak <= admit_max,
            f"{stats['shed']} frames shed with Retry-After hints "
            f"{sorted(set(stats['retry_hints']))}, peak queue {peak} ≤ "
            f"bound {admit_max} — overload backs off, the queue never "
            "grows unbounded",
        )
    )
    result.add(
        InvariantOutcome(
            "all-admitted-answered",
            stats["errors"] == 0
            and stats["answered_rows"] > 0
            and stats["answered_rows"] == stats["accepted_rows"],
            f"{stats['accepted']} accepted frames returned "
            f"{stats['answered_rows']}/{stats['accepted_rows']} admitted "
            f"rows as finite scores; {stats['errors']} hard errors",
        )
    )
    result.add(
        InvariantOutcome(
            "drain-clean",
            drained and front.shards[0].state == DRAINING
            and front.shards[0].inflight == 0
            and survivor_delta > 0,
            f"shard 0 drained to 0 in-flight (state "
            f"{front.shards[0].state!r}); survivor scored {survivor_delta} "
            "rows post-drain",
        )
    )
    result.add(
        p99_within(
            stats["lat"], base_p99, factor=10.0, absolute_floor_s=0.5
        )
    )

    # -- phase B: open-loop socket run vs closed-loop replay, bitwise -----
    flush_snapshots: list[np.ndarray] = []

    class RecordingBatcher(MicroBatcher):
        async def _flush(self, batch):
            rows = np.concatenate(
                [np.atleast_2d(item[0]) for item in batch]
            ).copy()
            flush_snapshots.append(rows)
            return await super()._flush(batch)

    def window_of(driver):
        wt2 = _watchtower(rm.profile, halflife=50_000.0, device=dev)
        loop2, _t2 = loop_thread()
        try:
            driver(wt2, loop2)
            win = wt2.drift.window_snapshot()
        finally:
            wt2.close()
            loop2.call_soon_threadsafe(loop2.stop)
        return win

    def open_loop(wt2, loop2):
        # max_inflight=1 serializes the window folds into snapshot order:
        # the determinism claim under test is about batching GROUPS, not
        # pipeline overlap
        mb = RecordingBatcher(
            scorer=rm.model.scorer, watchtower=wt2, telemetry=False,
            max_batch=128, max_wait_ms=5.0, max_inflight=1,
        )
        run_on(loop2, mb.start())
        srv2 = BinaryIngestServer(
            mb, scorer_fn=lambda: rm.model.scorer,
            host="127.0.0.1", port=0, max_rows=128,
        )
        srv2.start(loop2)
        try:
            def send(sub):
                with BinLaneClient("127.0.0.1", srv2.port) as c:
                    for f in sub:
                        c.score_batch(f[:128])

            parts = [frames[0::3], frames[1::3], frames[2::3]]
            ths = [
                threading.Thread(target=send, args=(p,), daemon=True)
                for p in parts
            ]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60.0)
        finally:
            srv2.stop()
            run_on(loop2, mb.stop())

    win_a = window_of(open_loop)

    def closed_loop(wt2, loop2):
        from fraud_detection_tpu_torch.ops.scorer import _bucket
        from fraud_detection_tpu_torch.service.microbatch import IngestBlock

        mb = MicroBatcher(
            scorer=rm.model.scorer, watchtower=wt2, telemetry=False,
            max_batch=128, max_wait_ms=0.0,
        )
        run_on(loop2, mb.start())
        scorer = rm.model.scorer
        try:
            async def replay(rows):
                slot = scorer.staging.acquire(
                    _bucket(rows.shape[0], scorer.min_bucket)
                )
                try:
                    slot.f32[: rows.shape[0]] = rows
                    await mb.score_block(IngestBlock(slot, rows.shape[0]))
                finally:
                    scorer.staging.release(slot)

            for rows in flush_snapshots:
                run_on(loop2, replay(rows))
        finally:
            run_on(loop2, mb.stop())

    win_b = window_of(closed_loop)
    result.metrics["flushes_replayed"] = len(flush_snapshots)
    result.add(windows_bitwise_equal(win_a, win_b))
    return result


def scenario_slo_burn_under_shed(seed: int = 2033, device=None) -> ScenarioResult:
    """A Pareto burst drives the bounded admission queue into sheds; the
    fleet SLO engine's fast-burn condition fires within its shortest
    window, the error-budget gauge drops, and — after recovery traffic
    drains the windows — the condition clears WITHOUT flapping.

    The engine runs with compressed windows (real thresholds, shorter
    spans) so the whole burn/recover cycle fits a chaos budget; the
    admission path, shed exceptions, and recording sites are the REAL
    serving ones (MicroBatcher._admit → AdmissionFull → the lane-edge
    record), not a simulation of them. The slowed scorer has no staging
    protocol, so the batcher flushes it through the legacy path (its
    ``predict_proba``).
    """
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.service.microbatch import (
        AdmissionFull,
        MicroBatcher,
    )
    from fraud_detection_tpu_torch.telemetry.slo import SLOEngine

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rm = build_model(seed=seed, device=dev)
    # compressed multi-window ladder: same 1:12:72 shape as 5m/1h/6h
    windows = {"5m": 0.5, "1h": 2.0, "6h": 6.0}
    eng = SLOEngine(windows=windows, bucket_s=0.05)
    eng.declare_lanes(("json",))

    class _SlowScorer:
        """Legacy-protocol scorer with a per-flush stall: the drain rate
        the burst must outrun to hit the admission bound (warmup/min_bucket
        delegate; no staging protocol → the batcher's legacy flush path)."""

        def __init__(self, inner, delay_s: float):
            self.inner = inner
            self.delay_s = delay_s
            self.min_bucket = inner.min_bucket

        def warmup(self, top):
            self.inner.warmup(top)

        def predict_proba(self, rows):
            time.sleep(self.delay_s)
            return self.inner.predict_proba(rows)

    flap = AlertFlapDetector(min_hold_samples=3)
    arrivals = ArrivalProcess(rate_hz=3000.0, window_s=0.01)

    async def run() -> dict:
        batcher = MicroBatcher(
            scorer=_SlowScorer(rm.model.scorer, 0.02),
            max_batch=8, max_wait_ms=1.0, max_inflight=1,
            telemetry=False, admit_max_rows=8,
        )
        await batcher.start()
        out: dict = {"sheds": 0, "scored": 0, "non_finite": 0}
        try:
            # phase 1 — healthy floor: sequential singles, all good
            for r in rng.standard_normal((24, D)).astype(np.float32):
                t0 = time.perf_counter()
                s = await batcher.score(r)
                eng.record("json", True, time.perf_counter() - t0)
                if not np.isfinite(s):
                    out["non_finite"] += 1
            out["budget_before"] = eng.snapshot()[
                "availability:json"]["budget_remaining"]
            out["fast_before"] = eng.fast_burn("json")

            # phase 2 — ten Pareto-burst waves, each offered concurrently —
            # far over the 8-row admission bound, so the tail of every wave
            # sheds exactly as a saturated open-loop client would see
            first_shed_t: float | None = None
            first_fast_t: float | None = None
            waves = [
                max(24, n) for n in arrivals.batch_sizes(480, rng)
            ][:10]
            for wave_n in waves:
                rows = rng.standard_normal((wave_n, D)).astype(np.float32)

                async def one(r):
                    t0 = time.perf_counter()
                    try:
                        s = await batcher.score(r)
                    except AdmissionFull:
                        eng.record("json", False)
                        return None
                    eng.record("json", True, time.perf_counter() - t0)
                    return s

                scores = await asyncio.gather(*(one(r) for r in rows))
                shed = sum(1 for s in scores if s is None)
                out["sheds"] += shed
                out["scored"] += sum(1 for s in scores if s is not None)
                out["non_finite"] += sum(
                    1 for s in scores
                    if s is not None and not np.isfinite(s)
                )
                now = time.monotonic()
                if shed and first_shed_t is None:
                    first_shed_t = now
                fast = eng.fast_burn("json")
                flap.sample(slo_fast_burn=fast)
                if fast and first_fast_t is None:
                    first_fast_t = now
            out["budget_after_burst"] = eng.snapshot()[
                "availability:json"]["budget_remaining"]
            out["first_shed_t"] = first_shed_t
            out["first_fast_t"] = first_fast_t

            # phase 3 — recovery: light good traffic until the longest
            # window drains; the condition must clear and stay clear
            t_end = time.monotonic() + windows["6h"] + 1.0
            cleared_samples = 0
            while time.monotonic() < t_end:
                r = rng.standard_normal(D).astype(np.float32)
                t0 = time.perf_counter()
                s = await batcher.score(r)
                eng.record("json", True, time.perf_counter() - t0)
                if not np.isfinite(s):
                    out["non_finite"] += 1
                fast = eng.fast_burn("json")
                flap.sample(slo_fast_burn=fast)
                if not fast:
                    cleared_samples += 1
                await asyncio.sleep(0.1)
            out["fast_after_recovery"] = eng.fast_burn("json")
            out["cleared_samples"] = cleared_samples
            out["budget_after_recovery"] = eng.snapshot()[
                "availability:json"]["budget_remaining"]
            return out
        finally:
            await batcher.stop()

    out = asyncio.run(run())
    result = ScenarioResult("slo_burn_under_shed")
    result.metrics = {
        "sheds": out["sheds"],
        "scored": out["scored"],
        "budget_before": out["budget_before"],
        "budget_after_burst": out["budget_after_burst"],
        "budget_after_recovery": out["budget_after_recovery"],
    }
    result.add(InvariantOutcome(
        "burst-drives-sheds",
        out["sheds"] > 0 and out["scored"] > 0,
        f"{out['sheds']} sheds, {out['scored']} scored — the burst must "
        "genuinely hit the admission bound while traffic still flows",
    ))
    result.add(InvariantOutcome(
        "scores-finite",
        out["non_finite"] == 0,
        f"{out['non_finite']} non-finite scores among admitted rows",
    ))
    result.add(InvariantOutcome(
        "fast-burn-fires-within-window",
        out["first_shed_t"] is not None
        and out["first_fast_t"] is not None
        and out["first_fast_t"] - out["first_shed_t"]
        <= windows["5m"] + 1.0,
        "fast burn fired "
        + (
            f"{out['first_fast_t'] - out['first_shed_t']:.2f}s after the "
            f"first shed (window {windows['5m']}s)"
            if out["first_fast_t"] is not None
            and out["first_shed_t"] is not None
            else "never"
        ),
    ))
    result.add(InvariantOutcome(
        "budget-drops-under-burn",
        out["budget_after_burst"] < out["budget_before"],
        f"budget {out['budget_before']} -> {out['budget_after_burst']} "
        "across the burst",
    ))
    result.add(InvariantOutcome(
        "burn-clears-after-recovery",
        not out["fast_after_recovery"] and out["cleared_samples"] > 0,
        "fast-burn condition "
        + ("cleared" if not out["fast_after_recovery"] else "still firing")
        + f" after recovery ({out['cleared_samples']} clear samples)",
    ))
    result.add(flap.check())
    return result


# -- lifeboat scenarios ------------------------------------------------------

def _entity_batches(seed: int, n_batches: int, batch: int, t0: float):
    """Seeded entity-bearing traffic: rows + entity ids + strictly
    increasing timestamps, bitwise-identical across drives (the recovery
    parity invariants compare runs fed from this)."""
    rng = np.random.default_rng(seed + 77)
    batches = []
    t = t0 + 10.0
    for _b in range(n_batches):
        rows = rng.standard_normal((batch, D)).astype(np.float32)
        rows[:, -1] = np.abs(rows[:, -1]) * 40.0
        ents: list[str | None] = []
        for i in range(batch):
            if i % 9 == 0:
                ents.append(None)  # legacy rows ride the null slot
            else:
                ents.append(f"card-{int(rng.integers(0, 60))}")
        ts = np.asarray([t + i * 0.25 for i in range(batch)], np.float32)
        t += batch * 0.25
        batches.append((rows, ents, ts))
    return batches


def _drive_ledger_batches(mb, scorer, spec, batches, tables_out=None):
    """Push batches synchronously through the REAL flush body
    (``MicroBatcher._flush_device`` — staging, the lifeboat journal hook,
    the fused stateful dispatch); optionally capture a copy of the table
    after every batch. The flush's scores are views into its pooled
    staging slot: each batch copies them and releases the slot, as the
    batcher does after resolving its waiters. Returns the scores."""
    tgt = mb._fused_target(scorer)
    scores: list[float] = []
    for rows, ents, ts in batches:
        items = []
        for i in range(rows.shape[0]):
            ent = None
            if ents[i] is not None:
                s, fp = spec.row_keys(ents[i])
                ent = (s, fp, float(ts[i]))
            items.append((rows[i], None, None, ent))
        out = mb._flush_device(scorer, tgt, items, False)
        scores.extend(np.asarray(out[0], np.float64).tolist())
        scorer.staging.release(out[-1])
        if tables_out is not None:
            tables_out.append(mb.watchtower.drift.ledger_snapshot())
    return scores


def _tables_equal(a, b) -> tuple[bool, str]:
    """Bitwise comparison over every LedgerState leaf, of tables on any
    device or the host (each read in the file's dtypes)."""
    from fraud_detection_tpu_torch.ledger.state import host_state

    if a is None or b is None:
        return False, "missing table"
    a, b = host_state(a), host_state(b)
    for name in ("acc", "last_ts", "fingerprint", "collisions", "evictions"):
        av = np.asarray(getattr(a, name))
        bv = np.asarray(getattr(b, name))
        if av.tobytes() != bv.tobytes():
            n_diff = int(np.sum(av != bv))
            return False, f"{name}: {n_diff} element(s) differ"
    return True, "bitwise equal on every leaf"


def _ledger_serve(seed: int, batch: int, dev, lbdir: str | None = None):
    """A ledger champion served by a micro-batcher over its bound table,
    with a lifeboat on ``lbdir`` (fsync every append, no timed snapshot)
    when given: ``(rm, spec, state0, wt, mb, boat, t0)``, ``state0`` the
    train-time stamp on the host."""
    from fraud_detection_tpu_torch.lifeboat import Lifeboat
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    rm, spec, state0, t0 = build_ledger_model(seed=seed, device=dev)
    wt = _watchtower(rm.profile, halflife=50_000.0, device=dev)
    wt.drift.bind_ledger(spec, state0)
    boat = None
    if lbdir is not None:
        boat = Lifeboat(lbdir, spec, drift=wt.drift, snapshot_s=1e9, fsync_s=0.0)
    mb = MicroBatcher(
        scorer=rm.model.scorer, watchtower=wt, telemetry=False,
        max_batch=batch, lifeboat=boat,
    )
    return rm, spec, state0, wt, mb, boat, t0


def _clean_tables(seed: int, n_batches: int, batch: int, dev):
    """The clean reference: the scenario's traffic with no lifeboat and no
    crash, the table copied after every batch. Returns ``(tables,
    batches, t0, state0)``."""
    rm, spec, state0, wt, mb, _, t0 = _ledger_serve(seed, batch, dev)
    batches = _entity_batches(seed, n_batches, batch, t0)
    tables: list = []
    try:
        _drive_ledger_batches(mb, rm.model.scorer, spec, batches, tables)
    finally:
        wt.close()
    return tables, batches, t0, state0


def scenario_crash_warm_restart(
    tmpdir: str, seed: int = 2026, n_batches: int = 12, batch: int = 64,
    snapshot_after: int = 6, device=None,
) -> ScenarioResult:
    """Kill the serving process mid-flush under live entity-bearing
    traffic, then warm-restart from the lifeboat's snapshot + journal.

    The kill lands at the ``lifeboat.journal`` injection point — AFTER the
    flush's entity triples are durably journaled (fsync-per-append here),
    BEFORE the fused dispatch folds them into the device table — the
    journal-ahead window a real SIGKILL can always hit. Invariants:

    - **recovery parity (bitwise)**: the warm-restarted table equals an
      independent replay of the same snapshot + journal bytes AND equals a
      clean uninterrupted drive over the identical traffic (the journaled
      kill-flush replays; nothing is lost, nothing is double-folded);
    - **two restarts agree**: a second, fully independent restart (the
      REAL service app pointed at the same directory, serving on
      ``device`` through ``create_app(device=)``) recovers the SAME bytes
      to the SAME table;
    - **readiness gate**: while the app's recovery is in flight, /health
      and /predict answer 503 with Retry-After, then /health flips to 200
      once the replay binds (``recovering → ready``);
    - **no recompile storm**: no kernel library is built or loaded while
      the recovered table serves its first flushes (the port's count of
      JAX's fused-flush cache misses; vacuous on the CPU); on the card the
      allocator's ``num_device_alloc`` across the same span is reported
      beside it, not gated.
    """
    import shutil
    import threading

    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.lifeboat import load_latest, read_tail, replay_records

    dev = resolve_device(device)
    lbdir = os.path.join(tmpdir, "lifeboat")
    result = ScenarioResult("crash_warm_restart")

    # -- clean reference: the same traffic, no lifeboat, no crash ----------
    ref_tables, batches, t0, _ = _clean_tables(seed, n_batches, batch, dev)

    # -- the crashing serve ------------------------------------------------
    rm, spec, _, wt, mb, boat, _ = _ledger_serve(seed, batch, dev, lbdir)
    boat.recover()  # fresh directory: opens the journal, state -> ready
    killed = False
    plan = faults.FaultPlan().kill("lifeboat.journal")
    try:
        _drive_ledger_batches(mb, rm.model.scorer, spec, batches[:snapshot_after])
        boat.take_snapshot()
        _drive_ledger_batches(mb, rm.model.scorer, spec, batches[snapshot_after:-1])
        with plan.armed():
            try:
                _drive_ledger_batches(mb, rm.model.scorer, spec, batches[-1:])
            except faults.ReplicaKilled:
                killed = True  # the crash: nothing closes cleanly
    finally:
        wt.close()
    result.add(
        InvariantOutcome(
            "killed-mid-flush",
            killed and plan.fired("lifeboat.journal") == 1,
            "ReplicaKilled after the journal append, before the dispatch",
        )
    )

    # -- warm restart (library level, on a copy of the bytes) --------------
    lbdir_b = os.path.join(tmpdir, "lifeboat-restart")
    shutil.copytree(lbdir, lbdir_b)
    rm2, spec2, _, wt2, mb2, boat2, _ = _ledger_serve(seed, batch, dev, lbdir_b)
    try:
        # startup warmup with the train-time stamp — the flush is warm
        # BEFORE recovery binds, exactly the app's startup order
        _drive_ledger_batches(
            mb2, rm2.model.scorer, spec2,
            _entity_batches(seed + 1, 1, batch, t0),
        )
        compiles_before = _kernel_loads()
        allocs_before = _device_allocs(dev)
        rep = boat2.recover()
        recovered = wt2.drift.ledger_snapshot()

        # independent replay of the same disk bytes — no Lifeboat wiring
        snap, _skipped = load_latest(lbdir_b)
        tail = read_tail(lbdir_b, snap.seq if snap else 0)
        manual = replay_records(
            spec2, snap.ledger if snap else None, tail.records, device=dev
        )
        ok_manual, detail_manual = _tables_equal(rep.state, manual)
        ok_ref, detail_ref = _tables_equal(recovered, ref_tables[-1])

        # post-recovery serving: finite scores, no kernel library loaded,
        # journaling resumed past the recovered sequence number
        seq_at_recovery = boat2.journal.seq
        post_scores = _drive_ledger_batches(
            mb2, rm2.model.scorer, spec2,
            _entity_batches(
                seed + 2, 2, batch, t0 + (n_batches + 2) * batch * 0.25
            ),
        )
        compiles_delta = _kernel_loads() - compiles_before
        allocs_after = _device_allocs(dev)
        journal_resumed = boat2.journal.seq == seq_at_recovery + 2
    finally:
        wt2.close()
        boat2.close()

    result.metrics = {
        "batches": n_batches,
        "snapshot_seq": rep.snapshot_seq,
        "replayed_rows": rep.replayed_rows,
        "torn_rows": rep.torn_rows,
        "recovery_duration_s": round(rep.duration_s, 4),
        "post_recovery_compiles": compiles_delta,
        "post_recovery_device_allocs": (
            None if allocs_before is None else allocs_after - allocs_before
        ),
    }
    result.add(
        InvariantOutcome(
            "recovery-parity-vs-journal-bytes",
            rep.restored and ok_manual,
            "recovered table bitwise-equals an independent replay of the "
            f"same snapshot+journal bytes ({detail_manual})",
        )
    )
    result.add(
        InvariantOutcome(
            "recovery-parity-vs-clean-run",
            ok_ref,
            "recovered table bitwise-equals the uninterrupted clean drive "
            f"over identical traffic ({detail_ref})",
        )
    )
    result.add(
        InvariantOutcome(
            "kill-flush-replayed",
            rep.replayed_rows > 0 and rep.snapshot_seq == snapshot_after,
            f"{rep.replayed_rows} journaled rows past snapshot seq "
            f"{rep.snapshot_seq} replayed (incl. the killed flush)",
        )
    )
    result.add(
        InvariantOutcome(
            "no-recompile-storm",
            compiles_delta == 0,
            f"{compiles_delta} kernel libraries built or loaded after "
            "recovery bound the restored table (must be 0)",
        )
    )
    result.add(
        InvariantOutcome(
            "post-recovery-scores-finite",
            bool(np.all(np.isfinite(np.asarray(post_scores))))
            and journal_resumed,
            f"{len(post_scores)} post-recovery rows scored finite, journal "
            "sequence resumed past the recovered point",
        )
    )

    # -- the REAL service edge: a second independent restart of the same
    # bytes, with the readiness gate observed through /health + /predict --
    from fraud_detection_tpu_torch.monitor.baseline import save_profile
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.http import TestClient

    model_dir = os.path.join(tmpdir, "models")
    rm.model.save(model_dir, joblib_too=False)
    save_profile(model_dir, rm.profile)
    env_keys = {
        # the loader serves the native model.npz beside MODEL_PATH
        "MODEL_PATH": os.path.join(model_dir, "logistic_model.joblib"),
        "LIFEBOAT_DIR": lbdir,
        "MLFLOW_TRACKING_URI": f"file:{os.path.join(tmpdir, 'mlruns')}",
    }
    saved_env = {k: os.environ.get(k) for k in env_keys}
    os.environ.update(env_keys)
    gate = threading.Event()
    app_plan = faults.FaultPlan().call(
        "lifeboat.recover", lambda **ctx: gate.wait(timeout=60.0), times=1
    )
    client = None
    try:
        with app_plan.armed():
            app = create_app(
                database_url=f"sqlite:///{tmpdir}/fraud.db",
                broker_url=f"sqlite:///{tmpdir}/taskq.db",
                device=dev,
            )
            client = TestClient(app)
            r_health = client.get("/health")
            r_predict = client.post(
                "/predict", json={"features": [0.1] * D}
            )
            gate.set()
            deadline = time.time() + 60.0
            r_ready = r_health
            while time.time() < deadline:
                r_ready = client.get("/health")
                if r_ready.status_code == 200:
                    break
                time.sleep(0.05)
        status = client.get("/lifeboat/status").json()
        app_table = app.state["watchtower"].drift.ledger_snapshot()
        result.metrics["app_device"] = app_table.acc.device.type
    finally:
        if client is not None:
            client.close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    retry_after = {k.lower(): v for k, v in r_health.headers.items()}.get(
        "retry-after"
    )
    result.add(
        InvariantOutcome(
            "readiness-503-while-recovering",
            r_health.status_code == 503
            and retry_after is not None
            and float(retry_after) > 0
            and r_predict.status_code == 503
            and r_health.json().get("error") == "recovering",
            f"/health={r_health.status_code} (Retry-After={retry_after}), "
            f"/predict={r_predict.status_code} during replay",
        )
    )
    result.add(
        InvariantOutcome(
            "readiness-flips-ready",
            r_ready.status_code == 200
            and status.get("state") == "ready"
            and (status.get("last_recovery") or {}).get("restored") is True,
            f"/health flipped to {r_ready.status_code}, lifeboat state "
            f"{status.get('state')} after replaying "
            f"{(status.get('last_recovery') or {}).get('replayed_rows')} rows",
        )
    )
    ok_app, detail_app = _tables_equal(app_table, rep.state)
    result.add(
        InvariantOutcome(
            "independent-restarts-agree",
            ok_app,
            "the app's recovered table bitwise-equals the library "
            f"restart of the same bytes ({detail_app})",
        )
    )
    return result


def scenario_kill_mid_snapshot(
    tmpdir: str, seed: int = 2027, n_batches: int = 10, batch: int = 64,
    snapshot_after: int = 4, device=None,
) -> ScenarioResult:
    """Kill the snapshotter between the journal rotation and the
    generation file landing (the ``lifeboat.snapshot`` injection point),
    then fabricate a TORN newest generation on top — the two disk shapes a
    crash mid-snapshot can leave. Invariants:

    - **previous generation loads**: recovery skips exactly the torn file
      (``generations_skipped == 1``) and restores from the last good
      generation;
    - **nothing lost**: the journal was rotated AT the captured sequence
      number and synced before the kill, so replay lands the full table —
      bitwise equal to a clean uninterrupted drive;
    - **torn journal tail**: truncating the final journal record drops
      exactly that flush — CRC-skip, the loss counted on
      ``lifeboat_torn_tail_rows_total``, and the recovered table bitwise
      equals the clean drive one flush back (loss is bounded AND
      accounted, never silent corruption).
    """
    from fraud_detection_tpu_torch import lifeboat as lb
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.service import metrics as svc_metrics

    dev = resolve_device(device)
    lbdir = os.path.join(tmpdir, "lifeboat")
    result = ScenarioResult("kill_mid_snapshot")

    # clean reference with the table captured after every batch
    ref_tables, batches, _, state_ref = _clean_tables(seed, n_batches, batch, dev)

    # serve with the lifeboat; second snapshot dies mid-write
    rm, spec, _, wt, mb, boat, _ = _ledger_serve(seed, batch, dev, lbdir)
    boat.recover()
    killed = False
    plan = faults.FaultPlan().kill("lifeboat.snapshot")
    try:
        _drive_ledger_batches(mb, rm.model.scorer, spec, batches[:snapshot_after])
        boat.take_snapshot()  # generation 1 lands cleanly
        _drive_ledger_batches(mb, rm.model.scorer, spec, batches[snapshot_after:])
        with plan.armed():
            try:
                boat.take_snapshot()  # rotated, then killed pre-write
            except faults.ReplicaKilled:
                killed = True
    finally:
        wt.close()
    result.add(
        InvariantOutcome(
            "killed-mid-snapshot",
            killed and plan.fired("lifeboat.snapshot") == 1,
            "ReplicaKilled after the journal rotation, before the "
            "generation file landed",
        )
    )

    # a torn newest generation on top: valid bytes truncated mid-payload
    # (the shape a crash mid-write leaves on a filesystem without the
    # atomic-rename guarantee, or plain disk damage)
    scratch = os.path.join(tmpdir, "scratch")
    full = lb.write_snapshot(
        scratch, n_batches, spec, state_ref, rows_seen=0
    )
    with open(full, "rb") as f:
        blob = f.read()
    torn_path = os.path.join(lbdir, f"lifeboat-{n_batches:012d}.snap")
    with open(torn_path, "wb") as f:
        f.write(blob[: int(len(blob) * 0.6)])

    # warm restart: the torn file is skipped, generation 1 + full journal
    # replay land the complete table
    _, spec2, _, wt2, _, boat2, _ = _ledger_serve(seed, batch, dev, lbdir)
    try:
        rep = boat2.recover()
        recovered = wt2.drift.ledger_snapshot()
    finally:
        wt2.close()
        boat2.close()
    ok_full, detail_full = _tables_equal(recovered, ref_tables[-1])
    result.add(
        InvariantOutcome(
            "generation-fallback",
            rep.generations_skipped == 1
            and rep.snapshot_seq == snapshot_after,
            f"torn newest generation skipped ({rep.generations_skipped}), "
            f"restored from generation seq {rep.snapshot_seq}",
        )
    )
    result.add(
        InvariantOutcome(
            "nothing-lost-on-fallback",
            rep.restored and rep.torn_rows == 0 and ok_full,
            "rotated+synced journal replays the full table bitwise vs the "
            f"clean drive ({detail_full})",
        )
    )

    # torn journal TAIL: truncate the last record's CRC — the final flush
    # is lost, counted, and the table lands one flush back
    journals = lb.list_journals(lbdir)
    last_rows = int(np.sum([e is not None for e in batches[-1][1]]))
    # the rotated file carrying records past generation 1 is the one whose
    # base is the generation's sequence number
    tail_file = next(
        path for base, path in journals if base == snapshot_after
    )
    with open(tail_file, "rb") as f:
        jblob = f.read()
    with open(tail_file, "wb") as f:
        f.write(jblob[:-6])
    torn_before = svc_metrics.lifeboat_torn_tail_rows.get()
    boat3 = lb.Lifeboat(lbdir, spec2, snapshot_s=1e9, fsync_s=0.0, device=dev)
    try:
        rep2 = boat3.recover()
    finally:
        boat3.close()
    torn_delta = svc_metrics.lifeboat_torn_tail_rows.get() - torn_before
    ok_torn, detail_torn = _tables_equal(rep2.state, ref_tables[-2])
    result.metrics = {
        "batches": n_batches,
        "generation_seq": rep.snapshot_seq,
        "generations_skipped": rep.generations_skipped,
        "replayed_rows_full": rep.replayed_rows,
        "replayed_rows_torn_tail": rep2.replayed_rows,
        "torn_tail_rows": rep2.torn_rows,
    }
    result.add(
        InvariantOutcome(
            "torn-tail-bounded-loss",
            rep2.torn_rows == last_rows
            and torn_delta == last_rows
            and ok_torn,
            f"torn tail dropped exactly the final flush ({rep2.torn_rows} "
            f"rows, counted on lifeboat_torn_tail_rows_total), table lands "
            f"one flush back bitwise ({detail_torn})",
        )
    )
    return result


# -- longhaul: the multi-host switchyard -------------------------------------

def _keyed_batches(spec, batches):
    """Entity strings → ``(slot, fp, ts)`` triples, the form the front
    routes on and the micro-batcher stages."""
    out = []
    for rows, ents, ts in batches:
        ke = [
            None if e is None else (*spec.row_keys(e), float(ts[i]))
            for i, e in enumerate(ents)
        ]
        out.append((rows, ke))
    return out


def _longhaul_fleet(tmpdir: str, seed: int, dead_after_s: float = 1.0, device=None):
    """A 2-host localhost fleet on ``device``: directory + two
    lifeboat-backed hosts + front, plus the single-host parity reference.
    Returns ``(dirsrv, h_a, h_b, b_ref, front, fleet_dir, t0)``;
    :func:`_close_fleet` tears it down."""
    from fraud_detection_tpu_torch.longhaul.front import LonghaulFront
    from fraud_detection_tpu_torch.longhaul.host import HostServer, build_seeded_backend
    from fraud_detection_tpu_torch.longhaul.membership import DirectoryServer

    dirsrv = DirectoryServer(
        os.path.join(tmpdir, "dir"), n_hosts=2, dead_after_s=dead_after_s
    )
    dirsrv.start()
    fleet_dir = os.path.join(tmpdir, "fleet")
    b_a, t0 = build_seeded_backend(seed, fleet_dir, "host-a", device=device)
    b_b, _ = build_seeded_backend(seed, fleet_dir, "host-b", device=device)
    h_a = HostServer(
        "host-a", b_a, n_hosts=2, directory_addr=dirsrv.addr, heartbeat_s=0.2,
    )
    h_b = HostServer(
        "host-b", b_b, n_hosts=2, directory_addr=dirsrv.addr, heartbeat_s=0.2,
    )
    h_a.start()
    h_b.start()
    b_ref, _ = build_seeded_backend(seed, "", "ref", device=device)
    front = LonghaulFront(b_ref.spec, n_hosts=2, directory_addr=dirsrv.addr)
    # both joins must be visible in every host's serving claim before
    # traffic flows (host-a momentarily ring-owns both segments)
    _wait_until(lambda: h_a.owned_segments == {0} and h_b.owned_segments == {1})
    return dirsrv, h_a, h_b, b_ref, front, fleet_dir, t0


def _close_fleet(front, h_a, h_b, b_ref, dirsrv, kill_b: bool) -> None:
    """Tear a :func:`_longhaul_fleet` down: the front, the hosts (``h_b``
    killed or closed), the directory, then the three backends' threads."""
    front.close()
    h_a.close()
    if kill_b:
        h_b.kill()
    else:
        h_b.close()
    dirsrv.close()
    for backend in (h_a.backend, h_b.backend, b_ref):
        backend.close()


def _wait_until(pred, timeout_s: float = 5.0) -> None:
    """Poll ``pred`` every 50 ms until it holds or ``timeout_s`` passes."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)


def _wait_dead(dirsrv, rank: int, timeout_s: float = 6.0) -> float:
    """Block until the failure detector declares ``rank`` dead; returns
    the detection latency."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        m = dirsrv.view().member_by_rank(rank)
        if m is not None and not m.alive:
            return time.monotonic() - t0
        time.sleep(0.05)
    raise TimeoutError(f"rank {rank} never declared dead")


def _rank_alive(dirsrv, rank: int) -> bool:
    m = dirsrv.view().member_by_rank(rank)
    return m is not None and m.alive


#: the subprocess drill's seed (JAX's multihost bench), its probes on the
#: dead segment, and a child's start-up bound (the interpreter, the card,
#: the seeded fit)
DRILL_SEED, DRILL_PROBES, DRILL_READY_S = 7, 4, 300.0


def longhaul_drill(
    work: str, n_hosts: int, n_batches: int, rows: int, device: str,
    fmts, kill: bool = True,
) -> dict:
    """The fleet as it deploys: a directory in this process and ``n_hosts``
    children of ``python -m fraud_detection_tpu_torch.longhaul.host`` on
    ``device`` (``DEVICE=cpu`` for the CPU, no ``DEVICE`` for the card),
    spawned together and each past its ``LONGHAUL_READY`` handshake, its
    start-up log naming ``device``. ``n_batches`` batches of ``rows`` rows
    are routed through a front, batch ``k`` in ``fmts[k]``, each bitwise
    the in-process single-host reference's scores.

    With ``kill`` (two hosts), rank 1's child is SIGKILLed after the first half's last
    answer; ``DRILL_PROBES`` requests on its segment (in ``fmts`` by turns) must
    each answer the typed 503 with Retry-After > 0; ``drive_failover``
    must restore the segment from the peer's journal with no torn row; the
    second half is then routed, and the survivor's ``table`` op must be
    bitwise the reference's table on every leaf. Raises ``AssertionError``
    at the first disagreement; returns the readings (host clock)."""
    import select
    import signal
    import subprocess
    import sys

    import fraud_detection_tpu_torch
    from fraud_detection_tpu_torch.ledger.state import host_state
    from fraud_detection_tpu_torch.longhaul import codec
    from fraud_detection_tpu_torch.longhaul.codec import Unavailable
    from fraud_detection_tpu_torch.longhaul.front import LonghaulFront
    from fraud_detection_tpu_torch.longhaul.host import build_seeded_backend
    from fraud_detection_tpu_torch.longhaul.membership import DirectoryServer

    if kill and n_hosts != 2:
        raise ValueError("the kill drill runs on two hosts")
    tag = f"longhaul drill, {n_hosts} hosts"
    seed = DRILL_SEED
    root = os.path.dirname(os.path.dirname(os.path.abspath(fraud_detection_tpu_torch.__file__)))
    env = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    env.update(PYTHONPATH=root, LONGHAUL_HEARTBEAT_S="0.25", FRAUD_STORE_TOKEN="")
    if device == "cpu":
        env.update(DEVICE="cpu", OMP_NUM_THREADS="1")
    fleet = os.path.join(work, "fleet")
    dirsrv = DirectoryServer(os.path.join(work, "dir"), n_hosts=n_hosts,
                             dead_after_s=1.5, token="")
    dirsrv.start()
    logs = [os.path.join(work, f"h{i}.log") for i in range(n_hosts)]
    procs, front, ref = [], None, None

    def route(batch, fmt):
        b_rows, ents, ts = batch
        payload = codec.encode_request(b_rows, ents, ts, fmt, spec=ref.spec)
        return codec.decode_response(front.handle_request(payload, fmt), fmt)

    def same(k, got):
        if got.tobytes() != want[k].tobytes():
            raise AssertionError(f"{tag}: batch {k} ({fmts[k]}) differs from the reference "
                                 f"at {int(np.sum(got != want[k]))} rows")

    try:
        t = time.perf_counter()
        for i, log_path in enumerate(logs):
            with open(log_path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "fraud_detection_tpu_torch.longhaul.host",
                     "--host-id", f"h{i}", "--port", "0", "--directory", dirsrv.addr,
                     "--n-hosts", str(n_hosts), "--seed", str(seed), "--data-dir", fleet],
                    cwd=root, env=env, stdout=subprocess.PIPE, stderr=log, text=True))
        for p, log_path in zip(procs, logs):
            deadline = time.perf_counter() + DRILL_READY_S
            while True:
                if time.perf_counter() > deadline or p.poll() is not None:
                    with open(log_path) as f:
                        raise AssertionError(f"{tag}: a host never got ready (rc {p.poll()}): "
                                             f"{f.read()[-3000:]}")
                if select.select([p.stdout], [], [], 0.5)[0]:
                    if p.stdout.readline().startswith("LONGHAUL_READY"):
                        break
        ready_s = time.perf_counter() - t
        for log_path in logs:
            with open(log_path) as f:
                text = f.read()
            if f"serving on {device}" not in text:
                raise AssertionError(f"{tag}: a child's start-up log names no {device} "
                                     f"device: {text[-2000:]}")

        ref, t0 = build_seeded_backend(seed, "", "ref", device=device)
        raw = _entity_batches(seed, n_batches, rows, t0)
        want = [ref.score_items([(r[i], None, None, ke[i]) for i in range(r.shape[0])])
                for r, ke in _keyed_batches(ref.spec, raw)]
        front = LonghaulFront(ref.spec, n_hosts=n_hosts, directory_addr=dirsrv.addr, token="")
        # every host live and serving exactly its own segment before any
        # traffic: a request one owner serves and another refuses has
        # folded the first one's rows, and a retry would fold them twice
        deadline = time.perf_counter() + 60.0
        while not (len(front.refresh_view(force=True).live_ranks) == n_hosts and all(
                front.handles[r].call("status", {})["owned_segments"] == [r]
                for r in range(n_hosts))):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{tag}: the hosts never settled their claims")
            time.sleep(0.1)
        half = n_batches // 2 if kill else n_batches
        t = time.perf_counter()
        for k in range(half):
            same(k, route(raw[k], fmts[k]))
        readings = {"ready_s": ready_s, "routed_s": time.perf_counter() - t,
                    "routed_rows": half * rows,
                    "hosts": sorted(h.host_id for h in front.handles.values())}
        if not kill:
            return readings

        dead = dirsrv.view().member_by_rank(1).host_id
        victim = procs[int(dead[1:])]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=60)
        detect_s = _wait_dead(dirsrv, rank=1)
        p_rows, ents, ts = raw[half]
        idx = [i for i, e in enumerate(ents)
               if e is not None and ref.spec.row_keys(e)[0] % n_hosts == 1]
        probe = (p_rows[idx], [ents[i] for i in idx], ts[idx])
        retry = []
        for k in range(DRILL_PROBES):
            try:
                route(probe, fmts[k % len(fmts)])
            except Unavailable as exc:
                retry.append(exc.retry_after_s)
            else:
                raise AssertionError(f"{tag}: a probe on the dead segment was served")
        if min(retry) <= 0.0:
            raise AssertionError(f"{tag}: a 503 without Retry-After: {retry}")
        t = time.perf_counter()
        summary = front.drive_failover(1, os.path.join(fleet, dead))
        failover_s = time.perf_counter() - t
        if not (summary and summary["restored"] and summary["torn_rows"] == 0
                and summary["replayed_rows"] > 0):
            raise AssertionError(f"{tag}: failover {summary}")
        t = time.perf_counter()
        for k in range(half, n_batches):
            same(k, route(raw[k], fmts[k]))
        post_s = time.perf_counter() - t
        survivor = front.handles[0]
        table = codec.unpack_table(survivor.call("table", {}))
        ref_table = host_state(ref.table())
        for name, a, b in zip(ref_table._fields, table, ref_table):
            if np.asarray(a).tobytes() != np.asarray(b).tobytes():
                raise AssertionError(f"{tag}: the survivor's {name} differs from the "
                                     "reference's")
        owned = survivor.call("status", {})["owned_segments"]
        if owned != [0, 1]:
            raise AssertionError(f"{tag}: the survivor serves {owned} after the failover")
        readings.update(
            dead=dead, detect_s=detect_s, retry_after_s=retry, failover_s=failover_s,
            replayed_rows=summary["replayed_rows"], torn_rows=summary["torn_rows"],
            replay_rows_per_sec=summary["replay_rows_per_sec"], post_s=post_s,
            post_rows=(n_batches - half) * rows,
        )
        return readings
    finally:
        if front is not None:
            front.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
            p.stdout.close()
        dirsrv.close()
        if ref is not None:
            ref.close()


def scenario_ledger_owner_failover_mid_traffic(
    tmpdir: str, seed: int = 2027, n_batches: int = 8, batch: int = 32,
    device=None,
) -> ScenarioResult:
    """Kill one host of a 2-host fleet mid-traffic; the survivor inherits
    the dead peer's ledger segment from its journal generation.

    Invariants:

    - **routed-bitwise**: scores routed through the front (before the kill
      and after the failover) are bitwise an uninterrupted single-host
      serve of the same batches;
    - **degraded-503**: between the kill and the completed inheritance,
      every request touching the dead owner's segment answers the typed
      503 with a positive Retry-After — never a silent serve from a table
      that has not inherited the rows;
    - **failover-bitwise**: after the inheritance and the remaining
      traffic, the survivor's whole table (both segments, the scalar
      counters too) is bitwise the uninterrupted single-host table;
    - **zero-new-compiles**: the inheritance rebinds the merged table with
      the live table's device, shapes and dtypes — no kernel library is
      built or loaded across it and the traffic after it (the port's count
      of JAX's fused-flush cache misses; vacuous on the CPU). On the card
      the allocator's ``num_device_alloc`` across the same span is
      reported beside it, not gated.
    """
    from fraud_detection_tpu_torch import config as config_mod
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.ledger.state import host_state
    from fraud_detection_tpu_torch.longhaul import placement
    from fraud_detection_tpu_torch.longhaul.codec import Unavailable

    dev = resolve_device(device)
    result = ScenarioResult("ledger_owner_failover_mid_traffic")
    dirsrv, h_a, h_b, b_ref, front, fleet_dir, t0 = _longhaul_fleet(
        tmpdir, seed, device=dev
    )
    spec = b_ref.spec
    try:
        batches = _keyed_batches(spec, _entity_batches(seed, n_batches, batch, t0))
        half = n_batches // 2

        def ref_drive(rows, ke):
            return b_ref.score_items(
                [(rows[i], None, None, ke[i]) for i in range(rows.shape[0])]
            )

        pre_ok = True
        for rows, ke in batches[:half]:
            ref = ref_drive(rows, ke)
            routed = front.score(rows, ke, fmt="json")
            pre_ok = pre_ok and ref.tobytes() == routed.tobytes()
        result.add(
            InvariantOutcome(
                "routed-bitwise-pre-kill", pre_ok,
                f"{half} routed batches bitwise equal to the single-host "
                "serve (per-slot fold independence)",
            )
        )

        # -- the kill: abrupt, mid-traffic ---------------------------------
        h_b.kill()
        detect_s = _wait_dead(dirsrv, rank=1)

        # a probe carrying ONLY the dead owner's segment: every attempt
        # during the handoff must surface the typed 503
        rows_p, ke_p = batches[half]
        idx = [
            i for i, e in enumerate(ke_p)
            if e is not None and placement.host_of(int(e[0]), 2) == 1
        ]
        probe_rows = rows_p[idx]
        probe_ke = [ke_p[i] for i in idx]
        degraded, attempts = True, 0
        for _ in range(3):
            attempts += 1
            try:
                front.score(probe_rows, probe_ke, fmt="json")
                degraded = False
            except Unavailable as exc:
                degraded = degraded and exc.retry_after_s > 0.0
        result.add(
            InvariantOutcome(
                "degraded-503-with-retry-after", degraded,
                f"{attempts} mid-handoff attempts on the dead owner's "
                "segment all answered 503 + Retry-After "
                f"(retry_after_s={config_mod.longhaul_retry_after_s()})",
            )
        )

        compiles_before = _kernel_loads()
        allocs_before = _device_allocs(dev)
        t_fo = time.monotonic()
        summary = front.drive_failover(1, os.path.join(fleet_dir, "host-b"))
        failover_s = time.monotonic() - t_fo
        restored = bool(summary and summary.get("restored"))
        result.add(
            InvariantOutcome(
                "failover-restores-segment",
                restored and summary["torn_rows"] == 0
                and summary["replayed_rows"] > 0,
                f"survivor replayed {summary and summary['replayed_rows']}"
                f" rows from the peer generation in "
                f"{summary and round(summary['duration_s'], 3)}s",
            )
        )

        # remaining traffic: everything routes to the survivor now
        post_ok = True
        for rows, ke in batches[half:]:
            ref = ref_drive(rows, ke)
            routed = front.score(rows, ke, fmt="json")
            post_ok = post_ok and ref.tobytes() == routed.tobytes()
        result.add(
            InvariantOutcome(
                "routed-bitwise-post-failover", post_ok,
                f"{n_batches - half} batches served by the survivor "
                "bitwise equal to the uninterrupted serve",
            )
        )

        compiles_delta = _kernel_loads() - compiles_before
        allocs_after = _device_allocs(dev)
        t_ref = host_state(b_ref.table())
        t_srv = host_state(h_a.backend.table())
        eq, detail = placement.segments_equal(t_srv, t_ref, [0, 1], 2)
        scal_ok = (
            t_srv.collisions.tobytes() == t_ref.collisions.tobytes()
            and t_srv.evictions.tobytes() == t_ref.evictions.tobytes()
        )
        result.add(
            InvariantOutcome(
                "survivor-table-bitwise",
                eq and scal_ok and h_a.owned_segments == {0, 1},
                f"survivor owns both segments; full table {detail}; "
                f"scalar counters {'match' if scal_ok else 'DIFFER'}",
            )
        )
        result.add(
            InvariantOutcome(
                "zero-new-compiles", compiles_delta == 0,
                f"{compiles_delta} kernel libraries built or loaded across "
                "inherit + post-failover traffic",
            )
        )
        result.metrics = {
            "batches": n_batches,
            "detect_s": round(detect_s, 3),
            "failover_s": round(failover_s, 3),
            "replayed_rows": summary and summary["replayed_rows"],
            "replay_rows_per_sec": summary
            and round(summary["replay_rows_per_sec"], 1),
            "mid_handoff_503s": attempts,
            "compiles_delta": compiles_delta,
            "inherit_device_allocs": (
                None if allocs_before is None else allocs_after - allocs_before
            ),
        }
        return result
    finally:
        _close_fleet(front, h_a, h_b, b_ref, dirsrv, kill_b=True)


def scenario_host_partition_mid_promotion(
    tmpdir: str, seed: int = 2028, device=None,
) -> ScenarioResult:
    """Partition a host from the directory mid-promotion: every finalize
    decided under the pre-partition epoch must die, and exactly the
    post-rejoin finalize under the fresh epoch lands.

    The epoch is the fence token: the partitioned host cannot REACH the
    directory (fail-safe — unreachable means un-finalizable), and a
    reachable host holding the old epoch sees the directory has moved on.
    """
    from fraud_detection_tpu_torch.service import metrics as svc_metrics

    fenced = svc_metrics.longhaul_promotion_fenced
    result = ScenarioResult("host_partition_mid_promotion")
    dirsrv, h_a, h_b, b_ref, front, _fleet, _t0 = _longhaul_fleet(
        tmpdir, seed, device=device
    )
    try:
        epoch_before = dirsrv.view().epoch
        fenced_before = fenced.get("host-b") + fenced.get("host-a")

        # the partition: control-plane packets stop routing for B
        h_b.partitioned = True
        detect_s = _wait_dead(dirsrv, rank=1)
        epoch_dead = dirsrv.view().epoch
        result.add(
            InvariantOutcome(
                "partition-detected",
                epoch_dead > epoch_before,
                f"detector declared the partitioned host dead in "
                f"{detect_s:.2f}s (epoch {epoch_before} -> {epoch_dead})",
            )
        )

        # fence 1: the partitioned host itself — directory unreachable
        res_b = h_b.finalize_promotion("v2", epoch_before)
        # fence 2: a reachable host holding the stale epoch
        res_a = h_a.finalize_promotion("v2", epoch_before)
        result.add(
            InvariantOutcome(
                "stale-finalizes-fenced",
                not res_b["applied"] and res_b.get("fenced")
                and not res_a["applied"] and res_a.get("fenced"),
                f"partitioned host: {res_b.get('reason', '')[:60]}; "
                f"stale-epoch host: {res_a.get('reason', '')[:60]}",
            )
        )

        # heal: B rejoins (its next heartbeat learns it was declared dead
        # and re-registers), the epoch bumps again
        h_b.partitioned = False
        _wait_until(lambda: _rank_alive(dirsrv, 1))
        epoch_fresh = dirsrv.view().epoch
        res_a2 = h_a.finalize_promotion("v2", epoch_fresh)
        res_b2 = h_b.finalize_promotion("v2", epoch_fresh)
        result.add(
            InvariantOutcome(
                "fresh-finalize-lands",
                res_a2["applied"] and res_b2["applied"]
                and h_a.served_version == "v2"
                and h_b.served_version == "v2",
                f"both hosts finalized v2 under fresh epoch {epoch_fresh}",
            )
        )
        fenced_after = fenced.get("host-b") + fenced.get("host-a")
        result.add(
            InvariantOutcome(
                "fences-counted",
                fenced_after - fenced_before == 2,
                f"longhaul_promotion_fenced_total grew by "
                f"{fenced_after - fenced_before} (one per refused "
                "finalize)",
            )
        )
        result.metrics = {
            "detect_s": round(detect_s, 3),
            "epoch_before": epoch_before,
            "epoch_dead": epoch_dead,
            "epoch_fresh": epoch_fresh,
        }
        return result
    finally:
        _close_fleet(front, h_a, h_b, b_ref, dirsrv, kill_b=False)


def scenario_split_brain_scrape(
    tmpdir: str, seed: int = 2029, n_batches: int = 4, batch: int = 32,
    device=None,
) -> ScenarioResult:
    """A partitioned host keeps serving and answering scrapes under its
    frozen epoch; the fleet merge must never double-count it.

    Invariants: the stale contribution is dropped and counted
    (``longhaul_scrape_stale_epoch``), the merged drift window equals the
    live host's window alone (not the sum), and after rejoin the merge
    re-admits both hosts under the fresh epoch.
    """
    from fraud_detection_tpu_torch.longhaul import scrape as scrape_mod
    from fraud_detection_tpu_torch.longhaul.front import HostHandle
    from fraud_detection_tpu_torch.monitor.drift import _window_leaves
    from fraud_detection_tpu_torch.service import metrics as svc_metrics

    stale_epoch = svc_metrics.longhaul_scrape_stale_epoch
    result = ScenarioResult("split_brain_scrape")
    dirsrv, h_a, h_b, b_ref, front, _fleet, t0 = _longhaul_fleet(
        tmpdir, seed, device=device
    )
    spec = b_ref.spec
    clients = [
        HostHandle("host-a", 0, h_a.addr, h_a.token),
        HostHandle("host-b", 1, h_b.addr, h_b.token),
    ]
    try:
        batches = _keyed_batches(spec, _entity_batches(seed, n_batches, batch, t0))
        for rows, ke in batches:
            front.score(rows, ke, fmt="json")

        epoch0 = dirsrv.view().epoch
        # both hosts must have learned the current epoch before the
        # baseline scrape, or their stamps race the sweep
        _wait_until(lambda: h_a.known_epoch == epoch0 and h_b.known_epoch == epoch0)
        base = scrape_mod.fleet_scrape(clients, epoch0)
        both_counted = (
            sorted(base["accepted"]) == ["host-a", "host-b"]
            and base["window"] is not None
        )
        n_rows_both = float(np.sum(np.asarray(base["window"].n_rows)))
        result.add(
            InvariantOutcome(
                "healthy-scrape-merges-both", both_counted,
                f"pre-partition scrape merged 2 hosts, window n_rows="
                f"{n_rows_both:.1f}",
            )
        )

        # the partition: B's control plane freezes (its epoch stays stale),
        # its DATA plane — the scrape op among it — keeps answering
        h_b.partitioned = True
        _wait_dead(dirsrv, rank=1)
        epoch1 = dirsrv.view().epoch
        # the live host must learn the bumped epoch before the scrape, or
        # ITS contribution would read stale too
        _wait_until(lambda: h_a.known_epoch == epoch1)
        stale_before = stale_epoch.get("host-b")
        split = scrape_mod.fleet_scrape(clients, epoch1)
        stale_delta = stale_epoch.get("host-b") - stale_before
        # the no-double-count pin: the merged window is A's alone —
        # bitwise — not A + a stale copy of B
        a_only = scrape_mod.fleet_scrape(clients[:1], epoch1)
        merged_is_a = (
            split["window"] is not None
            and a_only["window"] is not None
            and all(
                np.asarray(x).tobytes() == np.asarray(y).tobytes()
                for x, y in zip(_window_leaves(split["window"]),
                                _window_leaves(a_only["window"]))
            )
        )
        result.add(
            InvariantOutcome(
                "stale-epoch-dropped",
                split["stale"] == ["host-b"]
                and split["accepted"] == ["host-a"]
                and stale_delta == 1,
                f"split-brain contribution dropped and counted "
                f"(stale_epoch delta={stale_delta})",
            )
        )
        result.add(
            InvariantOutcome(
                "no-double-count", merged_is_a,
                "merged window under the split is bitwise the live "
                "host's window alone",
            )
        )

        # heal: B rejoins and the next scrape re-admits it
        h_b.partitioned = False
        _wait_until(lambda: _rank_alive(dirsrv, 1))
        epoch2 = dirsrv.view().epoch
        _wait_until(lambda: h_a.known_epoch == epoch2 and h_b.known_epoch == epoch2)
        healed = scrape_mod.fleet_scrape(clients, epoch2)
        result.add(
            InvariantOutcome(
                "rejoin-readmits",
                sorted(healed["accepted"]) == ["host-a", "host-b"],
                f"post-rejoin scrape merged both hosts under epoch "
                f"{epoch2}",
            )
        )
        result.metrics = {
            "epoch_baseline": epoch0,
            "epoch_split": epoch1,
            "epoch_healed": epoch2,
            "window_rows_baseline": round(n_rows_both, 1),
        }
        return result
    finally:
        for c in clients:
            c.close()
        _close_fleet(front, h_a, h_b, b_ref, dirsrv, kill_b=False)


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
    "ingest_storm": scenario_ingest_storm,
    "slo_burn_under_shed": scenario_slo_burn_under_shed,
    "crash_warm_restart": scenario_crash_warm_restart,
    "kill_mid_snapshot": scenario_kill_mid_snapshot,
    "ledger_owner_failover_mid_traffic": (
        scenario_ledger_owner_failover_mid_traffic
    ),
    "host_partition_mid_promotion": scenario_host_partition_mid_promotion,
    "split_brain_scrape": scenario_split_brain_scrape,
}

#: scenarios that need a scratch directory as their first argument
NEEDS_TMPDIR = (
    "label_delay",
    "control_plane_chaos",
    "crash_warm_restart",
    "kill_mid_snapshot",
    "ledger_owner_failover_mid_traffic",
    "host_partition_mid_promotion",
    "split_brain_scrape",
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
