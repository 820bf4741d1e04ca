"""The hot swap on the port's serving path: ``ModelSlot`` and
``ModelReloader`` (``lifecycle/swap.py``), the watchtower's action sender and
rebinds, the micro-batcher's slot, the binary lane's rebind and stale-lattice
close, ``/admin/reload`` and ``/lifecycle/status``, and the whole loop through
both packages' apps, on the CPU.

Oracles, from the JAX package's tests:

- the slot swap picked up between batches and the reloader's one swap per
  alias move (``test_lifecycle.py``);
- the action sender's latch, the same sequence of sends as JAX's;
- a concurrent ``/admin/reload`` racing a promotion stalled by a FaultPlan:
  exactly one swap;
- a cross-family swap (linear → forest → linear, ``test_evergreen.py``):
  post-swap reason codes are the new family's (the forest's TreeSHAP top-k,
  values within 1e-6);
- a ledger hot swap (``test_ledger.py``): the served table after the swap is
  the challenger's stamped table, bitwise;
- a narrow → wide swap (``test_broadside.py``, without its compile count):
  post-swap scores are the wide flush's, within 1e-6 of the widened rows'
  scores;
- the binary lane's stale-lattice close (``test_binlane.py``);
- the end-to-end loop on both apps (``test_lifecycle.py``): feedback →
  retrain → ``@shadow`` → promote → ``serving_version == v2`` → rollback.
"""

import asyncio
import os
import threading
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu.data.loader import stratified_split
from fraud_detection_tpu.lifecycle import GateThresholds as JaxGateThresholds
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile as jax_profile
from fraud_detection_tpu.monitor.baseline import save_profile as jax_save_profile
from fraud_detection_tpu.monitor.watchtower import Watchtower as JaxWatchtower
from fraud_detection_tpu.ops.logistic import logistic_fit_lbfgs as jax_lbfgs
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu.ops.scaler import scaler_transform as jax_scaler_transform
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.service.taskq import Broker as JaxBroker
from fraud_detection_tpu.service.worker import XaiWorker as JaxWorker
from fraud_detection_tpu_torch.ledger import LEDGER_FEATURE_NAMES, LedgerSpec
from fraud_detection_tpu_torch.ledger import materialize_features, synthesize_entities
from fraud_detection_tpu_torch.ledger.state import host_state
from fraud_detection_tpu_torch.lifecycle import (
    Conductor,
    GateThresholds,
    LifecycleStore,
    ModelReloader,
    ModelSlot,
)
from fraud_detection_tpu_torch.lifecycle.swap import warm_fused_ladder
from fraud_detection_tpu_torch.models import load_any_model
from fraud_detection_tpu_torch.models.gbt import FraudGBTModel
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu_torch.monitor.watchtower import Thresholds, Watchtower
from fraud_detection_tpu_torch.ops.crosses import (
    CROSS_NAMES,
    CrossSpec,
    widen_scaler,
    widen_with_crosses,
)
from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.quant import derive_calibration
from fraud_detection_tpu_torch.ops.scaler import ScalerParams
from fraud_detection_tpu_torch.ops.scorer import BatchScorer
from fraud_detection_tpu_torch.range import faults
from fraud_detection_tpu_torch.service import binlane, metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import TestClient
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher
from fraud_detection_tpu_torch.service.taskq import Broker
from fraud_detection_tpu_torch.service.worker import XaiWorker
from fraud_detection_tpu_torch.tracking import TrackingClient

torch.set_num_threads(1)

KAGGLE = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
D = 30
K = 3
N_BASE = 2400
W_TRUE = np.random.default_rng(7).standard_normal(D).astype(np.float32)
NEVER = Thresholds(5.0, 5.0, 5.0, 1.0, 10**9)
#: post-swap scores and reason values against the new model's own
SWAP_ATOL = 1e-6


def _make_rows(n: int, rng):
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ W_TRUE - 2.0)))).astype(np.int32)
    return x, y


def _eye(d: int) -> ScalerParams:
    return ScalerParams(mean=torch.zeros(d), scale=torch.ones(d), var=torch.ones(d),
                        n_samples=torch.tensor(1.0))


def _linear(seed: int, d: int = D, names=None, **kw) -> FraudLogisticModel:
    rng = np.random.default_rng(seed)
    params = LogisticParams(torch.as_tensor(rng.standard_normal(d).astype(np.float32) * 0.3),
                            torch.tensor(-1.0))
    return FraudLogisticModel(params, _eye(d), names or KAGGLE, device="cpu", **kw)


def _profile(model, x):
    return build_baseline_profile(x, model.scorer.predict_proba(x),
                                  feature_names=list(model.feature_names), device="cpu")


def _save(model, x, directory):
    model.save(directory, joblib_too=False)
    save_profile(directory, _profile(model, x))
    return directory


# ---------------------------------------------------------------------------
# the slot, the reloader, the watchtower's sender and rebinds
# ---------------------------------------------------------------------------


def test_slot_swap_is_picked_up_between_batches():
    """A batch admitted before the swap scores on the old model, the next
    on the new, and the flight record names the version each ran on."""
    x = np.random.default_rng(1).standard_normal((32, D)).astype(np.float32)
    m1, m2 = _linear(1), _linear(2)
    slot = ModelSlot(m1, "test:v1", 1)
    swaps = metrics.lifecycle_model_swaps.get()

    async def run():
        mb = MicroBatcher(slot=slot, max_batch=32, max_wait_ms=1.0, telemetry=False,
                          fused=False, explain=False)
        await mb.start()
        try:
            first = await asyncio.gather(*(mb.score(x[i]) for i in range(16)))
            slot.swap(m2, "test:v2", 2)
            second = await asyncio.gather(*(mb.score(x[i]) for i in range(16)))
            assert mb.scorer is m2.scorer
            return first, second
        finally:
            await mb.stop()

    first, second = asyncio.run(run())
    np.testing.assert_allclose(first, m1.scorer.predict_proba(x[:16]), rtol=0, atol=SWAP_ATOL)
    np.testing.assert_allclose(second, m2.scorer.predict_proba(x[:16]), rtol=0, atol=SWAP_ATOL)
    assert metrics.lifecycle_model_swaps.get() == swaps + 1
    assert metrics.lifecycle_active_model_version.get() == 2
    assert slot.get() == (m2, "test:v2", 2)


def test_microbatcher_needs_a_scorer_or_a_slot():
    with pytest.raises(ValueError):
        MicroBatcher()


def test_reloader_swaps_once_per_alias_move(tmp_path, monkeypatch):
    """@prod moves: one check swaps in the registered artifact (its scores
    equal a fresh load's), a second check is a no-op, and a moved @shadow
    binds the challenger on the watchtower."""
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    x = np.random.default_rng(2).standard_normal((256, D)).astype(np.float32)
    m1 = _linear(1)
    reg = TrackingClient().registry
    v1 = reg.register("fraud", _save(m1, x, str(tmp_path / "a1")))
    v2 = reg.register("fraud", _save(_linear(2), x, str(tmp_path / "a2")))
    v3 = reg.register("fraud", _save(_linear(3), x, str(tmp_path / "a3")))
    reg.set_alias("fraud", "prod", v1)
    wt = Watchtower(_profile(m1, x), thresholds=NEVER, device="cpu")
    try:
        slot = ModelSlot(m1, "registry:models:/fraud@prod", v1)
        reloader = ModelReloader(slot, watchtower=wt, interval=0)
        swaps = metrics.lifecycle_model_swaps.get()
        assert reloader.check_once() == {"champion": "unchanged", "shadow": "unchanged"}
        reg.set_alias("fraud", "prod", v2)
        reg.set_alias("fraud", "shadow", v3)
        out = reloader.check_once()
        assert out == {"champion": f"swapped to v{v2}",
                       "shadow": f"challenger swapped to v{v3}"}
        assert slot.version == v2 and metrics.lifecycle_model_swaps.get() == swaps + 1
        fresh = load_any_model(reg.artifact_dir("fraud", v2), device="cpu")
        np.testing.assert_array_equal(slot.model.scorer.predict_proba(x[:64]),
                                      fresh.scorer.predict_proba(x[:64]))
        assert wt.shadow is not None and wt.challenger_source.endswith("@shadow")
        assert reloader.check_once() == {"champion": "unchanged", "shadow": "unchanged"}
        reg.delete_alias("fraud", "shadow")
        assert reloader.check_once()["shadow"] == f"challenger v{v3} unloaded"
        assert wt.shadow is None
        assert metrics.lifecycle_model_swaps.get() == swaps + 1
    finally:
        wt.close()


def test_a_swaps_warm_up_counts_under_the_expected_mark_and_feeds_no_storm(
        tmp_path, monkeypatch):
    """The reloader's warm-ups (``warm_scorer``, ``warm_fused_ladder``) run
    under the compile sentinel's expected mark: a kernel library loaded
    there counts in ``xla_compiles_total`` and feeds no storm, while the
    same loads unmarked do (threshold 2)."""
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.telemetry import compile_sentinel

    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("RECOMPILE_STORM_THRESHOLD", "2")
    monkeypatch.setenv("SCORER_MAX_BATCH", "64")
    compile_sentinel._reset_for_tests()
    real = kernels.fused_score

    def loading(*args, **kwargs):  # each call loads a library, as a cold card would
        kernels.LOAD_EVENTS.append(("fused_score", 0.01, threading.get_ident()))
        return real(*args, **kwargs)

    x = np.random.default_rng(2).standard_normal((256, D)).astype(np.float32)
    m1 = _linear(1)
    reg = TrackingClient().registry
    v1 = reg.register("fraud", _save(m1, x, str(tmp_path / "a1")))
    v2 = reg.register("fraud", _save(_linear(2), x, str(tmp_path / "a2")))
    reg.set_alias("fraud", "prod", v1)
    wt = Watchtower(_profile(m1, x), thresholds=NEVER, device="cpu")
    monkeypatch.setattr(kernels, "fused_score", compile_sentinel.instrument("scorer", loading))
    try:
        reloader = ModelReloader(ModelSlot(m1, "registry:models:/fraud@prod", v1),
                                 watchtower=wt, interval=0)
        before = metrics.xla_compiles.get("scorer")
        reg.set_alias("fraud", "prod", v2)
        assert reloader.check_once()["champion"] == f"swapped to v{v2}"
        # the scorer's ladder (8 … 64) and the fused ladder: one load a call
        assert metrics.xla_compiles.get("scorer") - before >= 8
        assert metrics.xla_recompile_storm.get("scorer") == 0
        assert "scorer" not in compile_sentinel._storm_windows
        for _ in range(2):
            m1.scorer.predict_proba(x[:8])  # unmarked
        assert metrics.xla_recompile_storm.get("scorer") == 1
    finally:
        wt.close()
        compile_sentinel._reset_for_tests()
        metrics.xla_recompile_storm.labels("scorer").set(0)


def test_reloader_refuses_a_wire_schema_change(tmp_path, monkeypatch):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    x = np.random.default_rng(2).standard_normal((64, D)).astype(np.float32)
    reg = TrackingClient().registry
    other = _linear(4, names=[f"f{i}" for i in range(D)])
    v = reg.register("fraud", _save(other, x, str(tmp_path / "o")))
    reg.set_alias("fraud", "prod", v)
    slot = ModelSlot(_linear(1), "test", 0)
    out = ModelReloader(slot, interval=0).check_once()
    assert out["champion"].startswith("error:") and "wire schema" in out["champion"]
    assert slot.version == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_action_sender_latches_once_per_episode(pkg, monkeypatch):
    """CONDUCTOR_AUTO_PROMOTE=1: one task a recommendation episode, re-armed
    when the recommendation changes — the same sends from both packages."""
    from fraud_detection_tpu.monitor.baseline import BaselineProfile as JaxProfile

    monkeypatch.setenv("CONDUCTOR_AUTO_PROMOTE", "1")
    x = np.random.default_rng(3).standard_normal((256, D)).astype(np.float32)
    prof = _profile(_linear(1), x)
    sent = []
    if pkg == "jax":
        import dataclasses

        fields = {f.name: getattr(prof, f.name) for f in dataclasses.fields(JaxProfile)}
        wt = JaxWatchtower(JaxProfile(**fields), action_sender=lambda t, r: sent.append(t))
    else:
        wt = Watchtower(prof, action_sender=lambda t, r: sent.append(t), device="cpu")
    try:
        d, sh = {"score_psi": 0.5}, {"score_psi": 0.01, "disagreement": 0.0}
        wt._maybe_send_action("promote_challenger", d, sh)
        wt._maybe_send_action("promote_challenger", d, sh)  # latched
        assert sent == ["lifecycle.promote_challenger"]
        wt._maybe_send_action("none", d, sh)  # episode over: re-armed
        wt._maybe_send_action("rollback_challenger", d, sh)
        assert sent == ["lifecycle.promote_challenger", "lifecycle.rollback_challenger"]
        monkeypatch.delenv("CONDUCTOR_AUTO_PROMOTE")
        wt._maybe_send_action("none", d, sh)
        wt._maybe_send_action("promote_challenger", d, sh)  # opted out
        assert len(sent) == 2
    finally:
        wt.close()


def test_rebinds_reset_the_windows():
    """rebind_champion: a fresh drift window on the new profile and the
    shadow dropped; rebind_challenger: the shadow's window restarts on the
    new challenger (swap_scorer), or unbinds."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, D)).astype(np.float32)
    m1, m2, m3 = _linear(1), _linear(2), _linear(3)
    wt = Watchtower(_profile(m1, x), challenger=m2, challenger_source="s2",
                    thresholds=NEVER, sample_rate=1.0, device="cpu")
    try:
        wt.drift.update(x, m1.scorer.predict_proba(x))
        assert wt.drift.stats()["window_rows"] > 0
        assert wt.shadow.maybe_observe(x, m1.scorer.predict_proba(x))
        shadow = wt.shadow
        wt.rebind_challenger(m3, "s3")
        assert wt.shadow is shadow and wt.shadow.stats()["window_rows"] == 0
        assert wt.challenger_source == "s3"
        new_profile = _profile(m2, x)
        wt.rebind_champion(new_profile)
        assert wt.drift.profile is new_profile and wt.drift.stats()["window_rows"] == 0
        assert wt.shadow is None and wt.challenger_source is None
        wt.rebind_challenger(m3, "s3")
        assert wt.shadow is not None
        wt.rebind_challenger(None, None)
        assert wt.shadow is None
        kept = wt.drift
        wt.rebind_champion(None)  # no profile: the old baseline keeps serving
        assert wt.drift is kept
    finally:
        wt.close()


# ---------------------------------------------------------------------------
# cross-family, ledger and wide swaps through the micro-batcher
# ---------------------------------------------------------------------------


def test_cross_family_swap_rebinds_reason_codes():
    """Linear → forest → linear through the slot, the forest's fused
    ladder warmed first as the reloader warms it: post-swap reason codes
    are the forest's TreeSHAP top-k, the fusion gauges stay 1 and the
    served family transitions both ways."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((512, D)) * 2.0).astype(np.float32)
    y = (rng.random(512) < 1 / (1 + np.exp(-(x @ W_TRUE * 0.5 - 1.0)))).astype(np.float32)
    lin = _linear(6)
    forest = FraudGBTModel(gbt_fit(x, y, GBTConfig(n_trees=8, max_depth=3, n_bins=16),
                                   device="cpu"),
                           KAGGLE, background=x[:32], device="cpu")
    wt = Watchtower(_profile(lin, x), thresholds=NEVER, device="cpu")
    slot = ModelSlot(lin, "test:lin", 1)

    async def run():
        mb = MicroBatcher(slot=slot, max_batch=32, max_wait_ms=1.0, max_inflight=4,
                          watchtower=wt, telemetry=False, fused=True, explain=True,
                          explain_k=K)
        await mb.start()
        try:
            warm_fused_ladder(wt, forest.scorer, max_batch=32, explain_k=K)
            await asyncio.gather(*(mb.score_ex(x[i]) for i in range(16)))
            slot.swap(forest, "test:gbt", 2)
            second = await asyncio.gather(*(mb.score_ex(x[i]) for i in range(16)))
            gauges = (metrics.scorer_explain_fused.get(), metrics.scorer_wire_fused.get(),
                      metrics.scorer_served_family.get("gbt"),
                      metrics.scorer_served_family.get("linear"))
            slot.swap(lin, "test:lin", 3)
            third = await asyncio.gather(*(mb.score_ex(x[i]) for i in range(16)))
            return second, third, gauges
        finally:
            await mb.stop()

    try:
        second, third, gauges = asyncio.run(run())
    finally:
        wt.drain()
        wt.close()
    phi, _ = forest.explain_batch(x[:16])
    ri = np.argsort(-phi, axis=1, kind="stable")[:, :K]
    for i, (score, reasons) in enumerate(second):
        assert score == pytest.approx(float(forest.scorer.predict_proba(x[i:i + 1])[0]),
                                      abs=SWAP_ATOL)
        assert reasons[0] == ri[i].tolist()
        np.testing.assert_allclose(reasons[1], phi[i, ri[i]], rtol=0, atol=SWAP_ATOL)
    assert gauges == (1, 1, 1, 0)
    assert all(r is not None for _, r in third)
    assert metrics.scorer_served_family.get("linear") == 1


def _ledger_model(seed: int, spec: LedgerSpec):
    """A ledger-widened model whose stamped table is a replay of random
    traffic, and its widened profile."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((400, D)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1]) * 50.0
    x[:, 0] = np.sort(rng.uniform(0, 3600, 400))
    ents, ts = synthesize_entities(x, KAGGLE, seed, 10)
    feats, state = materialize_features(spec, x, ents, ts, device="cpu")
    names = KAGGLE + list(LEDGER_FEATURE_NAMES)
    model = _linear(seed, D + len(LEDGER_FEATURE_NAMES), names, ledger_spec=spec,
                    ledger_state=state)
    xw = np.concatenate([x, feats], axis=1)
    return model, _profile(model, xw), state


def test_ledger_hot_swap_rebinds_the_stamped_table(tmp_path, monkeypatch):
    """A promoted ledger champion rebinds model + table through the
    reloader: the served table after the swap is its stamped table,
    bitwise, and traffic after the swap updates that table."""
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    spec = LedgerSpec(n_base=D, slots=64, halflife_s=600.0, amount_col=-1,
                      null_features=np.zeros(len(LEDGER_FEATURE_NAMES), np.float32))
    m1, prof1, state1 = _ledger_model(3, spec)
    m2, prof2, state2 = _ledger_model(12, spec)
    art = str(tmp_path / "v2")
    m2.save(art, joblib_too=False)
    save_profile(art, prof2)
    reg = TrackingClient().registry
    v2 = reg.register("fraud", art)
    reg.set_alias("fraud", "prod", v2)
    wt = Watchtower(prof1, thresholds=NEVER, halflife_rows=1e6, device="cpu")
    wt.drift.bind_ledger(spec, state1)
    slot = ModelSlot(m1, "test:v0", 0)

    async def drive(mb, t0):
        for i in range(8):
            s, fp = spec.row_keys(f"card-{i}")
            await mb.score(np.zeros(D, np.float32), entity=(s, fp, t0 + i))

    async def run():
        mb = MicroBatcher(slot=slot, watchtower=wt, telemetry=False, max_batch=16)
        await mb.start()
        try:
            await drive(mb, 1e6)
            out = ModelReloader(slot, watchtower=wt, interval=0).check_once()
            assert out["champion"] == f"swapped to v{v2}"
            served = wt.drift.ledger_snapshot()
            await drive(mb, 2e6)
            return served, wt.drift.ledger_snapshot()
        finally:
            await mb.stop()

    try:
        served, after = asyncio.run(run())
    finally:
        wt.close()
    assert slot.version == v2
    for a, b in zip(host_state(served), state2):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert np.asarray(after.last_ts).tobytes() != np.asarray(served.last_ts).tobytes()


def test_cross_width_swap_under_traffic_fails_no_request(tmp_path, monkeypatch):
    """Narrow → ledger through the reloader while entity-keyed requests
    keep arriving: every request resolves with a probability (a flush
    caught between the slot write and the watchtower's rebind scores
    split, through the base-width path), and the promoted table is bound."""
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    spec = LedgerSpec(n_base=D, slots=64, halflife_s=600.0, amount_col=-1,
                      null_features=np.zeros(len(LEDGER_FEATURE_NAMES), np.float32))
    ledger, prof, state = _ledger_model(12, spec)
    art = str(tmp_path / "v2")
    ledger.save(art, joblib_too=False)
    save_profile(art, prof)
    reg = TrackingClient().registry
    v2 = reg.register("fraud", art)
    reg.set_alias("fraud", "prod", v2)
    x = np.random.default_rng(6).standard_normal((512, D)).astype(np.float32)
    narrow = _linear(1)
    wt = Watchtower(_profile(narrow, x), thresholds=NEVER, device="cpu")
    slot = ModelSlot(narrow, "test:v0", 0)  # any version but the registered one

    async def run():
        mb = MicroBatcher(slot=slot, watchtower=wt, telemetry=False, max_batch=16,
                          max_wait_ms=0.5, explain=True, explain_k=K)
        await mb.start()
        stop = asyncio.Event()

        async def traffic(i):
            got = []
            while not stop.is_set():
                s, fp = spec.row_keys(f"card-{i}")
                res = await mb.score(x[len(got) % 512], entity=(s, fp, 1e6 + len(got)))
                got.append(res)
            return got

        try:
            tasks = [asyncio.create_task(traffic(i)) for i in range(6)]
            await asyncio.sleep(0.05)
            out = await asyncio.to_thread(ModelReloader(slot, watchtower=wt, interval=0).check_once)
            await asyncio.sleep(0.05)
            stop.set()
            return out, await asyncio.gather(*tasks)
        finally:
            await mb.stop()

    try:
        out, got = asyncio.run(run())
    finally:
        wt.drain()
        wt.close()
    assert out["champion"] == f"swapped to v{v2}"
    scores = [s for g in got for s in g]
    assert len(scores) > 50 and all(0.0 <= s <= 1.0 for s in scores)
    assert wt.drift.ledger is not None and wt.drift.profile.n_features == D + len(LEDGER_FEATURE_NAMES)


@pytest.mark.parametrize("kind", ["ledger", "wide_monitor", "ledger_with_lifeboat"])
def test_a_flush_between_slot_write_and_rebind_scores_split(kind, tmp_path, caplog):
    """The flush a cross-width swap can catch between its slot write and the
    watchtower's rebind: a ledger champion against the narrow monitor (or
    against a monitor of its width with no table bound) scores split,
    through its base-width null path, instead of failing. Its entity rows
    took the null slot: they are counted in ``ledger_null_entity_rows``,
    with one WARNING for the four flushes; with a lifeboat attached such a
    flush journals nothing (its rows never reach the table)."""
    from fraud_detection_tpu_torch.lifeboat import Lifeboat, read_tail

    spec = LedgerSpec(n_base=D, slots=64, halflife_s=600.0, amount_col=-1,
                      null_features=np.zeros(len(LEDGER_FEATURE_NAMES), np.float32))
    ledger, prof, state = _ledger_model(12, spec)
    x = np.random.default_rng(6).standard_normal((64, D)).astype(np.float32)
    narrow = _linear(1)
    wt = Watchtower(_profile(narrow, x) if kind != "wide_monitor" else prof, thresholds=NEVER,
                    device="cpu")
    boat = None
    if kind == "ledger_with_lifeboat":
        # the start-up monitor held a ledger table: the boat journals onto it
        drift = wt._make_drift(prof)
        drift.bind_ledger(spec, state)
        boat = Lifeboat(str(tmp_path / "lb"), spec, drift=drift, snapshot_s=1e9, fsync_s=0.0)
        boat.recover()
    slot = ModelSlot(ledger, "test:v2", 2)
    split0 = metrics.scorer_flushes.labels("split", "0").value
    null0 = metrics.ledger_null_entity_rows.get()

    async def run():
        mb = MicroBatcher(slot=slot, watchtower=wt, telemetry=False, max_batch=16,
                          lifeboat=boat)
        assert mb._fused_target(ledger.scorer) is None
        await mb.start()
        try:
            s, fp = spec.row_keys("card-1")
            return [await mb.score(x[i], entity=(s, fp, 1e6 + i)) for i in range(4)]
        finally:
            await mb.stop()

    try:
        got = asyncio.run(run())
    finally:
        wt.drain()
        wt.close()
    np.testing.assert_allclose(got, ledger.scorer.predict_proba(x[:4]), rtol=0, atol=SWAP_ATOL)
    assert metrics.scorer_flushes.labels("split", "0").value == split0 + 4
    assert metrics.ledger_null_entity_rows.get() == null0 + 4
    assert caplog.text.count("a ledger model's flush ran split") == 1
    if boat is not None:
        boat.close()
        assert boat.journal.seq == 0
        assert read_tail(str(tmp_path / "lb"), 0).n_records == 0


def test_narrow_to_wide_swap_serves_the_wide_flush():
    """Narrow → wide through the slot, the wide ladder warmed against a
    monitor built from the NEW profile and the watchtower rebound: post-swap
    scores carry the cross contributions (within 1e-6 of the widened rows'
    scores), with reason codes, and the wide gauges read 1."""
    spec = CrossSpec(n_base=D, log2_buckets=10, amount_col=D - 1, time_col=0)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((512, D)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) * 40_000
    x[:, -1] = np.abs(x[:, -1]) * 150
    fps = rng.integers(1, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
    table = (rng.standard_normal(1024) * 0.2).astype(np.float32)
    narrow = _linear(9)
    coef = np.concatenate([rng.standard_normal(D).astype(np.float32) * 0.3,
                           np.ones(4, np.float32)])
    wide = FraudLogisticModel(
        LogisticParams(torch.as_tensor(coef), torch.tensor(-1.0)),
        widen_scaler(_eye(D), 4), KAGGLE + list(CROSS_NAMES), device="cpu",
        wide_spec=spec, wide_table=table)
    xw = widen_with_crosses(x, fps, table, spec, device="cpu")
    wide_profile = _profile(wide, xw)
    wt = Watchtower(_profile(narrow, x), thresholds=NEVER, device="cpu")
    slot = ModelSlot(narrow, "test:narrow", 1)

    async def run():
        mb = MicroBatcher(slot=slot, max_batch=32, max_wait_ms=1.0, max_inflight=4,
                          watchtower=wt, telemetry=False, fused=True, explain=True,
                          explain_k=K)
        await mb.start()
        try:
            await asyncio.gather(*(mb.score(x[i]) for i in range(16)))
            warm_fused_ladder(wt, wide.scorer, max_batch=32, explain_k=K,
                              drift=wt._make_drift(wide_profile))
            slot.swap(wide, "test:wide", 2)
            wt.rebind_champion(wide_profile)
            return await asyncio.gather(*(mb.score_ex(x[i], entity=(0, int(fps[i]), 0.0))
                                          for i in range(16)))
        finally:
            await mb.stop()

    try:
        second = asyncio.run(run())
    finally:
        wt.drain()
        wt.close()
    expect = wide.scorer.predict_proba(xw[:16])
    for i, (score, reasons) in enumerate(second):
        assert score == pytest.approx(float(expect[i]), abs=SWAP_ATOL)
        assert reasons is not None
    assert metrics.scorer_wide_fused.get() == 1
    assert metrics.scorer_served_family.get("wide") == 1
    assert wt.drift.profile is wide_profile


# ---------------------------------------------------------------------------
# the binary lane
# ---------------------------------------------------------------------------


class _LoopThread:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._t = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._t.start()

    def call(self, coro, timeout=60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._t.join(timeout=5.0)


def test_hot_swap_recalibration_closes_stale_connection():
    """A hot swap that changes the int8 lattice: the next frame on an
    existing connection is answered UNAVAILABLE and the connection closes;
    a reconnect learns the new scale from its HELLO and serves."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((64, D)).astype(np.float32)
    params = LogisticParams(torch.as_tensor(rng.standard_normal(D).astype(np.float32)),
                            torch.tensor(-1.0))
    sc = ScalerParams(mean=torch.as_tensor(x.mean(0)), scale=torch.as_tensor(x.std(0)),
                      var=torch.as_tensor(x.var(0)), n_samples=torch.tensor(64.0))
    s1, s2 = (BatchScorer(params, sc, io_dtype="int8", device="cpu",
                          calibration=derive_calibration(sc, r)) for r in (8.0, 4.0))
    holder = {"scorer": s1}
    lt = _LoopThread()
    mb = MicroBatcher(s1, max_batch=64, max_wait_ms=1.0, telemetry=False, fused=False,
                      explain=False)
    lt.call(mb.start())
    srv = binlane.BinaryIngestServer(mb, scorer_fn=lambda: holder["scorer"],
                                     host="127.0.0.1", port=0, max_rows=64)
    srv.start(lt.loop)
    recal = metrics.ingest_frame_errors.get("recal")
    try:
        cli = binlane.BinLaneClient("127.0.0.1", srv.port)
        scale1 = cli.scale.copy()
        cli.score_batch(x[:8], layout=binlane.LAYOUT_INT8)
        holder["scorer"] = s2  # the promotion: another lattice
        with pytest.raises(binlane.LaneBusy) as ei:
            cli.score_batch(x[:8], layout=binlane.LAYOUT_INT8)
        assert "calibration changed" in str(ei.value)
        cli.close()
        assert metrics.ingest_frame_errors.get("recal") == recal + 1
        with binlane.BinLaneClient("127.0.0.1", srv.port) as c2:
            assert not np.array_equal(c2.scale, scale1)
            scores, _ = c2.score_batch(x[:8], layout=binlane.LAYOUT_INT8)
            assert scores.shape == (8,)
        # a swap that keeps the lattice rebinds without closing
        holder["scorer"] = BatchScorer(params, sc, io_dtype="int8", device="cpu",
                                       calibration=derive_calibration(sc, 4.0))
        with binlane.BinLaneClient("127.0.0.1", srv.port) as c3:
            c3.score_batch(x[:8], layout=binlane.LAYOUT_INT8)
            holder["scorer"] = s2
            c3.score_batch(x[:8], layout=binlane.LAYOUT_INT8)
    finally:
        srv.stop()
        lt.call(mb.stop())
        lt.close()


# ---------------------------------------------------------------------------
# the apps: /admin/reload, /lifecycle/status, and the whole loop
# ---------------------------------------------------------------------------


def _fit_champion(tmp_path, rng):
    """The JAX test's champion over a small synthetic base CSV, registered
    at @prod in a registry a package; returns (csv, x, artifact dir)."""
    x, y = _make_rows(N_BASE, rng)
    csv = str(tmp_path / "base.csv")
    with open(csv, "w") as f:
        f.write(",".join(KAGGLE + ["Class"]) + "\n")
        for row, label in zip(x, y):
            f.write(",".join(f"{v:.6f}" for v in row) + f",{int(label)}\n")
    tr, _ = stratified_split(y, 0.2, 42)
    scaler = jax_scaler_fit(x[tr])
    champion = JaxModel(jax_lbfgs(jax_scaler_transform(scaler, x[tr]), y[tr], max_iter=100),
                        scaler, KAGGLE)
    art = str(tmp_path / "champion")
    champion.save(art, joblib_too=False)
    jax_save_profile(art, jax_profile(x[tr], np.asarray(champion.scorer.predict_proba(x[:512])),
                                      feature_names=KAGGLE))
    return csv, x, art


@pytest.fixture()
def served(tmp_path, monkeypatch):
    """The port's app over a registered @prod champion, its lifecycle store
    and broker under the test's directory."""
    rng = np.random.default_rng(11)
    csv, x, art = _fit_champion(tmp_path, rng)
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "nowhere" / "model.joblib"))
    monkeypatch.setenv("LIFECYCLE_RELOAD_INTERVAL_S", "0")
    monkeypatch.setenv("LIFECYCLE_DB_URL", f"sqlite:///{tmp_path}/lifecycle.db")
    monkeypatch.setenv("DATA_CSV", csv)
    reg = TrackingClient().registry
    v1 = reg.register("fraud", art)
    reg.set_alias("fraud", "prod", v1)
    client = TestClient(create_app(database_url=f"sqlite:///{tmp_path}/fraud.db",
                                   broker_url=f"sqlite:///{tmp_path}/taskq.db", device="cpu"))
    try:
        assert client.get("/health").status_code == 200  # start-up: v1 served
        assert client.app.state["slot"].version == v1
        yield {"tmp": tmp_path, "csv": csv, "x": x, "rng": rng, "reg": reg, "v1": v1,
               "client": client}
    finally:
        client.close()


def test_admin_reload_is_gated_by_the_admin_token(served, monkeypatch):
    c = served["client"]
    assert c.post("/admin/reload").status_code == 200  # no token set: open
    monkeypatch.setenv("ADMIN_TOKEN", "s3cret")
    assert c.post("/admin/reload").status_code == 401
    assert c.post("/admin/reload", headers={"x-admin-token": "wrong"}).status_code == 401
    assert c.post("/admin/reload", headers={"x-admin-token": "s3cret"}).status_code == 200
    r = c.post("/admin/reload", headers={"authorization": "Bearer s3cret"})
    assert r.status_code == 200
    assert r.json() == {"champion": "unchanged", "shadow": "unchanged",
                        "serving_version": served["v1"],
                        "serving_source": "registry:models:/fraud@prod"}


def test_lifecycle_status_and_persisted_feedback(served):
    c = served["client"]
    s = c.get("/lifecycle/status").json()
    assert (s["enabled"], s["state"], s["serving_version"]) == (True, "idle", served["v1"])
    fx, fy = _make_rows(40, served["rng"])
    r = c.post("/monitor/feedback", json={
        "features": fx.tolist(), "scores": [0.5] * 40, "labels": fy.tolist(),
        "entity_ids": [f"e{i}" for i in range(40)], "timestamps": [1.7e9 + i for i in range(40)],
    })
    assert r.status_code == 202 and r.json()["persisted"] is True
    assert c.get("/lifecycle/status").json()["feedback"] == {
        "window": 40, "reservoir": 40, "seen": 40}
    store = c.app.state["lifecycle_store"]
    _, _, _, ents, ts = store.window_rows_meta()
    assert ents[0] == "e39" and ts[0] == np.float32(1.7e9 + 39)


def test_a_store_that_fails_to_open_degrades_to_none(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("MODEL_PATH", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models", "model.npz"))
    monkeypatch.setenv("LIFECYCLE_DB_URL", "postgresql://nobody@localhost/fraud")
    with TestClient(create_app(database_url=f"sqlite:///{tmp_path}/f.db",
                               broker_url=f"sqlite:///{tmp_path}/q.db", device="cpu")) as c:
        assert c.app.state["lifecycle_store"] is None
        assert c.get("/lifecycle/status").json() == {"enabled": False, "state": "unavailable"}
        assert c.post("/predict", json={"features": [0.1] * 30}).status_code == 200
    assert "lifecycle store unavailable" in caplog.text


def test_concurrent_admin_reload_races_promotion(served):
    """/admin/reload hammered while a promotion is in flight (stalled
    between its two registry writes by a FaultPlan): exactly one swap, and
    serving answers throughout."""
    c, reg = served["client"], served["reg"]
    store = LifecycleStore(f"sqlite:///{served['tmp']}/lifecycle.db")
    conductor = Conductor(store=store, retrain_kwargs={
        "data_csv": served["csv"], "use_smote": False, "max_iter": 100,
        "thresholds": GateThresholds(0.05, 0.5, 2.0, 64)}, device="cpu")
    fx, fy = _make_rows(512, served["rng"])
    store.add_feedback(fx, np.full(512, 0.3, np.float32), fy)
    v2 = conductor.handle_retrain("drift")["version"]
    swaps = metrics.lifecycle_model_swaps.get()
    plan = faults.FaultPlan().stall("conductor.promoting.mid_alias", seconds=0.4)
    outcome: dict = {}
    swapped = []
    with plan.armed():
        t = threading.Thread(target=lambda: outcome.update(conductor.handle_promote("race")))
        t.start()
        deadline = time.time() + 15
        while time.time() < deadline:
            r = c.post("/admin/reload")
            assert r.status_code == 200
            assert not r.json()["champion"].startswith("error"), r.json()
            if r.json()["champion"].startswith("swapped"):
                swapped.append(r.json()["champion"])
            assert c.post("/predict", json={"features": [0.1] * 30}).status_code == 200
            if not t.is_alive() and c.app.state["slot"].version == v2:
                break
        t.join(timeout=15)
    store.close()
    assert outcome.get("outcome") == "promoted" and plan.fired() == 1
    assert swapped == [f"swapped to v{v2}"]
    assert metrics.lifecycle_model_swaps.get() == swaps + 1
    assert reg.get_version_by_alias("fraud", "prod") == v2
    assert c.post("/admin/reload").json()["champion"] == "unchanged"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_end_to_end_service_loop(pkg, tmp_path, monkeypatch):
    """Labeled feedback through the API, the drift episode's retrain task
    through the worker, @shadow, the promote task, /admin/reload swapping
    the live model (serving_version == v2, no restart), then rollback —
    on either package's app and worker, with the same outcome."""
    rng = np.random.default_rng(11)
    csv, x, art = _fit_champion(tmp_path, rng)
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "nowhere" / "model.joblib"))
    monkeypatch.setenv("WATCHTOWER_MIN_ROWS", "8")
    monkeypatch.setenv("LIFECYCLE_RELOAD_INTERVAL_S", "0")
    monkeypatch.setenv("LIFECYCLE_DB_URL", f"sqlite:///{tmp_path}/lifecycle.db")
    monkeypatch.setenv("DATA_CSV", csv)
    reg = TrackingClient().registry
    v1 = reg.register("fraud", art)
    reg.set_alias("fraud", "prod", v1)
    db_url, broker_url = f"sqlite:///{tmp_path}/fraud.db", f"sqlite:///{tmp_path}/taskq.db"
    if pkg == "jax":
        make, client_cls, broker_cls = jax_create_app, JaxClient, JaxBroker
        worker = JaxWorker(broker_url=broker_url, database_url=db_url)
        thr = JaxGateThresholds(0.05, 0.5, 2.0, 64)
    else:
        make = lambda **kw: create_app(device="cpu", **kw)  # noqa: E731
        client_cls, broker_cls = TestClient, Broker
        worker = XaiWorker(broker_url=broker_url, database_url=db_url, device="cpu")
        thr = GateThresholds(0.05, 0.5, 2.0, 64)
    worker._get_conductor().retrain_kwargs.update(use_smote=False, max_iter=100,
                                                  thresholds=thr)
    client = client_cls(make(database_url=db_url, broker_url=broker_url))
    broker = broker_cls(broker_url)
    try:
        assert client.get("/health").status_code == 200
        model_before = client.app.state["slot"].model
        assert client.app.state["slot"].version == v1
        fx, fy = _make_rows(512, rng)
        fscores = (1.0 / (1.0 + np.exp(-(fx @ W_TRUE - 2.0)))).astype(np.float32)
        r = client.post("/monitor/feedback", json={
            "features": fx.tolist(), "scores": fscores.tolist(), "labels": fy.tolist()})
        assert r.status_code == 202 and r.json()["persisted"] is True
        broker.send_task("watchtower.trigger_retrain", ["test drift episode"])
        assert worker.run_once()
        v2 = reg.get_version_by_alias("fraud", "shadow")
        assert v2 == v1 + 1
        ls = client.get("/lifecycle/status").json()
        assert (ls["state"], ls["challenger_version"], ls["feedback"]["window"]) == (
            "shadowing", v2, 512)
        broker.send_task("lifecycle.promote_challenger", ["watchtower: challenger healthy"])
        assert worker.run_once()
        assert reg.get_version_by_alias("fraud", "prod") == v2
        r = client.post("/admin/reload")
        assert r.json()["champion"] == f"swapped to v{v2}"
        assert client.app.state["slot"].version == v2
        assert client.app.state["slot"].model is not model_before
        assert client.get("/lifecycle/status").json()["serving_version"] == v2
        assert client.post("/predict", json={"features": [0.1] * 30}).status_code == 200
        broker.send_task("lifecycle.rollback_challenger", ["bad challenger"])
        while worker.run_once():
            pass
        assert reg.get_version_by_alias("fraud", "prod") == v1
        assert client.post("/admin/reload").json()["champion"] == f"swapped to v{v1}"
        assert client.app.state["slot"].version == v1
        assert client.post("/predict", json={"features": [0.1] * 30}).status_code == 200
    finally:
        broker.close()
        client.close()
        worker.broker.close()
        worker.db.close()
