"""The port's range traffic generators and invariant checks
(``fraud_detection_tpu_torch/range/{traffic,invariants}.py``) against the
JAX package's, on the CPU.

Both modules are numpy only, and the port keeps its own copies. Tolerances:

- traffic: bitwise. For seeds 0, 7 and 2026 and each ingredient (arrivals,
  drift, ring, feedback) the batches' rows, labels, start rows, ring masks
  and drift flags are the reference's bytes, and so are the delayed-label
  joiner's released ``(x, s, y)`` batches and its release and flip counts;
- invariants: the same ``(name, ok)`` and the same detail string as JAX on
  shared fixtures, among them a drift window one bit apart (the port's
  ``DriftWindow`` of tensors against JAX's ``NamedTuple`` of arrays) and a
  flapping status sequence.

Also the traffic properties of the JAX package's ``tests/test_range.py``
(determinism per seed, bursty exact arrivals, the drift onset, ring rows
fraud and correlated, the joiner's delay and noise) on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fraud_detection_tpu.monitor.drift import init_window as jax_init_window
from fraud_detection_tpu.range import invariants as jinv
from fraud_detection_tpu.range import traffic as jtr
from fraud_detection_tpu_torch.monitor.drift import init_window
from fraud_detection_tpu_torch.range import invariants as tinv
from fraud_detection_tpu_torch.range import traffic as ttr

torch.set_num_threads(1)

D = 30
SEEDS = (0, 7, 2026)


def _spec(mod, ingredient: str, seed: int):
    kw = {"total_rows": 3072, "seed": seed}
    if ingredient == "arrivals":
        kw["arrivals"] = mod.ArrivalProcess(rate_hz=4000.0, window_s=0.01)
    elif ingredient == "drift":
        kw["drift"] = mod.DriftCampaign(onset_row=1024, label_flip_rate=0.2,
                                        scale_stretch=1.5)
    elif ingredient == "ring":
        kw["ring"] = mod.FraudRing(start_row=256, n_rings=3, ring_size=96,
                                   every_rows=288, center_scale=5.0)
    elif ingredient == "feedback":
        kw["feedback"] = mod.LabelFeedback(delay_rows=512, noise_rate=0.05, batch=64)
    else:  # all four at once
        kw["drift"] = mod.DriftCampaign(onset_row=1024)
        kw["ring"] = mod.FraudRing(start_row=256, ring_size=32, every_rows=128)
        kw["feedback"] = mod.LabelFeedback(delay_rows=512, noise_rate=0.05, batch=64)
    return mod.CampaignSpec(**kw)


def _eq(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ingredient", ["arrivals", "drift", "ring", "feedback", "all"])
def test_campaign_streams_are_bitwise_jax(seed, ingredient):
    jt = jtr.CampaignTraffic(_spec(jtr, ingredient, seed))
    tt = ttr.CampaignTraffic(_spec(ttr, ingredient, seed))
    _eq(jt.w_true, tt.w_true)
    jb, tb = list(jt.batches()), list(tt.batches())
    assert len(jb) == len(tb) > 10
    for a, b in zip(jb, tb):
        assert a.start_row == b.start_row and a.drifted == b.drifted
        _eq(a.rows, b.rows)
        _eq(a.labels, b.labels)
        _eq(a.ring_mask, b.ring_mask)
    if ingredient == "ring":
        assert sum(int(b.ring_mask.sum()) for b in tb) > 0
    if ingredient in ("feedback", "all"):
        fb_j, fb_t = jt.spec.feedback, tt.spec.feedback
        jj = jtr.DelayedLabelJoiner(fb_j, seed)
        tj = ttr.DelayedLabelJoiner(fb_t, seed)
        released = 0
        for a, b in zip(jb, tb):
            s = np.linspace(0.0, 1.0, a.rows.shape[0], dtype=np.float32)
            jj.observe(a, s)
            tj.observe(b, s)
            cur = a.start_row + a.rows.shape[0]
            out_j, out_t = list(jj.due(cur)), list(tj.due(cur))
            assert len(out_j) == len(out_t)
            for (xj, sj, yj), (xt, st, yt) in zip(out_j, out_t):
                _eq(xj, xt)
                _eq(sj, st)
                _eq(yj, yt)
                released += yt.shape[0]
        assert (jj.released_rows, jj.flipped_rows) == (tj.released_rows, tj.flipped_rows)
        assert tj.released_rows == released > 0 and tj.flipped_rows > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_ingredients_alone_are_bitwise_jax(seed):
    """Each ingredient's own draw: the arrival sizes, the ring centers, a
    drift campaign applied to one batch (its label flips included)."""
    kw = dict(rate_hz=2000.0, window_s=0.01, diurnal_depth=0.6, burst_alpha=1.5)
    sizes_j = jtr.ArrivalProcess(**kw).batch_sizes(8192, np.random.default_rng(seed))
    sizes_t = ttr.ArrivalProcess(**kw).batch_sizes(8192, np.random.default_rng(seed))
    assert sizes_j == sizes_t and sum(sizes_t) == 8192
    _eq(jtr.FraudRing(start_row=0).centers(np.random.default_rng(seed)),
        ttr.FraudRing(start_row=0).centers(np.random.default_rng(seed)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, D)).astype(np.float32)
    y = (rng.random(64) < 0.3).astype(np.int32)
    for start in (0, 100, 200):
        dj = jtr.DriftCampaign(onset_row=130, label_flip_rate=0.5).apply(
            x, y, start, np.random.default_rng(seed))
        dt = ttr.DriftCampaign(onset_row=130, label_flip_rate=0.5).apply(
            x, y, start, np.random.default_rng(seed))
        _eq(dj[0], dt[0])
        _eq(dj[1], dt[1])


# -- the JAX package's traffic properties, on the port ------------------------

def test_traffic_is_deterministic_per_seed():
    spec = ttr.CampaignSpec(
        total_rows=2048, seed=11,
        drift=ttr.DriftCampaign(onset_row=512),
        ring=ttr.FraudRing(start_row=256, ring_size=32, every_rows=128),
    )
    a = list(ttr.CampaignTraffic(spec).batches())
    b = list(ttr.CampaignTraffic(spec).batches())
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        np.testing.assert_array_equal(ba.rows, bb.rows)
        np.testing.assert_array_equal(ba.labels, bb.labels)
        np.testing.assert_array_equal(ba.ring_mask, bb.ring_mask)
    assert sum(x.rows.shape[0] for x in a) == 2048


def test_arrivals_are_bursty_and_exact():
    rng = np.random.default_rng(0)
    sizes = ttr.ArrivalProcess(rate_hz=2000.0, window_s=0.01).batch_sizes(8192, rng)
    assert sum(sizes) == 8192
    assert min(sizes) >= 1
    assert max(sizes) > 3 * float(np.median(sizes))


def test_drift_campaign_respects_onset():
    spec = ttr.CampaignSpec(
        total_rows=2048, seed=5,
        drift=ttr.DriftCampaign(onset_row=1024, features=(0,), mean_shift=10.0),
    )
    pre, post = [], []
    for b in ttr.CampaignTraffic(spec).batches():
        for i in range(b.rows.shape[0]):
            (post if b.start_row + i >= 1024 else pre).append(b.rows[i, 0])
    assert abs(np.mean(pre)) < 1.0
    assert np.mean(post) > 8.0


def test_ring_rows_are_fraud_and_correlated():
    spec = ttr.CampaignSpec(
        total_rows=3072, seed=9,
        ring=ttr.FraudRing(start_row=0, ring_size=64, every_rows=192),
    )
    ring_rows, ring_labels = [], []
    for b in ttr.CampaignTraffic(spec).batches():
        ring_rows.append(b.rows[b.ring_mask])
        ring_labels.append(b.labels[b.ring_mask])
    rows = np.concatenate(ring_rows)
    labels = np.concatenate(ring_labels)
    assert rows.shape[0] > 0
    assert np.all(labels == 1)
    feats = list(spec.ring.ring_features)
    per_feature_var = np.var(rows[:32][:, feats].astype(np.float64), axis=0)
    assert float(per_feature_var.max()) < 0.1


def test_delayed_label_joiner_releases_after_delay_with_noise():
    fb = ttr.LabelFeedback(delay_rows=512, noise_rate=0.5, batch=64)
    spec = ttr.CampaignSpec(total_rows=1536, seed=3, feedback=fb)
    joiner = ttr.DelayedLabelJoiner(fb, seed=3)
    released_at: list[tuple[int, int]] = []
    for b in ttr.CampaignTraffic(spec).batches():
        joiner.observe(b, np.zeros(b.rows.shape[0], np.float32))
        current = b.start_row + b.rows.shape[0]
        for _, _, fy in joiner.due(current):
            released_at.append((current, fy.shape[0]))
    assert joiner.released_rows > 0
    assert all(cur >= 512 for cur, _ in released_at)
    frac = joiner.flipped_rows / joiner.released_rows
    assert 0.3 < frac < 0.7


# -- invariants: the same outcomes and details ---------------------------------

def _same(j, t) -> None:
    assert (j.name, bool(j.ok), j.detail) == (t.name, bool(t.ok), t.detail)


@pytest.mark.parametrize("args", [
    (100, 150, 100), (100, 250, 100), (100, None, 100), (100, 90, 100), (0, 0, 0),
])
def test_drift_detected_within_equals_jax(args):
    _same(jinv.drift_detected_within(*args), tinv.drift_detected_within(*args))


@pytest.mark.parametrize("lat,base,kw", [
    ([0.002] * 100, 0.001, dict(factor=5.0, absolute_floor_s=0.0)),
    ([0.2] * 100, 0.001, dict(factor=5.0, absolute_floor_s=0.05)),
    ([0.04] * 100, 0.001, dict(factor=5.0, absolute_floor_s=0.05)),
    (list(np.linspace(0.001, 0.3, 257)), 0.02, dict(factor=10.0, absolute_floor_s=0.25)),
    ([], 0.001, {}),
])
def test_p99_within_equals_jax(lat, base, kw):
    _same(jinv.p99_within(lat, base, **kw), tinv.p99_within(lat, base, **kw))


def test_windows_bitwise_equal_catches_one_bit_as_jax_does():
    """The port's window is a dataclass of tensors, JAX's a NamedTuple of
    arrays: equal windows pass and a one-bit ``n_rows`` difference fails
    with the same detail, field by field."""
    ja, jb = jax_init_window(4, 8, 8), jax_init_window(4, 8, 8)
    ta, tb = init_window(4, 8, 8), init_window(4, 8, 8)
    _same(jinv.windows_bitwise_equal(ja, jb), tinv.windows_bitwise_equal(ta, tb))
    assert tinv.windows_bitwise_equal(ta, tb).ok
    jc = jb._replace(n_rows=jb.n_rows + 1e-7)
    tc = dataclasses.replace(tb, n_rows=tb.n_rows + 1e-7)
    _same(jinv.windows_bitwise_equal(ja, jc), tinv.windows_bitwise_equal(ta, tc))
    assert not tinv.windows_bitwise_equal(ta, tc).ok
    # one flipped bit in a count: the differing byte is named by field
    counts = tb.feature_counts.clone()
    counts.view(torch.int32)[2, 3] ^= 1
    td = dataclasses.replace(tb, feature_counts=counts)
    jcounts = np.asarray(jb.feature_counts).copy()
    jcounts.view(np.int32)[2, 3] ^= 1
    jd = jb._replace(feature_counts=jcounts)
    _same(jinv.windows_bitwise_equal(ja, jd), tinv.windows_bitwise_equal(ta, td))
    # a shape mismatch
    te = dataclasses.replace(tb, score_counts=torch.zeros(9))
    je = jb._replace(score_counts=np.zeros(9, np.float32))
    _same(jinv.windows_bitwise_equal(ja, je), tinv.windows_bitwise_equal(ta, te))


@pytest.mark.parametrize("series", [
    (False, True, False, False),  # fires for one sample, clears: a flap
    (False, True, True, True),  # fires and holds to the end: not a flap
    (True, True, True, False, True, False, True, True, True, True),
    (),
])
def test_alert_flap_detector_equals_jax(series):
    jd, td = jinv.AlertFlapDetector(min_hold_samples=3), tinv.AlertFlapDetector(3)
    for v in series:
        jd.sample(drift=v, other=not v)
        td.sample(drift=v, other=not v)
    assert jd.episodes("drift") == td.episodes("drift")
    _same(jd.check(), td.check())


class _Registry:
    def __init__(self, prod, shadow, latest):
        self.aliases = {"prod": prod, "shadow": shadow}
        self.latest = latest

    def get_version_by_alias(self, name, alias):
        return self.aliases.get(alias)

    def latest_version(self, name):
        return self.latest


class _Store:
    def __init__(self, state):
        self.state = state

    def get_state(self, name):
        return {"state": self.state}


@pytest.mark.parametrize("state,prod,shadow,latest,delta", [
    ("done", 2, None, 2, 1.0),
    ("promoting", 1, 2, 3, 2.0),
    ("done", 2, None, 2, 0.0),
])
def test_exactly_once_promotion_equals_jax(state, prod, shadow, latest, delta):
    args = (_Registry(prod, shadow, latest), _Store(state), "fraud")
    kw = dict(challenger_version=2, versions_before=2, promotions_delta=delta)
    _same(jinv.exactly_once_promotion(*args, **kw), tinv.exactly_once_promotion(*args, **kw))


def test_scenario_result_serializes_and_raises_as_jax():
    def build(mod):
        r = mod.ScenarioResult("s")
        r.add(mod.InvariantOutcome("a", np.bool_(True), "fine"))
        r.add(mod.InvariantOutcome("b", False, "broken"))
        r.metrics = {"n": np.int64(3), "x": np.float32(0.5), "l": [np.int32(1)],
                     "d": {"k": np.bool_(False)}}
        return r

    j, t = build(jinv), build(tinv)
    assert j.to_dict() == t.to_dict() and not t.ok
    with pytest.raises(AssertionError) as ej:
        j.raise_if_failed()
    with pytest.raises(AssertionError) as et:
        t.raise_if_failed()
    assert str(ej.value) == str(et.value)
