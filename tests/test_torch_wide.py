"""The wide family (hashed entity crosses) on the port against the JAX
package's ``ops/crosses``, ``mesh/retrain.wide_sgd_fit``,
wide scorer, single-device wide flush, micro-batcher, ``train(wide=
True)`` and app, at a small size (a 1024-bucket table, a few hundred rows a
batch), on the CPU.

Exact across the packages: the cross indices (bit for bit on every random
and adversarial row; at the amount bucket's exact boundaries only where the
last ulp of ``log1p`` differs, counted), the fingerprints, the widened
blocks and scalers, the ``wide_params.npz`` interchange, the reason-code
indices and the drift window's whole counts. Within a stated tolerance: the
fit (1e-5, the tolerance JAX's own model-axis test holds), the scores
(1e-6 in the flush, 1e-5 through the apps) and a training run (the scalers'
last bits differ, ROADMAP queue 3)."""

import asyncio
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.data.synthetic import generate_synthetic_data
from fraud_detection_tpu.mesh.retrain import wide_sgd_fit as jax_fit
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile as jax_profile
from fraud_detection_tpu.monitor.drift import DriftMonitor as JaxDrift
from fraud_detection_tpu.monitor.watchtower import Thresholds as JaxThresholds
from fraud_detection_tpu.monitor.watchtower import Watchtower as JaxWatchtower
from fraud_detection_tpu.ops.crosses import CrossSpec as JaxSpec
from fraud_detection_tpu.ops.crosses import cross_indices as jax_cross_indices
from fraud_detection_tpu.ops.crosses import entity_fingerprints as jax_fingerprints
from fraud_detection_tpu.ops.crosses import load_wide as jax_load_wide
from fraud_detection_tpu.ops.crosses import save_wide as jax_save_wide
from fraud_detection_tpu.ops.crosses import widen_scaler as jax_widen_scaler
from fraud_detection_tpu.ops.crosses import widen_with_crosses as jax_widen
from fraud_detection_tpu.ops.logistic import LogisticParams as JaxParams
from fraud_detection_tpu.ops.scaler import ScalerParams as JaxScaler
from fraud_detection_tpu.ops.scorer import WideBatchScorer as JaxWideScorer
from fraud_detection_tpu.ops.scorer import _bucket as jax_bucket
from fraud_detection_tpu.parallel.mesh import MeshSpec, create_mesh
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.binlane import _FrameDecoder as JaxDecoder
from fraud_detection_tpu.service.http import Request as JaxRequest
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.train import train as jax_train
from fraud_detection_tpu_torch import convert
from fraud_detection_tpu_torch.ledger.state import entity_fingerprint
from fraud_detection_tpu_torch.mesh.retrain import wide_sgd_fit
from fraud_detection_tpu_torch.models import FraudLogisticModel, load_any_model
from fraud_detection_tpu_torch.monitor.baseline import load_profile
from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
from fraud_detection_tpu_torch.monitor.watchtower import Thresholds, Watchtower
from fraud_detection_tpu_torch.ops.crosses import (
    CROSS_NAMES,
    CrossSpec,
    cross_indices,
    entity_fingerprints,
    load_wide,
    save_wide,
    widen_scaler,
    widen_with_crosses,
)
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scorer import BatchScorer, _bucket
from fraud_detection_tpu_torch.service import binlane, metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import Request, TestClient
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher
from fraud_detection_tpu_torch.service.worker import XaiWorker
from fraud_detection_tpu_torch.train import train

torch.set_num_threads(1)

D = 30
C = 4
K = 3
LOG2B = 10
SPEC = CrossSpec(n_base=D, log2_buckets=LOG2B, amount_col=D - 1, time_col=0)
JSPEC = JaxSpec(n_base=D, log2_buckets=LOG2B, amount_col=D - 1, time_col=0)
KAGGLE = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
#: the fit against JAX's 1×1 mesh (JAX's own model-axis test holds 1e-5)
FIT_ATOL = 1e-5
#: scores of one flush across the packages
FLUSH_ATOL = 1e-6
#: scores through the two apps
SCORE_ATOL = 1e-5
NEVER = Thresholds(5.0, 5.0, 5.0, 1.0, 10**9)


def _data(n=2048, seed=21):
    """``test_broadside.py``'s fixture shape: Time × 40,000, Amount × 150."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) * 40_000
    x[:, -1] = np.abs(x[:, -1]) * 150
    return x


def _fps(n, seed=22):
    rng = np.random.default_rng(seed)
    f = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    f[:16] = 0  # a null-entity prefix
    return f


def _table(buckets=1 << LOG2B, seed=23):
    return (np.random.default_rng(seed).standard_normal(buckets) * 0.2).astype(np.float32)


def _params(seed=24):
    rng = np.random.default_rng(seed)
    coef = np.concatenate([rng.standard_normal(D).astype(np.float32) * 0.3, np.ones(C, np.float32)])
    return coef, np.float32(-1.0)


def _scaler(x):
    """A realistic scaler (so the int8 lattice covers the data), widened."""
    mean = x.mean(0).astype(np.float32)
    scale = (x.std(0) + 1e-6).astype(np.float32)
    return JaxScaler(mean=mean, scale=scale, var=scale**2, n_samples=np.float32(len(x)))


def _scorers(wire="float32", x=None):
    """The JAX and the port's wide scorer over the same params, scaler and
    table."""
    x = _data() if x is None else x
    coef, b = _params()
    js = jax_widen_scaler(_scaler(x), C)
    table = _table()
    jsc = JaxWideScorer(JaxParams(coef=coef, intercept=b), js, JSPEC, table, io_dtype=wire)
    psc = BatchScorer(
        LogisticParams(torch.from_numpy(coef), torch.tensor(b)),
        convert.scaler_from_arrays({f: np.asarray(getattr(js, f)) for f in js._fields}),
        io_dtype=wire, device="cpu", wide_spec=SPEC, wide_table=table,
    )
    return jsc, psc


# ---------------------------------------------------------------------------
# the hash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_cross", [1, 2, 3, 4])
@pytest.mark.parametrize("log2_buckets", [10, 14, 20])
def test_cross_indices_equal_jax(log2_buckets, n_cross):
    """Bitwise on 4,096 random rows of the fixture shape (fingerprints
    0 included)."""
    x, f = _data(4096), _fps(4096)
    got = cross_indices(x, f, CrossSpec(D, log2_buckets, D - 1, 0, n_cross), device="cpu")
    want = jax_cross_indices(x, f, JaxSpec(D, log2_buckets, D - 1, 0, n_cross))
    assert got.dtype == want.dtype == np.int32 and got.shape == (4096, n_cross)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 1 << log2_buckets


@pytest.mark.parametrize("log2_buckets", [10, 14, 20])
def test_adversarial_cross_indices_equal_jax(log2_buckets):
    """Bitwise on near-collisions: sequential fingerprints on identical
    rows, the 32 single-bit neighbours of one key, zero amounts, negative
    and huge times, huge and infinite amounts, all-negative and
    all-positive sign patterns."""
    seq = np.arange(1, 1025, dtype=np.uint32)
    x = np.zeros((1024, D), np.float32)
    x[:, -1] = 42.0
    base = np.uint32(0xDEADBEEF)
    flips = np.concatenate([[base], [base ^ np.uint32(1 << b) for b in range(32)]]).astype(np.uint32)
    odd = np.zeros((12, D), np.float32)
    odd[1, 0] = -5000.0
    odd[2, 0] = 3e38
    odd[3, -1] = 1e30
    odd[4, -1] = np.inf
    odd[5, -1] = -77.5
    odd[6, 1:-1] = -1.0
    odd[7, 1:-1] = 1.0
    odd[8, 1:-1] = 1.0
    odd[8, 0] = 86_399.0
    odd[9, 0] = 86_400.0
    odd[10, 1:-1] = -0.0
    odd[11, 0] = -np.inf
    odd_fps = np.full(12, 0xFFFFFFFF, np.uint32)
    ps, js = CrossSpec(D, log2_buckets, D - 1), JaxSpec(D, log2_buckets, D - 1)
    for rows, f in ((x, seq), (np.zeros((33, D), np.float32), flips), (odd, odd_fps)):
        np.testing.assert_array_equal(cross_indices(rows, f, ps, device="cpu"),
                                      jax_cross_indices(rows, f, js))
    idx = cross_indices(x, seq, ps, device="cpu")
    for c in range(C):  # identical rows, sequential keys: the buckets spread
        assert len(np.unique(idx[:, c])) / 1024 > 0.5


def _boundary_probes():
    """The 765 float32 neighbours of the amount bucket's boundaries
    ``expm1(k/8)``, k = 1..255: below, at and above each."""
    v = np.expm1(np.arange(1, 256) / 8.0).astype(np.float32)
    a = np.concatenate([np.nextafter(v, np.float32(0)), v, np.nextafter(v, np.float32(np.inf))])
    x = np.zeros((a.shape[0], D), np.float32)
    x[:, -1] = a
    return x


def test_boundary_probes_differ_only_at_log1p_last_ulp():
    """At the amount bucket's exact boundaries the last ulp of float32
    ``log1p`` differs between XLA's CPU and PyTorch's, and with it the
    bucket: every row whose indices differ must be such a case, one whose
    float64 ``log1p(|a|)·8`` lies within 2 float32 ulps of an integer. The
    count stands in ROADMAP queue 3."""
    x = _boundary_probes()
    f = np.full(x.shape[0], 12345, np.uint32)
    got = cross_indices(x, f, SPEC, device="cpu")
    want = jax_cross_indices(x, f, JSPEC)
    differ = (got != want).any(axis=1)
    v = np.log1p(np.abs(x[:, -1].astype(np.float64))) * 8.0
    near = np.abs(v - np.rint(v)) <= 2.0 * np.spacing(np.abs(v).astype(np.float32))
    assert not (differ & ~near).any(), np.flatnonzero(differ & ~near)
    assert near.sum() >= differ.sum() and differ.sum() <= 32, int(differ.sum())
    # the amount bucket is the only field that moved: the sign and hour
    # columns (template 2) agree on every probe
    np.testing.assert_array_equal(got[:, 2], want[:, 2])


def test_fingerprints_widening_and_scaler_equal_jax():
    ents = ["card-1", None, 7, "ü-ñ", "", None, "card-1"]
    np.testing.assert_array_equal(entity_fingerprints(ents, 9), jax_fingerprints(ents, 9))
    assert entity_fingerprints(ents, 9).dtype == np.uint32
    x, f, t = _data(512), _fps(512), _table()
    got, want = widen_with_crosses(x, f, t, SPEC, device="cpu"), jax_widen(x, f, t, JSPEC)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert not got[:16, D:].any() and got[16:, D:].any()  # null rows: a zero block
    js = _scaler(x)
    ws = widen_scaler(convert.scaler_from_arrays({k: np.asarray(getattr(js, k)) for k in js._fields}), C)
    jw = jax_widen_scaler(js, C)
    for k in ("mean", "scale", "var"):
        assert getattr(ws, k).numpy().tobytes() == np.asarray(getattr(jw, k), np.float32).tobytes()
    assert widen_scaler(None, C) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wide_npz_interchange(tmp_path, writer):
    """``wide_params.npz`` written by either package reads back in both, and
    a table stamped under another hash version raises in both."""
    table = _table()
    d = str(tmp_path)
    (jax_save_wide if writer == "jax" else save_wide)(d, JSPEC if writer == "jax" else SPEC, table)
    (ps, pt), (js, jt) = load_wide(d), jax_load_wide(d)
    assert tuple(ps) == tuple(js) == tuple(SPEC)
    assert pt.tobytes() == jt.tobytes() == table.tobytes()
    with np.load(os.path.join(d, "wide_params.npz")) as z:
        keys = {k: z[k] for k in z.files}
    keys["hash_version"] = np.int64(2)
    np.savez(os.path.join(d, "wide_params.npz"), **keys)
    for load in (load_wide, jax_load_wide):
        with pytest.raises(ValueError, match="hash_version"):
            load(d)
    with pytest.raises(ValueError, match="hash_version"):
        convert.wide_logistic_from_arrays({"coef": np.zeros(D + C), "intercept": 0.0},
                                          KAGGLE + list(CROSS_NAMES), keys)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def _fit_inputs(n=3000, seed=31):
    """Entities with a characteristic amount, so that their crosses recur;
    the labels carry planted cross signal. Returns scaled rows, indices,
    has-entity, labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    ent = rng.integers(0, 300, n)
    fps = (ent + 1).astype(np.uint32)
    x[:, -1] = (np.abs(rng.standard_normal(300)) * 200).astype(np.float32)[ent]
    idx = jax_cross_indices(x, fps, JSPEC)
    has = np.ones(n, np.float32)
    has[::7] = 0.0
    sig = (rng.random(JSPEC.buckets) < 0.1).astype(np.float32) * 4.0
    z = x[:, :D - 1] @ (rng.standard_normal(D - 1).astype(np.float32) * 0.2) + sig[idx[:, 0]] - 2.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.int64)
    xs = ((x - x.mean(0)) / (x.std(0) + 1e-6)).astype(np.float32)
    return xs, idx, has, y


@pytest.mark.parametrize("warm", [False, True])
def test_wide_sgd_fit_matches_jax_one_by_one(warm):
    """The port's fit against JAX's on a 1×1 mesh, cold and warm-started
    from a base coef and table: coef, intercept and table within 1e-5."""
    xs, idx, has, y = _fit_inputs()
    kw = dict(epochs=6, batch_size=512, lr=1.0, seed=1, class_weight="balanced")
    warm_start = None
    if warm:
        rng = np.random.default_rng(33)
        coef0 = rng.standard_normal(D).astype(np.float32) * 0.1
        table0 = (rng.standard_normal(JSPEC.buckets) * 0.3).astype(np.float32)
        warm_start = (JaxParams(coef=coef0, intercept=np.float32(-0.5)), table0)
        kw.update(epochs=2, lr=0.05)
    mesh = create_mesh(MeshSpec(data=1, model=1), jax.devices()[:1])
    jp, jt = jax_fit(xs, idx, has, y, JSPEC, mesh=mesh, warm_start=warm_start, **kw)
    pw = None
    if warm:
        pw = (LogisticParams(torch.from_numpy(warm_start[0].coef), torch.tensor(-0.5)),
              warm_start[1])
    pp, pt = wide_sgd_fit(xs, idx, has, y, SPEC, warm_start=pw, device="cpu", **kw)
    assert pp.coef.shape == (D + C,) and pt.shape == (JSPEC.buckets,)
    np.testing.assert_array_equal(pp.coef.numpy()[D:], np.ones(C, np.float32))
    np.testing.assert_allclose(pp.coef.numpy(), np.asarray(jp.coef), rtol=0, atol=FIT_ATOL)
    assert float(pp.intercept) == pytest.approx(float(jp.intercept), abs=FIT_ATOL)
    np.testing.assert_allclose(pt.numpy(), jt, rtol=0, atol=FIT_ATOL)
    assert np.abs(jt).max() > 0.1  # the table learned (or kept) real mass
    # two fits on one device are bitwise equal
    pp2, pt2 = wide_sgd_fit(xs, idx, has, y, SPEC, warm_start=pw, device="cpu", **kw)
    assert pt2.numpy().tobytes() == pt.numpy().tobytes()
    assert pp2.coef.numpy().tobytes() == pp.coef.numpy().tobytes()


# ---------------------------------------------------------------------------
# the scorer and the flush
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_wide_scorer_matches_jax(wire):
    """Base-width batches (the null fold) and pre-widened blocks score as
    JAX's scorer does on each wire, within 1e-6; the fused spec carries the
    same geometry and the int8 wire dequantizes in the flush."""
    x, f = _data(300), _fps(300)
    jsc, psc = _scorers(wire, _data())
    assert psc.staging_features == D and psc.n_features == D + C and psc.family == "wide"
    np.testing.assert_allclose(psc.predict_proba(x), np.asarray(jsc.predict_proba(x)),
                               rtol=0, atol=FLUSH_ATOL)
    xw = jax_widen(x, f, _table(), JSPEC)
    np.testing.assert_allclose(psc.predict_proba(xw), np.asarray(jsc.predict_proba(xw)),
                               rtol=0, atol=FLUSH_ATOL)
    spec = psc.fused_spec()
    assert tuple(spec.wide[0]) == tuple(jsc.fused_spec().wide[0])
    assert spec.wide[1].numpy().tobytes() == _table().tobytes()
    assert (spec.dequant_scale is not None) == (wire == "int8") and not spec.score_codes
    if wire == "int8":
        np.testing.assert_array_equal(psc._quant_scale, np.asarray(jsc._quant_scale))
    assert psc.table_occupancy() == jsc.table_occupancy(1)


def _port_profile(jprof):
    return convert.profile_from_arrays(dataclasses.asdict(jprof))


def _profile(jsc, x, f):
    xw = jax_widen(x, f, _table(), JSPEC)
    return jax_profile(xw, np.asarray(jsc.predict_proba(xw)),
                       feature_names=KAGGLE + list(CROSS_NAMES))


def _jax_flush(scorer, monitor, rows, fps, explain_k=0):
    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(jax_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_rows(slot, list(rows))
        slot.ensure_ledger()
        slot.lf[:] = 0
        slot.lh[:] = 0.0
        slot.lf[:n] = fps
        slot.lh[:n] = (fps != 0).astype(np.float32)
        out = monitor.fused_flush(
            jnp.asarray(hx), jnp.asarray(slot.valid), n, spec.score_args, spec.score_fn,
            dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
            explain_args=spec.explain_args if explain_k else None, explain_k=explain_k,
            wide_args=spec.wide, wide_rows=(jnp.asarray(slot.lf), jnp.asarray(slot.lh)),
        )
        outs = out if isinstance(out, tuple) else (out,)
        return [np.asarray(o)[:n] for o in outs]
    finally:
        scorer.staging.release(slot)


def _items(rows, fps):
    return [(rows[i], None, None, (0, int(fps[i]), 0.0) if fps[i] else None)
            for i in range(len(rows))]


def _port_flush(scorer, monitor, rows, fps, explain_k=0):
    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        items = _items(rows, fps)
        hx = scorer.stage_items(slot, items)
        wide_rows = MicroBatcher._stage_wide(scorer, slot, items)
        out = monitor.fused_flush(
            scorer.to_device(hx), scorer.to_device(slot.valid), n, spec.score_args,
            spec.score_fn, dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
            explain_args=spec.explain_args if explain_k else None, explain_k=explain_k,
            wide_args=spec.wide, wide_rows=wide_rows,
        )
        outs = out if isinstance(out, tuple) else (out,)
        return [o.numpy()[:n] for o in outs]
    finally:
        scorer.staging.release(slot)


@pytest.mark.parametrize("explain_k", [0, K])
@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_fused_flush_wide_matches_jax(wire, explain_k):
    """Three flushes (64, 200 and 8 rows; fingerprint 0 on some) through the
    port's wide flush and JAX's single-device one: scores within 1e-6,
    reason indices equal, the window's whole counts equal at an infinite
    half-life."""
    x, f = _data(), _fps(2048)
    jsc, psc = _scorers(wire, x)
    jprof = _profile(jsc, x, f)
    jd = JaxDrift(jprof, halflife_rows=float("inf"))
    pd = DriftMonitor(_port_profile(jprof), halflife_rows=float("inf"), device="cpu")
    off = 0
    cross_led = False
    for n in (64, 200, 8):
        rows, fps = x[100 + off:100 + off + n], f[off:off + n].copy()
        off += n
        want = _jax_flush(jsc, jd, rows, fps, explain_k)
        got = _port_flush(psc, pd, rows, fps, explain_k)
        np.testing.assert_allclose(got[0], want[0].astype(np.float32), rtol=0, atol=FLUSH_ATOL)
        if explain_k:
            np.testing.assert_array_equal(got[1].astype(np.int64), want[1].astype(np.int64))
            np.testing.assert_allclose(got[2], want[2].astype(np.float32), rtol=0, atol=FLUSH_ATOL)
            cross_led |= bool((got[1] >= D).any())
    assert cross_led or not explain_k  # a cross column leads some rows
    np.testing.assert_array_equal(pd.window.feature_counts.numpy(), np.asarray(jd.window.feature_counts))
    np.testing.assert_array_equal(pd.window.score_counts.numpy(), np.asarray(jd.window.score_counts))
    assert float(pd.window.n_rows) == float(jd.window.n_rows) == 272.0


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_null_rows_score_base_only_and_warmup_leaves_the_window(wire):
    """Entity-less rows zero the whole wide block: their flush scores are
    the base-only null fold's, bitwise on the f32 wire and within 1e-6 on
    int8 (the flush scores ``(codes·s)·w``, the null fold ``codes·(s·w)``);
    an all-padding ``warm_fused`` on every bucket (explain on) leaves the
    window bitwise unchanged."""
    x, f = _data(), _fps(2048)
    jsc, psc = _scorers(wire, x)
    pd = DriftMonitor(_port_profile(_profile(jsc, x, f)), device="cpu")
    _port_flush(psc, pd, x[:40], f[:40])  # a non-empty window first
    scores, = _port_flush(psc, pd, x[:64], np.zeros(64, np.uint32))
    if wire == "float32":
        assert scores.tobytes() == psc.predict_proba(x[:64]).tobytes()
    np.testing.assert_allclose(scores, psc.predict_proba(x[:64]), rtol=0, atol=FLUSH_ATOL)
    before = [t.clone() for t in pd.window.tensors()]
    for b in (8, 16, 32, 64, 128):
        pd.warm_fused(psc, b, explain_k=K)
    for a, b in zip(before, pd.window.tensors()):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_base_width_feedback_into_a_wide_window_is_dropped_as_in_jax():
    """A wide window spans the cross columns, so base-width rows (feedback,
    the split path) cannot fold into it: both packages' watchtowers log
    the failed ingest and leave the window as it was. Widened rows fold in
    both, with equal whole counts at an infinite half-life (ROADMAP queue
    3)."""
    x, f = _data(), _fps(2048)
    jsc, psc = _scorers("float32", x)
    jprof = _profile(jsc, x, f)
    xw = jax_widen(x[:40], f[:40], _table(), JSPEC)
    jwt = JaxWatchtower(jprof, thresholds=JaxThresholds(5.0, 5.0, 5.0, 1.0, 10**9),
                        halflife_rows=float("inf"))
    pwt = Watchtower(_port_profile(jprof), thresholds=NEVER, halflife_rows=float("inf"),
                     device="cpu")
    try:
        for wt in (jwt, pwt):
            wt.observe(x[:50], psc.predict_proba(x[:50]), labels=np.ones(50),
                       calibration_only=True)
            wt.observe(x[:20], psc.predict_proba(x[:20]))
            assert wt.drain()
            st = wt.drift.stats()
            assert st["n_labeled"] == 0.0 and st["window_rows"] == 0.0
            wt.observe(xw, psc.predict_proba(xw), labels=np.ones(40))
            assert wt.drain()
        js, ps = jwt.drift.stats(), pwt.drift.stats()
        assert ps["n_labeled"] == js["n_labeled"] == 40.0
        assert ps["window_rows"] == js["window_rows"] == 40.0
        np.testing.assert_array_equal(pwt.drift.window.feature_counts.numpy(),
                                      np.asarray(jwt.drift.window.feature_counts))
    finally:
        jwt.close()
        pwt.close()


# ---------------------------------------------------------------------------
# the micro-batcher
# ---------------------------------------------------------------------------


def test_microbatcher_wide_single_dispatch_and_gauge():
    """A wide model behind the micro-batcher: one device call a flush, the
    scores of ``widen_with_crosses`` rows within 1e-6, reason codes on
    every row, and ``scorer_wide_fused`` 1 with one model shard and the
    table's occupancy exported."""
    x, f = _data(), _fps(2048)
    jsc, psc = _scorers("float32", x)
    wt = Watchtower(_port_profile(_profile(jsc, x, f)), thresholds=NEVER, device="cpu")
    fps = np.where(f[:48] == 0, 1, f[:48]).astype(np.uint32)

    async def run():
        mb = MicroBatcher(psc, max_batch=64, max_wait_ms=1.0, watchtower=wt,
                          telemetry=False, fused=True, explain=True, explain_k=K)
        await mb.start()
        try:
            return await asyncio.gather(*(mb.score_ex(x[i], entity=(0, int(fps[i]), 0.0))
                                          for i in range(48)))
        finally:
            await mb.stop()

    try:
        out = asyncio.run(run())
    finally:
        wt.drain()
        wt.close()
    expect = psc.predict_proba(widen_with_crosses(x[:48], fps, _table(), SPEC, device="cpu"))
    for i, (score, reasons) in enumerate(out):
        assert score == pytest.approx(float(expect[i]), abs=FLUSH_ATOL)
        assert reasons is not None and len(reasons[0]) == K
    assert metrics.scorer_device_calls_per_flush.get("0") == 1
    assert metrics.scorer_wide_fused.get() == 1
    assert metrics.scorer_served_family.get("wide") == 1
    assert metrics.wide_model_shards.get() == 1
    assert metrics.wide_bucket_occupancy.get("0") > 0.9


def test_wide_demotion_gauge_latches_without_fused_target():
    """Without a fused target (no watchtower) a wide model drops its
    crosses: ``scorer_wide_fused`` latches 0. A later flush of a narrow
    scorer un-latches it and drops the occupancy series."""
    x = _data()
    _, psc = _scorers("float32", x)

    async def run(scorer, n):
        mb = MicroBatcher(scorer, max_batch=32, max_wait_ms=1.0, watchtower=None,
                          telemetry=False, fused=True)
        await mb.start()
        try:
            return await asyncio.gather(*(mb.score(x[i]) for i in range(n)))
        finally:
            await mb.stop()

    out = asyncio.run(run(psc, 8))
    np.testing.assert_allclose(out, psc.predict_proba(x[:8]), rtol=0, atol=0)
    assert metrics.scorer_wide_fused.get() == 0
    metrics.wide_bucket_occupancy.labels("0").set(0.5)
    rng = np.random.default_rng(25)
    narrow = BatchScorer(LogisticParams(torch.from_numpy(rng.standard_normal(D).astype(np.float32)),
                                        torch.tensor(-1.0)), device="cpu")
    assert len(asyncio.run(run(narrow, 4))) == 4
    assert metrics.scorer_wide_fused.get() == 1
    assert metrics.wide_model_shards.get() == 0
    assert "wide_bucket_occupancy{" not in "\n".join(metrics.wide_bucket_occupancy.render())


def test_frame_entity_columns_of_a_wide_model_equal_jax():
    """The binary lane's decoder carries a wide model's fingerprints, with
    the slot and time columns zero, as the JAX decoder does."""
    jsc, psc = _scorers("float32")
    n = 100
    fps = np.random.default_rng(9).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    fps[::7] = 0
    ent = fps.astype("<u4").tobytes()
    got = binlane._FrameDecoder(psc, n, None).entity_cols(n, ent, None)
    want = JaxDecoder(jsc, n, None).entity_cols(n, ent, None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64))
    assert not got[0].any() and not got[2].any()


# ---------------------------------------------------------------------------
# training and serving a trained directory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One synthetic CSV (3,000 rows, the Kaggle schema), trained with
    ``WIDE_BUCKETS=1024`` by JAX's ``train(wide=True)`` on a 1×8 mesh
    (``MESH_MODEL_DEVICES=8``: the model-axis-invariant form of the 1×1
    fit) and by the port's on the CPU, unregistered."""
    root = tmp_path_factory.mktemp("wide_train")
    csv = str(root / "synth.csv")
    generate_synthetic_data(csv, n_samples=3000, fraud_ratio=0.03, seed=0, shift_scale=0.35)
    out = {"csv": csv}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WIDE_BUCKETS", "1024")
        mp.setenv("MESH_MODEL_DEVICES", "8")
        for name, fn, kw in (("jax", jax_train, {}), ("port", train, {"device": "cpu"})):
            mp.setenv("MLFLOW_TRACKING_URI", f"file:{root}/{name}/mlruns")
            d = str(root / name / "models")
            out[name] = (fn(data_csv=csv, register=False, out_dir=d, wide=True, **kw), d)
    return out


def test_train_wide_matches_jax_train(trained):
    """Equal names, geometry and skipped CV; the table, the coef and the
    intercept within 1e-5 and test AUC within 1e-5 (the scalers differ in
    the last bits, so the fits start a few ulps apart: measured 3e-8 on the
    table, 2.4e-7 on the coef, equal AUCs); the baseline covers the widened
    block."""
    (got, pdir), (want, jdir) = trained["port"], trained["jax"]
    pm, jm = FraudLogisticModel.load(pdir, device="cpu"), JaxModel.load(jdir)
    assert pm.feature_names == jm.feature_names == KAGGLE + list(CROSS_NAMES)
    assert tuple(pm.wide_spec) == tuple(jm.wide_spec) == (D, LOG2B, D - 1, 0, C)
    assert "cv_auc_mean" not in got and "cv_auc_mean" not in want
    np.testing.assert_allclose(pm.wide_table, jm.wide_table, rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(pm.params.coef.numpy(), np.asarray(jm.params.coef),
                               rtol=0, atol=FIT_ATOL)
    assert float(pm.params.intercept) == pytest.approx(float(jm.params.intercept), abs=FIT_ATOL)
    assert abs(got["test_auc"] - want["test_auc"]) <= 1e-5
    assert got["stages"]["final_fit"] > 0 and got["stages"]["wide_hash"] > 0
    assert load_profile(pdir).n_features == D + C
    assert load_any_model(jdir, device="cpu").scorer.family == "wide"


def _post_raw(client, request_cls, path, body):
    req = request_cls("POST", path, {"content-type": "application/x-fraud-frame"}, body)

    async def go():
        await client.app.startup()
        return await client.app.dispatch(req)

    return client.loop.run_until_complete(go())


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_two_apps_serve_a_jax_trained_wide_directory(trained, tmp_path, monkeypatch, wire):
    """The JAX app and the port's app on one JAX-trained wide directory,
    explain on: ``/predict`` with ``entity_id`` over a few entities and
    without, then one ``/ingest/batch`` frame with fingerprints (some 0):
    scores within 1e-5, the same reason-code features but across a 1e-5
    tie; two rows alike but for the entity score differently, and an
    entity-less row scores base-only; ``scorer_wide_fused`` 1."""
    _, jdir = trained["jax"]
    monkeypatch.setenv("MODEL_PATH", os.path.join(jdir, "logistic_model.joblib"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("SCORER_MAX_BATCH", "64")
    monkeypatch.setenv("SCORER_WIRE", wire)
    monkeypatch.setenv("DEVICE", "cpu")
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, max_rows=40, dtype=np.float32)[:, :D]
    urls = {name: dict(database_url=f"sqlite:///{tmp_path}/{name}_fraud.db",
                       broker_url=f"sqlite:///{tmp_path}/{name}_taskq.db")
            for name in ("jax", "port")}
    with JaxClient(jax_create_app(**urls["jax"])) as jc, \
            TestClient(create_app(**urls["port"])) as tc:
        port_scores = {}
        for i in range(x.shape[0]):
            body = {"features": x[i].tolist()}
            if i % 4:
                body["entity_id"] = f"card-{i % 5}"
            jb, tb = jc.post("/predict", json=body).json(), tc.post("/predict", json=body).json()
            assert tb["score"] == pytest.approx(jb["score"], abs=SCORE_ATOL)
            port_scores[i] = tb["score"]
            jv = [r["attribution"] for r in jb["reason_codes"]]
            tv = [r["attribution"] for r in tb["reason_codes"]]
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
            if [r["feature"] for r in tb["reason_codes"]] != [r["feature"] for r in jb["reason_codes"]]:
                assert min(abs(a - b) for a, b in zip(jv[1:], jv[:-1])) <= 1e-5
        assert tc.app.state["model"].scorer.family == "wide"
        other = tc.post("/predict", json={"features": x[1].tolist(), "entity_id": "card-9"}).json()
        assert other["score"] != port_scores[1]  # the crosses moved it
        null = tc.app.state["model"].scorer.predict_proba(x[:1])[0]
        assert port_scores[0] == pytest.approx(float(null), abs=1e-7)
        fps = np.asarray([entity_fingerprint(f"card-{i % 3}") if i % 5 else 0
                          for i in range(16)], np.uint32)
        body = binlane.encode_frame(x[:16], fps, None, length_prefix=False)
        got = []
        for client, request_cls in ((jc, JaxRequest), (tc, Request)):
            r = _post_raw(client, request_cls, "/ingest/batch", body)
            assert r.status_code == 200, r.body
            got.append(binlane.decode_response_body(r.body)[0])
        np.testing.assert_allclose(got[1], got[0], rtol=0, atol=SCORE_ATOL)
        text = tc.get("/metrics").text
    assert "scorer_wide_fused 1.0" in text and "wide_model_shards 1.0" in text


def test_worker_checks_the_base_columns_of_a_wide_model(trained):
    """The worker's backfill explains base rows through the null path, so
    its consistency check compares the base schema's indices only: a
    cross column in the serve top-k with a live value passes; a wrong base
    value fails."""
    _, jdir = trained["jax"]
    pm = FraudLogisticModel.load(jdir, device="cpu")
    worker = XaiWorker.__new__(XaiWorker)
    worker.model = pm
    phi, _ = pm.explain_one(np.ones(D, np.float32))
    assert phi.shape == (D + C,) and not phi[D:].any()
    base = np.argsort(-phi[:D])[:2]
    good = {"indices": [D + 1, *base.tolist()], "values": [9.0, *phi[base].tolist()]}
    assert worker._check_explain_consistency(phi, good, "c", "t")
    bad = {"indices": base.tolist(), "values": [phi[base[0]] + 1.0, phi[base[1]]]}
    before = metrics.xai_explain_consistency_failures.get()
    assert not worker._check_explain_consistency(phi, bad, "c", "t")
    assert metrics.xai_explain_consistency_failures.get() == before + 1


def test_convert_carries_a_jax_wide_model(trained):
    """``convert.wide_logistic_from_arrays`` builds the port's wide model
    from a JAX model's widened params and table: widened rows and base rows
    score as JAX's within 1e-6, and the save stamps the same sidecar."""
    _, jdir = trained["jax"]
    jm = JaxModel.load(jdir)
    arrays = {"coef": np.asarray(jm.params.coef), "intercept": np.asarray(jm.params.intercept),
              **{k: np.asarray(getattr(jm.scaler, k)) for k in jm.scaler._fields}}
    wide = {**{k: getattr(jm.wide_spec, k) for k in jm.wide_spec._fields},
            "table": jm.wide_table, "hash_version": 1}
    pm = convert.wide_logistic_from_arrays(arrays, jm.feature_names, wide, device="cpu")
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, max_rows=64, dtype=np.float32)[:, :D]
    xw = jax_widen(x, np.arange(1, 65, dtype=np.uint32), jm.wide_table, jm.wide_spec)
    for rows in (x, xw):
        np.testing.assert_allclose(pm.scorer.predict_proba(rows),
                                   np.asarray(jm.scorer.predict_proba(rows)), rtol=0, atol=1e-6)
