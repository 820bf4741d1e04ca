"""The quantized h2d wires (``SCORER_WIRE=bfloat16|int8``) of both model
families, the port against the JAX package on the CPU: the wire encode
bitwise, the fused flushes (with and without the explain leg) against
JAX's single-device ``DriftMonitor.fused_flush``, each family's int8 fused
flush bitwise its own split path, the warm-up, the drift windows across
wires, the streaming scorer, the loud f32 fallback, the stamped
calibration and, through the port's app and worker, ``/predict`` with
reason codes and the worker's consistency check.

JAX runs as its own tests run it on the CPU: its default branch, no
``USE_PALLAS``."""

import asyncio
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fraud_detection_tpu.monitor.baseline import build_baseline_profile as jax_build_profile
from fraud_detection_tpu.monitor.drift import DriftMonitor as JaxDrift
from fraud_detection_tpu.ops.gbt import GBTConfig, gbt_fit
from fraud_detection_tpu.ops.logistic import LogisticParams as JaxParams
from fraud_detection_tpu.ops.quant import derive_calibration as jax_derive
from fraud_detection_tpu.ops.scaler import ScalerParams as JaxScalerParams
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu.ops.scorer import BatchScorer as JaxBatchScorer
from fraud_detection_tpu.ops.scorer import GBTBatchScorer as JaxGBTScorer
from fraud_detection_tpu.ops.tree_shap import build_tree_explainer as jax_tree_explainer
from fraud_detection_tpu.ops.tree_shap import tree_shap as jax_tree_shap
from fraud_detection_tpu_torch.convert import (
    calibration_from_arrays,
    gbt_from_arrays,
    params_from_jax_arrays,
    profile_from_arrays,
    scaler_from_arrays,
    tree_explainer_from_arrays,
)
from fraud_detection_tpu_torch.monitor.drift import DriftMonitor, psi_from_counts
from fraud_detection_tpu_torch.ops import quant
from fraud_detection_tpu_torch.ops.scorer import (
    BatchScorer,
    GBTBatchScorer,
    _bucket,
    decode_scores_into,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 30
K = 3
NAMES = [f"f{i}" for i in range(D)]
WIRES = ("float32", "bfloat16", "int8")
#: a reason-code row may differ from JAX's only across a k-th/(k+1)-th tie
SHAP_TIE = 2e-5
#: the port's TreeSHAP against JAX's (tests/test_torch_tree_shap.py)
PHI_RTOL, PHI_ATOL = 1e-4, 2e-5
#: JAX's gates of the int8 wire against f32 (tests/test_quickwire.py)
QUANT_ATOL, QUANT_MEAN_TOL = 5e-2, 1e-2
SCORE_PSI_EPS, FEATURE_PSI_EPS = 0.02, 0.1


def _clean_rows() -> np.ndarray:
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4096, D)) * 2.0 + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    """Rows as JAX's quickwire tests draw them, with outliers past the
    8-sigma lattice of their scaler (fitted on the rows without them) in
    rows 5 and 700, so the encoder's clip is exercised."""
    x = _clean_rows()
    x[5, :4] = [1e3, -1e3, 55.0, -55.0]
    x[700, 10] = 3e4
    return x


@pytest.fixture(scope="module")
def jax_scaler():
    return jax_scaler_fit(_clean_rows())


def _jax_params():
    rng = np.random.default_rng(0)
    return JaxParams(coef=rng.standard_normal(D).astype(np.float32) * 0.3,
                     intercept=np.float32(-1.0))


def _np_fields(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def linear(jax_scaler):
    """(JAX scorer factory, port scorer factory) over the same weights."""
    jp = _jax_params()
    tp = params_from_jax_arrays(_np_fields(jp))
    ts = scaler_from_arrays(_np_fields(jax_scaler))

    def jax_make(wire):
        return JaxBatchScorer(jp, jax_scaler, io_dtype=wire)

    def port_make(wire):
        return BatchScorer(tp, ts, io_dtype=wire, device="cpu")

    return jax_make, port_make


@pytest.fixture(scope="module")
def forest(data, jax_scaler):
    """A small fitted forest, as tests/test_evergreen.py builds one (on raw
    rows), its explainer and the stamped calibration of its scaler."""
    rng = np.random.default_rng(13)
    w = rng.standard_normal(D).astype(np.float32)
    y = (rng.random(len(data)) < 1.0 / (1.0 + np.exp(-(data @ w - 2.0)))).astype(np.float32)
    jf = gbt_fit(data[:2048], y[:2048], GBTConfig(n_trees=16, max_depth=3, n_bins=32))
    jexpl = jax_tree_explainer(jf, data[:64])
    jcal = jax_derive(jax_scaler)
    tf = gbt_from_arrays(_np_fields(jf))
    texpl = tree_explainer_from_arrays(tf, np.asarray(jexpl.bg_table), np.asarray(jexpl.expected_value))
    tcal = calibration_from_arrays({"scale": jcal.scale, "sigma_range": jcal.sigma_range})

    def jax_make(wire):
        return JaxGBTScorer(jf, io_dtype=wire, calibration=jcal if wire == "int8" else None,
                            explainer=jexpl)

    def port_make(wire):
        return GBTBatchScorer(tf, io_dtype=wire, calibration=tcal if wire == "int8" else None,
                              explainer=texpl)

    return jax_make, port_make, jexpl


@pytest.fixture(scope="module")
def families(linear, forest):
    return {"linear": linear, "gbt": forest[:2]}


@pytest.fixture(scope="module")
def profiles(data, families):
    """Each family's baseline (JAX-built, f32 scores), JAX's and the
    port's copy."""
    out = {}
    for fam, (jax_make, _) in families.items():
        s = np.asarray(jax_make("float32").predict_proba(data)).reshape(-1)
        p = jax_build_profile(data, s, feature_names=NAMES)
        out[fam] = (p, profile_from_arrays(p.__dict__))
    return out


# -- the flush, staged as the micro-batcher stages it ------------------------


def _jax_flush(scorer, mon, rows, k=0, out_dtype=jnp.float32):
    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_rows(slot, list(rows))
        out = mon.fused_flush(
            jnp.asarray(hx), jnp.asarray(slot.valid), n, spec.score_args, spec.score_fn,
            dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
            out_dtype=out_dtype, explain_args=spec.explain_args if k else None, explain_k=k,
        )
        return tuple(np.asarray(o)[:n] for o in (out if isinstance(out, tuple) else (out,)))
    finally:
        scorer.staging.release(slot)


def _port_flush(scorer, mon, rows, k=0, out_dtype=torch.float32, score_args=None,
                score_codes=None):
    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, [(r,) for r in rows])
        out = mon.fused_flush(
            scorer.to_device(hx), scorer.to_device(slot.valid), n,
            spec.score_args if score_args is None else score_args, spec.score_fn,
            dequant_scale=spec.dequant_scale,
            score_codes=spec.score_codes if score_codes is None else score_codes,
            out_dtype=out_dtype, explain_args=spec.explain_args if k else None, explain_k=k,
        )
        return tuple(o.numpy()[:n].copy() for o in (out if isinstance(out, tuple) else (out,)))
    finally:
        scorer.staging.release(slot)


def _xf(scorer, rows) -> np.ndarray:
    """The values the port's flush scored and binned: dequantized codes,
    bf16-rounded rows, or the rows."""
    hx = scorer._prepare_host(np.ascontiguousarray(rows, np.float32))
    if isinstance(hx, torch.Tensor):
        return hx.float().numpy()
    if hx.dtype == np.int8:
        return hx.astype(np.float32) * scorer._quant_scale
    return hx


def _full_phi(fam, scorer, xf, jexpl) -> np.ndarray:
    if fam == "linear":
        coef, mean = (t.numpy() for t in scorer.fused_spec().explain_args)
        return coef * (xf - mean)
    return np.asarray(jax_tree_shap(jexpl, xf))


# -- the wire encode ---------------------------------------------------------


def test_int8_codes_are_bitwise_jax(data, jax_scaler):
    """``_prepare_host`` and the staged ``_encode_slot`` give JAX's codes
    bit for bit: outliers clip to ±127, and a constant feature (σ = 0,
    mean 0) takes ``derive_calibration``'s 1e-12 floor."""
    mean = np.asarray(jax_scaler.mean).copy()
    scale = np.asarray(jax_scaler.scale).copy()
    mean[3], scale[3] = 0.0, 0.0
    jsp = JaxScalerParams(mean=mean, scale=scale, var=scale**2,
                          n_samples=np.asarray(jax_scaler.n_samples))
    jcal = jax_derive(jsp)
    tcal = quant.derive_calibration(scaler_from_arrays(_np_fields(jsp)))
    assert tcal.scale.tobytes() == np.asarray(jcal.scale, np.float32).tobytes()
    assert tcal.scale[3] == np.float32(1e-12 / 127.0)
    jp = _jax_params()
    js = JaxBatchScorer(jp, jsp, io_dtype="int8", calibration=jcal)
    ts = BatchScorer(params_from_jax_arrays(_np_fields(jp)), scaler_from_arrays(_np_fields(jsp)),
                     io_dtype="int8", calibration=tcal, device="cpu")
    rows = data[:300].copy()
    rows[::7, 3] = 0.0  # the constant feature's value, and others off it
    want = js._prepare_host(rows)
    got = ts._prepare_host(rows)
    assert got.dtype == np.int8 and got.tobytes() == want.tobytes()
    assert (np.abs(got) == 127).any() and got[5, 0] == 127 and got[5, 1] == -127
    for n in (1, 7, 64, 300):
        for scorer in (js, ts):
            slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
            if scorer is js:
                scorer.stage_rows(slot, list(rows[:n]))
                jio = slot.io.copy()
            else:
                scorer.stage_items(slot, [(r,) for r in rows[:n]])
                tio = slot.io.copy()
                assert slot.f32[:n].tobytes() == rows[:n].tobytes()  # raw rows survive
            scorer.staging.release(slot)
        assert tio.tobytes() == jio.tobytes(), n


def test_bf16_staged_bits_are_jax(data, linear):
    """The bf16 wire's staged bits (uint16 views) equal JAX's ``ml_dtypes``
    rounding, including rows that sit exactly halfway between two bf16
    values (round to even) and ±inf, in predict_proba's encode and in the
    pinned-slot staging alike."""
    jax_make, port_make = linear
    js, ts = jax_make("bfloat16"), port_make("bfloat16")
    rows = data[:256].copy()
    bits = rows.view(np.uint32)
    bits[:32, :8] = (bits[:32, :8] & 0xFFFF0000) | 0x8000  # exact ties
    bits[32:64, :8] = (bits[32:64, :8] & 0xFFFF0000) | 0x7FFF
    rows[64, :4] = [np.inf, -np.inf, 3.0e38, -1e-40]
    want = js._prepare_host(rows).view(np.uint16)
    got = ts._prepare_host(rows)
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().view(np.uint16).tobytes() == want.tobytes()
    slot = ts.staging.acquire(256)
    io = slot.io
    staged = ts.stage_items(slot, [(r,) for r in rows])
    assert staged is io and staged.view(torch.int16).numpy().view(np.uint16).tobytes() == want.tobytes()
    ts.staging.release(slot)


# -- the fused flushes against JAX's ----------------------------------------


def _check_reasons(fam, scorer, rows, jexpl, jidx, jval, tidx, tval):
    xf = _xf(scorer, rows)
    phi = _full_phi(fam, scorer, xf, jexpl)
    srt = -np.sort(-phi, axis=1)
    rtol, atol = (0.0, 1e-6) if fam == "linear" else (PHI_RTOL, PHI_ATOL)
    np.testing.assert_allclose(tval, jval, rtol=rtol, atol=atol)
    for i in np.nonzero((tidx != jidx).any(axis=1))[0]:
        assert abs(srt[i, K - 1] - srt[i, K]) <= SHAP_TIE, (i, tidx[i], jidx[i])


@pytest.mark.parametrize("explain", [False, True])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_fused_flush_matches_jax(data, families, profiles, forest, fam, wire, explain):
    """Several flushes through each package's fused flush on the same rows:
    scores within 1e-6, reason indices equal but across a 2e-5 tie and
    values within 1e-6 (linear) or the TreeSHAP tolerance (GBT), feature
    counts equal, score counts and the window's rows within 1e-5. The
    half-life is long enough that the decay rounds to 1.0 in float32, so
    the window holds whole counts and equality is exact."""
    jax_make, port_make = families[fam]
    js, ts = jax_make(wire), port_make(wire)
    jp, tp = profiles[fam]
    jm = JaxDrift(jp, halflife_rows=1e12)
    tm = DriftMonitor(tp, halflife_rows=1e12, device="cpu")
    assert tm._decay_for(300) == 1.0
    k = K if explain else 0
    off = 0
    for n in (1, 7, 64, 300):
        rows = data[off:off + n]
        off += n
        jout = _jax_flush(js, jm, rows, k)
        tout = _port_flush(ts, tm, rows, k)
        np.testing.assert_allclose(tout[0], jout[0], rtol=0, atol=1e-6)
        if explain:
            assert tout[1].shape == (n, K)
            _check_reasons(fam, ts, rows, forest[2], jout[1], jout[2], tout[1], tout[2])
    np.testing.assert_array_equal(tm.window.feature_counts.numpy(),
                                  np.asarray(jm.window.feature_counts))
    np.testing.assert_allclose(tm.window.score_counts.numpy(),
                               np.asarray(jm.window.score_counts), rtol=0, atol=1e-5)
    assert float(tm.window.n_rows) == pytest.approx(float(jm.window.n_rows), abs=1e-5)
    assert tm.rows_seen == jm.rows_seen == off


@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_int8_fused_scores_match_split_bitwise(data, families, profiles, fam):
    """The int8 fused flush scores bitwise its own split path
    (``predict_proba`` over the same codes): the folded weights on the
    upcast codes (linear), the explicit dequant (GBT)."""
    scorer = families[fam][1]("int8")
    for n in (1, 7, 64, 700):
        fused = _port_flush(scorer, DriftMonitor(profiles[fam][1], device="cpu"), data[:n])[0]
        split = scorer.predict_proba(data[:n])
        assert fused.view(np.uint32).tobytes() == split.view(np.uint32).tobytes(), n


def test_explicit_dequant_matches_folded(data, linear, profiles):
    """The linear int8 flush scoring the dequantized rows with the raw
    weights (``score_codes=False``) agrees with the folded weights on the
    codes within 1e-5."""
    scorer = linear[1]("int8")
    tp = profiles["linear"][1]
    folded = _port_flush(scorer, DriftMonitor(tp, device="cpu"), data[:256])[0]
    explicit = _port_flush(scorer, DriftMonitor(tp, device="cpu"), data[:256],
                           score_args=(scorer._raw_coef, scorer.intercept), score_codes=False)[0]
    np.testing.assert_allclose(explicit, folded, rtol=0, atol=1e-5)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_warm_up_leaves_the_window_bitwise_unchanged(data, families, profiles, fam, wire):
    """``warm_fused`` stages all-zero rows through the wire's encode with
    valid = 0: the window and the row count stay bitwise as they were."""
    scorer = families[fam][1](wire)
    mon = DriftMonitor(profiles[fam][1], device="cpu")
    _port_flush(scorer, mon, data[:100], K)
    before = [t.clone() for t in mon.window.tensors()]
    rows_before = mon.rows_seen
    for b in (8, 64):
        mon.warm_fused(scorer, b, out_dtype=torch.uint8, explain_k=K)
        mon.warm_fused(scorer, b)
    for a, t in zip(before, mon.window.tensors()):
        assert torch.equal(a, t)
    assert mon.rows_seen == rows_before


@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_int8_window_bins_like_the_f32_window(data, families, profiles, fam):
    """The same traffic through the f32 and the int8 fused flush: PSI
    between the two windows within JAX's gates (score ≤ 0.02, every
    feature ≤ 0.1); the linear family's int8 scores within JAX's score
    gate of f32 (JAX gates the forest's by PSI only: a lattice point can
    cross a bin edge) on every row inside the 8-sigma lattice."""
    port_make = families[fam][1]
    f32, q8 = port_make("float32"), port_make("int8")
    tp = profiles[fam][1]
    mon_f, mon_q = DriftMonitor(tp, device="cpu"), DriftMonitor(tp, device="cpu")
    gaps = []
    for lo in range(0, 4096, 512):
        sf = _port_flush(f32, mon_f, data[lo:lo + 512])[0]
        sq = _port_flush(q8, mon_q, data[lo:lo + 512])[0]
        gaps.append(np.abs(sq - sf))
    gaps = np.delete(np.concatenate(gaps), [5, 700])  # the rows clipped on purpose
    if fam == "linear":
        assert gaps.max() <= QUANT_ATOL and gaps.mean() < QUANT_MEAN_TOL
    wf, wq = mon_f.window, mon_q.window
    assert float(psi_from_counts(wq.score_counts, wf.score_counts)) <= SCORE_PSI_EPS
    assert float(psi_from_counts(wq.feature_counts, wf.feature_counts).max()) <= FEATURE_PSI_EPS
    assert float(wq.n_rows) == pytest.approx(float(wf.n_rows))


@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_uint8_return_over_the_int8_wire(data, families, profiles, fam):
    """The uint8 return wire over int8 codes: ``round(p·255)`` of the f32
    flush's scores, decoded into the slot's buffer; JAX's codes equal but
    where p·255 lies within 1e-3 of a half."""
    jax_make, port_make = families[fam]
    ts, js = port_make("int8"), jax_make("int8")
    tp, jp = profiles[fam][1], profiles[fam][0]
    rows = data[:300]
    p = _port_flush(ts, DriftMonitor(tp, device="cpu"), rows)[0]
    codes = _port_flush(ts, DriftMonitor(tp, device="cpu"), rows, out_dtype=torch.uint8)[0]
    assert codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, np.round(p * np.float32(255.0)).astype(np.uint8))
    jcodes = _jax_flush(js, JaxDrift(jp), rows, out_dtype=jnp.uint8)[0]
    frac = np.abs((p.astype(np.float64) * 255.0) % 1.0 - 0.5)
    assert np.all((codes == jcodes) | (frac < 1e-3))
    out = np.zeros(len(rows), np.float32)
    decode_scores_into(codes, out)
    assert np.abs(out - p).max() <= 0.5 / 255.0 + 1e-6


@pytest.mark.parametrize("ret", ["float32", "float16", "uint8"])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_predict_proba_stream_equals_predict_proba(data, families, fam, wire, ret):
    """The chunked, threaded stream (uneven last chunk, 3 threads) gives
    ``predict_proba``'s scores in row order through each return wire (up
    to the wire's rounding), and JAX's stream's within 1e-6 on f32."""
    jax_make, port_make = families[fam]
    scorer = port_make(wire)
    x = data[:300]
    want = scorer.predict_proba(x)
    got = scorer.predict_proba_stream(x, chunk=64, inflight=3, out_dtype=ret)
    assert got.dtype == np.float32 and got.shape == (300,)
    if ret == "float32":
        assert got.tobytes() == want.tobytes()
        jgot = jax_make(wire).predict_proba_stream(x, chunk=64, inflight=3)
        np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-6)
    elif ret == "float16":
        np.testing.assert_array_equal(got, want.astype(np.float16).astype(np.float32))
    else:
        np.testing.assert_array_equal(got, np.round(want * np.float32(255.0)).astype(np.float32) / 255.0)


# -- the models --------------------------------------------------------------


@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_int8_without_calibration_serves_f32_loudly(fam, forest, monkeypatch, caplog):
    """``SCORER_WIRE=int8`` with nothing to calibrate from logs JAX's
    WARNING, word for word, and serves the f32 wire."""
    from fraud_detection_tpu.models.gbt import FraudGBTModel as JaxGBTModel
    from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxLogistic
    from fraud_detection_tpu_torch.models import FraudGBTModel, FraudLogisticModel

    monkeypatch.setenv("SCORER_WIRE", "int8")
    caplog.set_level(logging.WARNING)
    if fam == "linear":
        jp = _jax_params()
        port = FraudLogisticModel(params_from_jax_arrays(_np_fields(jp)), None, NAMES, device="cpu")
        jax = JaxLogistic(jp, None, NAMES)
    else:
        jf = forest[2].model
        port = FraudGBTModel(gbt_from_arrays(_np_fields(jf)), NAMES, device="cpu")
        jax = JaxGBTModel(jf, NAMES)
    assert port.scorer.io_dtype == jax.scorer.io_dtype == "float32"
    msgs = [r.getMessage() for r in caplog.records if "serving on the float32 wire" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1]


def test_load_binds_the_stamped_calibration(tmp_path, data, monkeypatch):
    """``FraudLogisticModel.load`` under ``SCORER_WIRE=int8`` binds the
    stamped ``quant_calibration.npz`` (here one at 6 sigma, not the
    scaler's 8), as JAX's does; the scores agree within 1e-6."""
    from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxLogistic
    from fraud_detection_tpu_torch.models import FraudLogisticModel

    d = str(tmp_path / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    port0 = FraudLogisticModel.load(d, device="cpu")
    quant.save_calibration(d, quant.derive_calibration(port0.scaler, sigma_range=6.0))
    monkeypatch.setenv("SCORER_WIRE", "int8")
    port, jax = FraudLogisticModel.load(d, device="cpu"), JaxLogistic.load(d)
    assert port.scorer.io_dtype == "int8" and port.calibration.sigma_range == 6.0
    assert port.scorer._quant_scale.tobytes() == np.asarray(jax.scorer._quant_scale).tobytes()
    assert port.scorer._quant_scale.tobytes() != quant.derive_calibration(port0.scaler).scale.tobytes()
    np.testing.assert_allclose(port.scorer.predict_proba(data[:64]),
                               np.asarray(jax.scorer.predict_proba(data[:64])), rtol=0, atol=1e-6)


# -- served: the app and the worker ------------------------------------------


@pytest.fixture(scope="module")
def served_dirs(tmp_path_factory, data, forest, jax_scaler):
    """A logistic directory (the committed models/, no stamped calibration:
    the int8 wire derives one from the scaler) and a GBT directory (the
    port's save of the forest, calibration stamped), each with a baseline
    profile."""
    from fraud_detection_tpu_torch.models import FraudGBTModel, load_any_model
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile, save_profile

    root = tmp_path_factory.mktemp("wires")
    lin = str(root / "linear")
    shutil.copytree(os.path.join(ROOT, "models"), lin)
    assert not os.path.exists(os.path.join(lin, quant.CALIBRATION_FILE))
    x = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",", skiprows=1,
                   max_rows=2000, dtype=np.float32)[:, :30]
    gbt = str(root / "gbt")
    names = load_any_model(lin, device="cpu").feature_names
    tcal = calibration_from_arrays({"scale": np.asarray(jax_derive(jax_scaler).scale),
                                    "sigma_range": 8.0})
    FraudGBTModel(gbt_from_arrays(_np_fields(forest[2].model)), names, background=data[:64],
                  calibration=tcal, io_dtype="float32", device="cpu").save(gbt)
    for d, rows in ((lin, x), (gbt, data)):
        m = load_any_model(d, device="cpu")
        save_profile(d, build_baseline_profile(rows, m.scorer.predict_proba(rows),
                                               feature_names=m.feature_names, device="cpu"))
    return {"linear": (lin, x), "gbt": (gbt, data)}


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
@pytest.mark.parametrize("fam", ["linear", "gbt"])
def test_served_wire_predicts_fused_with_reason_codes_and_the_worker_agrees(
        served_dirs, tmp_path, monkeypatch, fam, wire):
    """The port's app on ``SCORER_WIRE`` answers ``/predict`` (concurrent
    and one at a time) through fused flushes with reason codes:
    ``scorer_wire_fused 1``, ``scorer_explain_fused 1``, every score the
    model's own ``predict_proba`` on the wire within 1e-6 and (linear)
    within JAX's gate of the f32 wire; then the port's worker, on the same wire, drains
    the queued explanations with no consistency failure."""
    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.service import metrics
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.db import ResultsDB
    from fraud_detection_tpu_torch.service.http import TestClient
    from fraud_detection_tpu_torch.service.worker import XaiWorker

    d, x = served_dirs[fam]
    rows = x[:40]
    monkeypatch.delenv("SCORER_WIRE", raising=False)
    f32 = load_any_model(d, device="cpu").scorer.predict_proba(rows)
    db_url, q_url = f"sqlite:///{tmp_path}/fraud.db", f"sqlite:///{tmp_path}/taskq.db"
    for key, value in dict(
        DEVICE="cpu", SCORER_WIRE=wire, SCORER_EXPLAIN="topk", SCORER_MAX_BATCH="64",
        MODEL_PATH=os.path.join(d, "model.npz"), MLFLOW_TRACKING_URI=f"file:{tmp_path}/mlruns",
        DATABASE_URL=db_url, CELERY_BROKER_URL=q_url,
    ).items():
        monkeypatch.setenv(key, value)
    model = load_any_model(d, device="cpu")
    assert model.scorer.io_dtype == wire
    want = model.scorer.predict_proba(rows)
    fused0 = metrics.scorer_flushes.labels("fused", "0").value
    split0 = metrics.scorer_flushes.labels("split", "0").value
    with TestClient(create_app()) as tc:
        assert tc.get("/health").status_code == 200
        batcher = tc.app.state["batcher"]

        async def burst():
            return await asyncio.gather(*(batcher.score_ex(r) for r in rows[:24]))

        concurrent = tc.loop.run_until_complete(burst())
        bodies = [tc.post("/predict", json={"features": r.tolist()}).json() for r in rows[24:]]
        text = tc.get("/metrics").text
    got = np.array([s for s, _ in concurrent] + [b["score"] for b in bodies], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if fam == "linear":  # JAX's score gate; the forest's is PSI only
        assert np.abs(got - f32).max() <= QUANT_ATOL and np.abs(got - f32).mean() < QUANT_MEAN_TOL
    assert all(len(r[0]) == K for _, r in concurrent)
    assert all(len(b["reason_codes"]) == K and b["explanation_status"] == "queued" for b in bodies)
    assert "scorer_wire_fused 1.0" in text and "scorer_explain_fused 1.0" in text
    assert metrics.scorer_flushes.labels("fused", "0").value - fused0 >= 1
    assert metrics.scorer_flushes.labels("split", "0").value == split0

    failures = metrics.xai_explain_consistency_failures.get()
    w = XaiWorker(broker_url=q_url, database_url=db_url, device="cpu")
    assert w.model.scorer.io_dtype == wire
    assert w.run_batch(max_batch=64) == len(bodies)
    assert metrics.xai_explain_consistency_failures.get() == failures
    db = ResultsDB(db_url)
    for b in bodies:
        assert db.get(b["transaction_id"])["status"] == "COMPLETED"
