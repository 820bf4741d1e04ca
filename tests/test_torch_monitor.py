"""The port's drift monitoring against the JAX package's
(``fraud_detection_tpu/monitor/{baseline,drift}.py``): histogram counts,
the window after several fused flushes (with and without the explain leg),
the split-path window update, and the PSI/KS/ECE statistics."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fraud_detection_tpu.monitor import baseline as jbase
from fraud_detection_tpu.monitor import drift as jdrift
from fraud_detection_tpu.ops.scorer import _raw_score_linear as jax_score
from fraud_detection_tpu_torch.convert import profile_from_arrays
from fraud_detection_tpu_torch.monitor import baseline as tbase
from fraud_detection_tpu_torch.monitor import drift as tdrift
from fraud_detection_tpu_torch.ops import scorer as tscorer
from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear as torch_score

torch.set_num_threads(1)

D = 30


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3000, D)).astype(np.float32)
    coef = (rng.standard_normal(D) / np.sqrt(D)).astype(np.float32)
    b = np.float32(-1.0)
    scores = 1.0 / (1.0 + np.exp(-(x @ coef + b)))
    profile = jbase.build_baseline_profile(x, scores, feature_names=[f"f{i}" for i in range(D)])
    return rng, x, coef, b, profile


def test_histograms_equal_jax_with_01_weights(setup):
    rng, x, coef, b, profile = setup
    xb = x[:512].copy()
    w = (rng.random(512) < 0.7).astype(np.float32)
    s = rng.random(512).astype(np.float32)
    fe, se = profile.feature_edges, profile.score_edges
    # rows sitting exactly on edges exercise the "#edges <= x" convention
    n_edges = fe.shape[1]
    xb[:n_edges, 0] = fe[0]
    xb[:n_edges, 1] = fe[1]
    for weights in (None, w):
        jf = jbase.feature_histogram(
            jnp.asarray(xb), jnp.asarray(fe),
            None if weights is None else jnp.asarray(weights),
        )
        tf = tbase.feature_histogram(
            torch.from_numpy(xb), torch.from_numpy(fe),
            None if weights is None else torch.from_numpy(weights),
        )
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        js = jbase.score_histogram(
            jnp.asarray(s), jnp.asarray(se),
            None if weights is None else jnp.asarray(weights),
        )
        ts = tbase.score_histogram(
            torch.from_numpy(s), torch.from_numpy(se),
            None if weights is None else torch.from_numpy(weights),
        )
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_baseline_profile_matches_jax(setup):
    """Counts exact; quantile edges within 1e-5 (both interpolate linearly
    in f32, torch and XLA round the interpolation differently)."""
    _, x, coef, b, profile = setup
    scores = 1.0 / (1.0 + np.exp(-(x @ coef + b)))
    got = tbase.build_baseline_profile(
        x, scores, feature_names=list(profile.feature_names), device="cpu"
    )
    np.testing.assert_allclose(got.feature_edges, profile.feature_edges, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.score_edges, profile.score_edges)
    np.testing.assert_allclose(got.score_quantiles, profile.score_quantiles, rtol=0, atol=1e-6)
    # counts over the JAX edges, so an edge rounded differently cannot move
    # a row across a bin
    fc = tbase.feature_histogram(torch.from_numpy(x), torch.from_numpy(profile.feature_edges))
    np.testing.assert_array_equal(fc.numpy(), profile.feature_counts)
    np.testing.assert_array_equal(got.score_counts, profile.score_counts)
    assert got.n_rows == profile.n_rows
    assert got.feature_names == profile.feature_names


def test_profile_files_interchange(setup, tmp_path):
    _, _, _, _, profile = setup
    jbase.save_profile(str(tmp_path / "j"), profile)
    loaded = tbase.load_profile(str(tmp_path / "j"))
    tbase.save_profile(str(tmp_path / "t"), loaded)
    back = jbase.load_profile(str(tmp_path / "t"))
    for field in ("feature_edges", "feature_counts", "score_edges", "score_counts",
                  "score_quantiles"):
        np.testing.assert_array_equal(getattr(back, field), getattr(profile, field))
    assert back.n_rows == profile.n_rows and back.feature_names == profile.feature_names
    assert tbase.load_profile(str(tmp_path / "absent")) is None
    conv = profile_from_arrays(profile.__dict__)
    np.testing.assert_array_equal(conv.feature_counts, profile.feature_counts)


def _batches(rng, x, sizes):
    off = 0
    for n in sizes:
        b = 8
        while b < n:
            b *= 2
        xb = np.zeros((b, D), np.float32)
        xb[:n] = x[off:off + n] + np.float32(0.3)  # a shifted live stream
        valid = np.zeros(b, np.float32)
        valid[:n] = 1.0
        off += n
        yield n, xb, valid


@pytest.mark.parametrize("explain_k", [0, 3])
def test_window_after_fused_flushes_matches_jax(setup, explain_k):
    """Scores within 1e-6 (f32 summation order), reason indices equal, the
    window within 1e-5 relative (decayed f32 sums), and PSI/KS/ECE of the
    window within 1e-5."""
    rng, x, coef, b, profile = setup
    halflife = 500.0
    fe_j, se_j = jnp.asarray(profile.feature_edges), jnp.asarray(profile.score_edges)
    fe_t = torch.from_numpy(profile.feature_edges)
    se_t = torch.from_numpy(profile.score_edges)
    jw = jdrift.init_window(D, profile.feature_counts.shape[1], profile.score_counts.shape[0])
    tw = tdrift.init_window(D, profile.feature_counts.shape[1], profile.score_counts.shape[0])
    mu = x.mean(0).astype(np.float32)
    jargs, targs = (jnp.asarray(coef), jnp.asarray(b)), (torch.from_numpy(coef), torch.tensor(b))
    for n, xb, valid in _batches(rng, x, [5, 64, 200, 1, 37, 128]):
        decay = np.float32(0.5 ** (n / halflife))
        if explain_k:
            js, jidx, jval, jw = jdrift._fused_flush_explain(
                jw, jnp.asarray(xb), jnp.asarray(valid), jnp.float32(decay), fe_j, se_j,
                jargs, (jnp.asarray(coef), jnp.asarray(mu)),
                score_fn=jax_score, explain_k=explain_k,
            )
            ts, tidx, tval = tdrift._fused_flush_explain(
                tw, torch.from_numpy(xb), torch.from_numpy(valid), float(decay),
                fe_t, se_t, targs, (torch.from_numpy(coef), torch.from_numpy(mu)),
                score_fn=torch_score, explain_k=explain_k,
            )
            # reason indices ship as uint8 (d ≤ 256)
            assert tidx.dtype == torch.uint8
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
            np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0, atol=1e-6)
        else:
            js, jw = jdrift._fused_flush(
                jw, jnp.asarray(xb), jnp.asarray(valid), jnp.float32(decay), fe_j, se_j,
                jargs, score_fn=jax_score,
            )
            ts = tdrift._fused_flush(
                tw, torch.from_numpy(xb), torch.from_numpy(valid), float(decay),
                fe_t, se_t, targs, score_fn=torch_score,
            )
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    for jt, tt in zip(jw, tw.tensors()):
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)
    base_fc, base_sc = profile.feature_counts, profile.score_counts
    jstats = jdrift._drift_stats(jw, jnp.asarray(base_fc), jnp.asarray(base_sc))
    tstats = tdrift._drift_stats(tw, torch.from_numpy(base_fc), torch.from_numpy(base_sc))
    for jv, tv in zip(jstats, tstats):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert float(tstats.feature_psi.max()) > 0.01  # the shift is visible


@pytest.mark.parametrize("return_wire", ["float16", "uint8"])
def test_narrow_return_wires_match_jax(return_wire):
    rng = np.random.default_rng(2)
    s = rng.random(64).astype(np.float32)
    jd = {"float16": jnp.float16, "uint8": jnp.uint8}[return_wire]
    td = {"float16": torch.float16, "uint8": torch.uint8}[return_wire]
    s[:4] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 0.5]  # round-half-even cases
    np.testing.assert_array_equal(
        tscorer._cast_scores(torch.from_numpy(s), td).numpy(),
        np.asarray(jdrift._narrow_scores(jnp.asarray(s), jd)),
    )


def test_drift_monitor_update_and_stats_match_jax(setup):
    """The split path (DriftMonitor.update, labels and calibration-only
    replays included) and the status-time stats dict."""
    rng, x, coef, b, profile = setup
    tprofile = profile_from_arrays(profile.__dict__)
    jm = jdrift.DriftMonitor(profile, halflife_rows=1000.0)
    tm = tdrift.DriftMonitor(tprofile, halflife_rows=1000.0, device="cpu")
    for lo, n in ((0, 100), (100, 300), (400, 7)):
        xs = x[lo:lo + n]
        sc = 1.0 / (1.0 + np.exp(-(xs @ coef + b)))
        labels = (rng.random(n) < sc).astype(np.float32)
        for m in (jm, tm):
            m.update(xs, sc)
            m.update(xs, sc, labels=labels, calibration_only=True)
    js, ts = jm.stats(), tm.stats()
    assert ts["rows_seen"] == js["rows_seen"] == 407
    for key in ("window_rows", "feature_psi_max", "feature_ks_max", "score_psi",
                "score_ks", "ece", "n_labeled"):
        assert ts[key] == pytest.approx(js[key], rel=1e-5, abs=1e-5), key
    assert [t["feature"] for t in ts["top_features"][:3]] == [
        t["feature"] for t in js["top_features"][:3]
    ]
