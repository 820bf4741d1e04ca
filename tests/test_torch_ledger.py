"""The ledger (per-entity velocity state) on the port against the JAX
package's ``ledger/``, ``train(ledger=True)`` and ledger flush, at a small
size (``LEDGER_SLOTS = 64``, a few hundred rows a batch set), on the CPU.

Exact across the packages: the hashes, the entity synthesis, the
``ledger_state.npz`` interchange, and of the table ``last_ts``, the
fingerprints and the collision and eviction counts. Within a stated
tolerance: the accumulators, the features and the served scores (the body
is built of ``exp2``, ``log1p`` and ``sqrt``, whose float32 results differ
between XLA's CPU and PyTorch's in the last bits). Inside the port, bitwise
as the JAX package pins its own: serve → replay, two replays, the padding
warm-up and the null rows."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.data.synthetic import generate_synthetic_data
from fraud_detection_tpu.ledger import materialize_features as jax_materialize
from fraud_detection_tpu.ledger import synthesize_entities as jax_synthesize
from fraud_detection_tpu.ledger.features import _ledger_read_update as jax_step
from fraud_detection_tpu.ledger.features import ledger_stats as jax_ledger_stats
from fraud_detection_tpu.ledger.replay import row_keys as jax_row_keys
from fraud_detection_tpu.ledger.state import LedgerSpec as JaxSpec
from fraud_detection_tpu.ledger.state import device_state as jax_device_state
from fraud_detection_tpu.ledger.state import entity_fingerprint as jax_fingerprint
from fraud_detection_tpu.ledger.state import entity_slot as jax_slot
from fraud_detection_tpu.ledger.state import load_ledger as jax_load_ledger
from fraud_detection_tpu.ledger.state import save_ledger as jax_save_ledger
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import load_profile as jax_load_profile
from fraud_detection_tpu.monitor.shadow import ShadowScorer as JaxShadow
from fraud_detection_tpu.monitor.watchtower import Thresholds as JaxThresholds
from fraud_detection_tpu.monitor.watchtower import Watchtower as JaxWatchtower
from fraud_detection_tpu.monitor.watchtower import _challenger_explainer as jax_explainer
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.binlane import _FrameDecoder as JaxDecoder
from fraud_detection_tpu.service.http import Request as JaxRequest
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.service.microbatch import MicroBatcher as JaxBatcher
from fraud_detection_tpu.train import train as jax_train
from fraud_detection_tpu_torch.ledger import (
    LEDGER_FEATURE_NAMES,
    LEDGER_K,
    LedgerSpec,
    _ledger_read_update,
    entity_fingerprint,
    entity_slot,
    ledger_stats,
    load_ledger,
    materialize_features,
    save_ledger,
    synthesize_entities,
)
from fraud_detection_tpu_torch.ledger.replay import row_keys
from fraud_detection_tpu_torch.ledger.state import device_state, host_state
from fraud_detection_tpu_torch.models import FraudLogisticModel, load_any_model
from fraud_detection_tpu_torch.monitor.baseline import load_profile
from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
from fraud_detection_tpu_torch.monitor.shadow import ShadowScorer
from fraud_detection_tpu_torch.monitor.watchtower import (
    Thresholds,
    Watchtower,
    _challenger_explainer,
)
from fraud_detection_tpu_torch.service import binlane, metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import Request, TestClient
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher
from fraud_detection_tpu_torch.service.worker import XaiWorker
from fraud_detection_tpu_torch.train import train

torch.set_num_threads(1)

D = 30
KAGGLE = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
SLOTS = 64
#: cross-package tolerance of the float columns (accumulators, features)
RTOL = ATOL = 1e-5
#: served scores across the packages
SCORE_ATOL = 1e-5
FIELDS = ("acc", "last_ts", "fingerprint", "collisions", "evictions")
EXACT = ("last_ts", "fingerprint", "collisions", "evictions")
NEVER_OFF = JaxThresholds(5.0, 5.0, 5.0, 1.0, 10**9)


def _spec(slots=SLOTS, halflife=600.0, nulls=None):
    kw = dict(n_base=D, slots=slots, halflife_s=halflife, amount_col=-1,
              null_features=np.zeros(LEDGER_K, np.float32) if nulls is None else nulls)
    return JaxSpec(**kw), LedgerSpec(**kw)


def _rows(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1]) * 50.0
    return x


def _assert_tables(jax_state, port_state, what=""):
    """``last_ts``, fingerprints and the counts equal, ``acc`` within the
    tolerance, the file's dtypes on both sides."""
    port_state = host_state(port_state)
    for name, a, b in zip(FIELDS, jax_state, port_state):
        a = np.asarray(a)
        assert a.dtype == b.dtype, (what, name)
        if name in EXACT:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


def _assert_bitwise(a, b, what=""):
    for name, x, y in zip(FIELDS, host_state(a), host_state(b)):
        assert x.tobytes() == y.tobytes(), (what, name)


# ---------------------------------------------------------------------------
# exact: hashes, synthesis, the npz interchange
# ---------------------------------------------------------------------------


def test_hashes_equal_jax():
    ids = ["card-4242", "a", "", "x" * 200, "kärte-ü", 17, 0, -5, 2**40,
           *[f"sim-{i}" for i in range(300)]]
    for e in ids:
        fp = entity_fingerprint(e)
        assert fp == jax_fingerprint(e) and 1 <= fp <= 0xFFFFFFFF
        for log2 in (1, 6, 13, 20, 32):
            assert entity_slot(fp, log2) == jax_slot(fp, log2)
    js, ps = _spec()
    ents = [None if i % 5 == 0 else ids[i % len(ids)] for i in range(400)]
    for got, want in zip(row_keys(ps, ents, len(ents)), jax_row_keys(js, ents, len(ents))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert ps.row_keys("card-1") == js.row_keys("card-1")
    assert ps.rel_ts(12.0) == js.rel_ts(12.0) == 12.0


@pytest.mark.parametrize("names", [KAGGLE, [f"f{i}" for i in range(D)]])
def test_synthesize_entities_equals_jax(names):
    rng = np.random.default_rng(1)
    x = _rows(rng, 777)
    x[:, 0] = rng.uniform(0, 5000, 777)
    for seed, per in ((0, 50), (42, 7), (3, 1000)):
        got_e, got_t = synthesize_entities(x, names, seed, per)
        want_e, want_t = jax_synthesize(x, names, seed, per)
        assert got_e == want_e
        assert got_t.dtype == want_t.dtype == np.float32
        np.testing.assert_array_equal(got_t, want_t)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ledger_npz_interchange(tmp_path, writer):
    """Either package writes ``ledger_state.npz`` and the other loads it:
    the spec's fields, the file's keys and dtypes, all five leaves."""
    rng = np.random.default_rng(2)
    x = _rows(rng, 500)
    ents = [f"e{i % 23}" for i in range(500)]
    ts = np.arange(1.0, 501.0, dtype=np.float32)
    js, ps = _spec(nulls=np.arange(LEDGER_K, dtype=np.float32) + 0.5)
    js = dataclasses.replace(js, ts_origin=1.7e9)
    ps = dataclasses.replace(ps, ts_origin=1.7e9)
    _, state = jax_materialize(js, x, ents, ts)
    d = str(tmp_path)
    if writer == "jax":
        jax_save_ledger(d, js, state)
        spec, got = load_ledger(d)
    else:
        save_ledger(d, ps, device_state(state, SLOTS))
        spec, got = jax_load_ledger(d)
    for f in ("n_base", "slots", "halflife_s", "amount_col", "ts_origin"):
        assert getattr(spec, f) == getattr(js, f), f
    np.testing.assert_array_equal(spec.null_features, js.null_features)
    for name, a, b in zip(FIELDS, state, got):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name
    with np.load(os.path.join(d, "ledger_state.npz")) as z:
        dtypes = {k: z[k].dtype for k in z.files}
    assert dtypes == {
        "n_base": np.int64, "slots": np.int64, "halflife_s": np.float64,
        "amount_col": np.int64, "ts_origin": np.float64,
        "null_features": np.float32, "acc": np.float32, "last_ts": np.float32,
        "fingerprint": np.uint32, "collisions": np.float32, "evictions": np.float32,
    }


# ---------------------------------------------------------------------------
# the read-update body and the replay against JAX
# ---------------------------------------------------------------------------


def _colliders(n, log2):
    """``n`` entity ids hashing to one slot."""
    target = entity_slot(entity_fingerprint("victim"), log2)
    out = ["victim"]
    i = 0
    while len(out) < n:
        cand = f"attacker-{i}"
        i += 1
        if entity_slot(entity_fingerprint(cand), log2) == target:
            out.append(cand)
    return out


def test_one_read_update_step_matches_jax():
    """One 48-row step from a table the JAX package replayed: an entity
    repeated within the batch, a 3-way hash collision, NaN/±Inf/1e12
    amounts, entity-less rows and trailing padding. ``last_ts``,
    fingerprints, collisions and evictions are equal; ``acc`` and the
    features within rtol 1e-5 / atol 1e-5 (measured on the CPU backends: features
    6.1e-5 at most, 3.3e-7 relative; acc 6.1e-5, 1.1e-7 relative)."""
    js, ps = _spec()
    rng = np.random.default_rng(3)
    pre = _rows(rng, 400)
    coll = _colliders(3, js.log2_slots)
    pre_ents = [coll[i % 3] if i % 4 == 0 else f"card-{i % 17}" for i in range(400)]
    _, state = jax_materialize(js, pre, pre_ents, np.arange(1.0, 401.0, dtype=np.float32))
    n = 48
    ents = []
    for i in range(40):
        ents.append(None if i % 9 == 4 else (coll[i % 3] if i % 5 == 0 else f"card-{i % 6}"))
    ents += [None] * 8  # padding rows
    slots, fps, has = jax_row_keys(js, ents, n)
    amount = np.abs(rng.standard_normal(n)).astype(np.float32) * 80.0
    amount[[2, 11, 17, 23]] = [np.nan, np.inf, -np.inf, 1e12]
    amount[40:] = 0.0
    ts = (410.0 + np.repeat(np.arange(24), 2)).astype(np.float32)
    ts[40:] = 0.0
    null = np.arange(LEDGER_K, dtype=np.float32) - 1.0
    jf, jst = jax.jit(jax_step)(
        jax_device_state(state, SLOTS), jnp.asarray(slots), jnp.asarray(fps),
        jnp.asarray(ts), jnp.asarray(amount), jnp.asarray(has), jnp.asarray(null),
        jnp.float32(js.halflife_s),
    )
    pst = device_state(state, SLOTS)
    pf = _ledger_read_update(
        pst, torch.from_numpy(slots.astype(np.int64)),
        torch.from_numpy(fps.astype(np.int64)), torch.from_numpy(ts),
        torch.from_numpy(amount), torch.from_numpy(has), torch.from_numpy(null),
        torch.tensor(js.halflife_s, dtype=torch.float32),
    )
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    assert np.isfinite(pf.numpy()).all()
    np.testing.assert_array_equal(pf.numpy()[has == 0], np.broadcast_to(null, (12, LEDGER_K)))
    _assert_tables(jax.tree_util.tree_map(np.asarray, jst), pst, "one step")
    assert float(pst.collisions) > float(state.collisions)
    assert ledger_stats(pst, js.halflife_s) == pytest.approx(
        jax_ledger_stats(jst, js.halflife_s), rel=1e-6
    )


def test_replay_matches_jax():
    """``materialize_features`` over 2,000 synthetic rows (the Kaggle
    schema's ``Time`` column, 40 pseudo-entities over 64 slots): the same
    column checks (measured on the CPU backends: features 1.2e-4 at most, on amount
    sums of ~1e3; acc 3.9e-3 on sums of squares, 1.7e-7 relative)."""
    js, ps = _spec()
    rng = np.random.default_rng(4)
    x = _rows(rng, 2000)
    x[:, 0] = np.sort(rng.uniform(0, 7200, 2000))
    ents, ts = synthesize_entities(x, KAGGLE, 11, 50)
    jf, jstate = jax_materialize(js, x, ents, ts)
    pf, pstate = materialize_features(ps, x, ents, ts, device="cpu")
    np.testing.assert_allclose(pf, jf, rtol=RTOL, atol=ATOL)
    _assert_tables(jstate, pstate, "replay")
    assert float(pstate.collisions) > 0


def test_two_replays_are_bitwise_equal():
    _, ps = _spec()
    rng = np.random.default_rng(5)
    x = _rows(rng, 700)
    ents, ts = synthesize_entities(x, KAGGLE, 9)
    f1, s1 = materialize_features(ps, x, ents, ts, device="cpu")
    f2, s2 = materialize_features(ps, x, ents, ts, device="cpu")
    assert f1.tobytes() == f2.tobytes()
    _assert_bitwise(s1, s2, "replays")


def test_all_padding_step_leaves_the_table_bitwise_unchanged():
    _, ps = _spec()
    rng = np.random.default_rng(6)
    x = _rows(rng, 300)
    _, state = materialize_features(ps, x, [f"e{i % 11}" for i in range(300)],
                                    np.arange(1.0, 301.0, dtype=np.float32), device="cpu")
    table = device_state(state, SLOTS)
    z = torch.zeros(128)
    zi = torch.zeros(128, dtype=torch.int64)
    _ledger_read_update(table, zi, zi, z, z, z, torch.zeros(LEDGER_K),
                        torch.tensor(600.0))
    _assert_bitwise(state, table, "padding")


# ---------------------------------------------------------------------------
# training: train(ledger=True) on both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One synthetic CSV (3,000 rows, the Kaggle schema), trained with
    ``LEDGER_SLOTS=64`` by JAX's ``train(ledger=True)`` and by the port's on
    the CPU, 3 folds, unregistered."""
    root = tmp_path_factory.mktemp("ledger_train")
    csv = str(root / "synth.csv")
    generate_synthetic_data(csv, n_samples=3000, fraud_ratio=0.03, seed=0, shift_scale=0.35)
    out = {"csv": csv}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEDGER_SLOTS", str(SLOTS))
        for name, fn, kw in (("jax", jax_train, {}), ("port", train, {"device": "cpu"})):
            mp.setenv("MLFLOW_TRACKING_URI", f"file:{root}/{name}/mlruns")
            d = str(root / name / "models")
            out[name] = (fn(data_csv=csv, n_folds=3, register=False, out_dir=d,
                            ledger=True, **kw), d)
    return out


def test_train_ledger_matches_jax_train(trained):
    """The widened names and the spec are equal but ``ts_origin`` (a wall
    clock), the null features within the tolerance, test AUC within 0.01
    (the SMOTE draws differ: threefry against a torch generator)."""
    (got, pdir), (want, jdir) = trained["port"], trained["jax"]
    pm = FraudLogisticModel.load(pdir, device="cpu")
    jm = JaxModel.load(jdir)
    assert pm.feature_names == jm.feature_names == KAGGLE + list(LEDGER_FEATURE_NAMES)
    for f in ("n_base", "slots", "halflife_s", "amount_col"):
        assert getattr(pm.ledger_spec, f) == getattr(jm.ledger_spec, f), f
    assert pm.ledger_spec.slots == SLOTS
    np.testing.assert_allclose(pm.ledger_spec.null_features, jm.ledger_spec.null_features,
                               rtol=RTOL, atol=ATOL)
    _assert_tables(jm.ledger_state, device_state(pm.ledger_state, SLOTS), "trained table")
    assert abs(got["test_auc"] - want["test_auc"]) <= 0.01
    assert got["stages"]["ledger_replay"] > 0
    assert isinstance(load_any_model(jdir, device="cpu"), FraudLogisticModel)


# ---------------------------------------------------------------------------
# serving: a JAX-trained widened model through both packages' flush
# ---------------------------------------------------------------------------


def _batches(spec, x, t0, n_batches=5, bs=64, seed=8):
    """Five 64-row batches: nine entities repeating within each batch and
    every 7th row entity-less; origin-relative times after ``t0``."""
    rng = np.random.default_rng(seed)
    out = []
    t = t0
    for _ in range(n_batches):
        rows = x[rng.integers(0, x.shape[0], bs)]
        ents = [f"card-{i % 9}" if i % 7 else None for i in range(bs)]
        ts = np.asarray([t + i for i in range(bs)], np.float32)
        t += bs
        out.append((rows, ents, ts))
    return out


def _items(spec, rows, ents, ts):
    items = []
    for i in range(rows.shape[0]):
        ent = None
        if ents[i] is not None:
            s, fp = spec.row_keys(ents[i])
            ent = (s, fp, float(ts[i]))
        items.append((rows[i], None, None, ent))
    return items


def _serve_port(model, profile, batches, explain_k=3):
    wt = Watchtower(profile, thresholds=Thresholds(5.0, 5.0, 5.0, 1.0, 10**9),
                    halflife_rows=float("inf"), device="cpu")
    wt.drift.bind_ledger(model.ledger_spec, model.ledger_state)
    mb = MicroBatcher(model.scorer, watchtower=wt, telemetry=False,
                      explain=explain_k > 0, explain_k=max(explain_k, 1))
    tgt = mb._fused_target(model.scorer)
    assert tgt is not None and tgt[1].ledger is not None
    scores, reasons = [], []
    try:
        for rows, ents, ts in batches:
            out = mb._flush_device(model.scorer, tgt, _items(model.ledger_spec, rows, ents, ts))
            scores.append(np.array(out[0]))
            if out[1] is not None:
                reasons.append((np.array(out[1][0]), np.array(out[1][1])))
            model.scorer.staging.release(out[-1])
        return np.concatenate(scores), reasons, wt.drift
    finally:
        wt.close()


def _serve_jax(model, profile, batches, explain_k=3):
    wt = JaxWatchtower(profile, thresholds=NEVER_OFF, halflife_rows=float("inf"))
    wt.drift.bind_ledger(model.ledger_spec, model.ledger_state)
    mb = JaxBatcher(scorer=model.scorer, watchtower=wt, telemetry=False,
                    explain=True, explain_k=explain_k)
    tgt = mb._fused_target(model.scorer)
    scores, reasons = [], []
    try:
        for rows, ents, ts in batches:
            out = mb._flush_device(model.scorer, tgt,
                                   _items(model.ledger_spec, rows, ents, ts), False)
            scores.append(np.array(out[0], np.float32))
            reasons.append((np.array(out[1][0]), np.array(out[1][1])))
        return np.concatenate(scores), reasons, wt.drift
    finally:
        wt.close()


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_serving_a_jax_trained_widened_model(trained, monkeypatch, wire):
    """Five 64-row batches with repeated entities and null rows through the
    port's ledger flush and JAX's, on each h2d wire, from the table JAX's
    training stamped: scores within 1e-5; reason indices equal unless the
    attributions they swap lie within 1e-5; the drift window's counts
    equal (an infinite half-life, so the window holds whole counts: a
    decayed window's last bits differ between XLA's fused multiply-add and
    PyTorch's two steps); the tables as the cross-package checks say."""
    monkeypatch.setenv("SCORER_WIRE", wire)
    _, jdir = trained["jax"]
    jm, pm = JaxModel.load(jdir), FraudLogisticModel.load(jdir, device="cpu")
    assert pm.scorer.io_dtype == wire and pm.scorer.staging_features == D
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, dtype=np.float32)[:, :D]
    t0 = float(np.max(jm.ledger_state.last_ts)) + 5.0
    batches = _batches(pm.ledger_spec, x, t0)
    js, jr, jd = _serve_jax(jm, jax_load_profile(jdir), batches)
    ps, pr, pd = _serve_port(pm, load_profile(jdir), batches)
    np.testing.assert_allclose(ps, js, rtol=0, atol=SCORE_ATOL)
    for (pi, pv), (ji, jv) in zip(pr, jr):
        np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
        differ = (pi.astype(np.int64) != ji.astype(np.int64)).any(axis=1)
        assert np.abs(pv[differ] - jv[differ]).max(initial=0.0) <= 1e-5
        assert differ.sum() <= 2
    jw, pw = jd.window, pd.window
    np.testing.assert_array_equal(pw.feature_counts.numpy(), np.asarray(jw.feature_counts))
    np.testing.assert_array_equal(pw.score_counts.numpy(), np.asarray(jw.score_counts))
    assert float(pw.n_rows) == float(jw.n_rows)
    _assert_tables(jd.ledger_snapshot(), pd.ledger_snapshot(), wire)
    assert pd.ledger_stats()["hash_collisions"] == jd.ledger_stats()["hash_collisions"]


# ---------------------------------------------------------------------------
# contracts inside the port, bitwise
# ---------------------------------------------------------------------------


def test_serve_then_replay_is_bitwise(trained):
    """The table the port's flush served equals, bit for bit, a replay of
    the served rows from the same stamped table in the flush partition;
    the replay's widened rows score within 2e-6 of the served scores."""
    _, pdir = trained["port"]
    pm = FraudLogisticModel.load(pdir, device="cpu")
    spec = pm.ledger_spec
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, dtype=np.float32)[:, :D]
    batches = _batches(spec, x, float(np.max(pm.ledger_state.last_ts)) + 5.0)
    served, _, drift = _serve_port(pm, load_profile(pdir), batches, explain_k=0)
    rows = np.concatenate([b[0] for b in batches])
    ents = [e for b in batches for e in b[1]]
    ts = np.concatenate([b[2] for b in batches])
    feats, replayed = materialize_features(spec, rows, ents, ts, state=pm.ledger_state,
                                           batch=64, device="cpu")
    _assert_bitwise(drift.ledger_snapshot(), replayed, "serve vs replay")
    xw = np.concatenate([rows, feats], axis=1).astype(np.float32)
    np.testing.assert_allclose(pm.scorer.predict_proba(xw), served, rtol=0, atol=2e-6)


def test_warm_fused_and_null_rows_leave_the_table_unchanged(trained):
    """``warm_fused`` with the ledger bound, on every bucket, and a flush of
    entity-less rows leave the table bitwise unchanged; the null rows are
    counted and score as the widened rows with the stamped null features."""
    _, pdir = trained["port"]
    pm = FraudLogisticModel.load(pdir, device="cpu")
    mon = DriftMonitor(load_profile(pdir), halflife_rows=1e6, device="cpu")
    mon.bind_ledger(pm.ledger_spec, pm.ledger_state)
    for b in (8, 16, 64):
        mon.warm_fused(pm.scorer, b, explain_k=3)
    _assert_bitwise(pm.ledger_state, mon.ledger_snapshot(), "warm_fused")
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, max_rows=16,
                   dtype=np.float32)[:, :D]
    before = metrics.ledger_null_entity_rows.get()
    served, _, drift = _serve_port(pm, load_profile(pdir), [(x, [None] * 16, np.zeros(16))])
    assert metrics.ledger_null_entity_rows.get() == before + 16
    _assert_bitwise(pm.ledger_state, drift.ledger_snapshot(), "null rows")
    np.testing.assert_allclose(served, pm.scorer.predict_proba(pm.ledger_spec.widen(x)),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(pm.scorer.predict_proba(x), served, rtol=0, atol=2e-6)


def test_feedback_rows_fold_into_a_widened_window(trained):
    """Base-width labeled rows (``/monitor/feedback``, the split path) fold
    into a widened drift window through the null features, as in the JAX
    package: the calibration state and the statistics agree within 1e-6
    (relative for the PSI, ~13 here: float32 rounding)."""
    from fraud_detection_tpu.monitor.drift import DriftMonitor as JaxDrift

    _, jdir = trained["jax"]
    jm, pm = JaxModel.load(jdir), FraudLogisticModel.load(jdir, device="cpu")
    got = DriftMonitor(load_profile(jdir), halflife_rows=1e6, device="cpu")
    want = JaxDrift(jax_load_profile(jdir), halflife_rows=1e6)
    got.bind_ledger(pm.ledger_spec, pm.ledger_state)
    want.bind_ledger(jm.ledger_spec, jm.ledger_state)
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((600, D)).astype(np.float32)
    scores = rng.random(600).astype(np.float32)
    labels = (rng.random(600) < 0.3).astype(np.float32)
    for mon in (got, want):
        mon.update(rows, scores, labels, calibration_only=True)
        mon.update(rows[:100], scores[:100])
    g, w = got.stats(), want.stats()
    for key in ("n_labeled", "ece", "window_rows", "feature_psi_max", "score_psi"):
        assert g[key] == pytest.approx(w[key], rel=1e-6, abs=1e-6), key


# ---------------------------------------------------------------------------
# the service: entity-keyed /predict and /ingest/batch, telemetry, worker
# ---------------------------------------------------------------------------


def test_two_apps_serve_entity_keyed_predict_and_ingest_alike(trained, tmp_path, monkeypatch):
    """The JAX app and the port's app on one widened directory, explain
    on: ``/predict`` with ``entity_id`` and ``timestamp`` over a few
    entities and without, then one ``/ingest/batch`` frame with
    fingerprints and timestamps — scores within 1e-5, equal reason-code
    features but across a 1e-5 tie; the status bodies' ``ledger`` and the
    ledger series agree."""
    _, jdir = trained["jax"]
    monkeypatch.setenv("MODEL_PATH", os.path.join(jdir, "logistic_model.joblib"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("SCORER_MAX_BATCH", "64")
    monkeypatch.setenv("DEVICE", "cpu")
    spec, _ = load_ledger(jdir)
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, max_rows=40,
                   dtype=np.float32)[:, :D]
    t0 = spec.ts_origin + float(np.max(load_ledger(jdir)[1].last_ts)) + 10.0
    null_before = metrics.ledger_null_entity_rows.get()
    urls = {name: dict(database_url=f"sqlite:///{tmp_path}/{name}_fraud.db",
                       broker_url=f"sqlite:///{tmp_path}/{name}_taskq.db")
            for name in ("jax", "port")}
    with JaxClient(jax_create_app(**urls["jax"])) as jc, \
            TestClient(create_app(**urls["port"])) as tc:
        for i in range(x.shape[0]):
            body = {"features": x[i].tolist()}
            if i % 4:
                body.update(entity_id=f"card-{i % 5}", timestamp=t0 + 3.0 * i)
            jb, tb = jc.post("/predict", json=body).json(), tc.post("/predict", json=body).json()
            assert tb["score"] == pytest.approx(jb["score"], abs=SCORE_ATOL)
            jv = [r["attribution"] for r in jb["reason_codes"]]
            tv = [r["attribution"] for r in tb["reason_codes"]]
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
            if [r["feature"] for r in tb["reason_codes"]] != [r["feature"] for r in jb["reason_codes"]]:
                assert min(abs(a - b) for a, b in zip(jv[1:], jv[:-1])) <= 1e-5
        fps = np.asarray([entity_fingerprint(f"card-{i % 3}") if i % 5 else 0
                          for i in range(16)], np.uint32)
        body = binlane.encode_frame(x[:16], fps, t0 + 200.0 + np.arange(16.0),
                                    length_prefix=False)
        got = []
        for client, request_cls in ((jc, JaxRequest), (tc, Request)):
            r = _post_raw(client, request_cls, "/ingest/batch", body)
            assert r.status_code == 200, r.body
            got.append(binlane.decode_response_body(r.body)[0])
        np.testing.assert_allclose(got[1], got[0], rtol=0, atol=SCORE_ATOL)
        jl, tl = jc.get("/monitor/status").json()["ledger"], tc.get("/monitor/status").json()["ledger"]
        assert tl is not None and set(tl) == set(jl)
        for key in ("hash_collisions", "evictions", "slots_claimed_frac"):
            assert tl[key] == jl[key], key
        assert tl["slot_occupancy"] == pytest.approx(jl["slot_occupancy"], abs=1.0 / SLOTS)
        text = tc.get("/metrics").text
    assert "ledger_active 1" in text
    # 10 entity-less /predict rows and 4 fingerprint-0 frame rows, in the port
    # app's flushes (the JAX app counts in its own registry)
    assert metrics.ledger_null_entity_rows.get() == null_before + 10 + 4


def _post_raw(client, request_cls, path, body):
    req = request_cls("POST", path, {"content-type": "application/x-fraud-frame"}, body)

    async def go():
        await client.app.startup()
        return await client.app.dispatch(req)

    return client.loop.run_until_complete(go())


def test_frame_entity_columns_equal_jax(trained):
    """The binary lane's ledger columns from a frame's fingerprints and
    timestamps equal the JAX decoder's: slots, fingerprints, times."""
    _, jdir = trained["jax"]
    jm, pm = JaxModel.load(jdir), FraudLogisticModel.load(jdir, device="cpu")
    rng = np.random.default_rng(9)
    n = 100
    fps = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    fps[::7] = 0
    ts = pm.ledger_spec.ts_origin + rng.uniform(-5.0, 1e6, n)
    ent, tsb = fps.astype("<u4").tobytes(), ts.astype("<f8").tobytes()
    got = binlane._FrameDecoder(pm.scorer, n, None).entity_cols(n, ent, tsb)
    want = JaxDecoder(jm.scorer, n, None).entity_cols(n, ent, tsb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))
    assert got[2].dtype == want[2].dtype == np.float32


def test_worker_checks_the_base_columns_of_a_widened_model(trained):
    """The worker's backfill explains base rows through the null slot, so
    its consistency check compares only the base schema's indices: a
    velocity column in the serve top-k with a live-table value passes; a
    wrong base value fails."""
    _, jdir = trained["jax"]
    pm = FraudLogisticModel.load(jdir, device="cpu")
    worker = XaiWorker.__new__(XaiWorker)
    worker.model = pm
    phi, _ = pm.explain_one(np.ones(D, np.float32))
    base = np.argsort(-phi[:D])[:2]
    good = {"indices": [D + 2, *base.tolist()], "values": [99.0, *phi[base].tolist()]}
    assert worker._check_explain_consistency(phi, good, "c", "t")
    bad = {"indices": base.tolist(), "values": [phi[base[0]] + 1.0, phi[base[1]]]}
    before = metrics.xai_explain_consistency_failures.get()
    assert not worker._check_explain_consistency(phi, bad, "c", "t")
    assert metrics.xai_explain_consistency_failures.get() == before + 1
    assert phi.shape == (D + LEDGER_K,)


def test_widened_challenger_shadows_base_rows_through_its_null_slot(trained):
    """A widened challenger shadowing base-width rows scores through the
    null slot and explains through it: the window equals JAX's within
    1e-6."""
    _, jdir = trained["jax"]
    jm, pm = JaxModel.load(jdir), FraudLogisticModel.load(jdir, device="cpu")
    ex = _challenger_explainer(pm)
    assert ex(np.zeros((2, D), np.float32)).shape == (2, D + LEDGER_K)
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, max_rows=64,
                   dtype=np.float32)[:, :D]
    champ = np.linspace(0.01, 0.99, 64).astype(np.float32)
    champ_idx = np.tile(np.arange(3), (64, 1))
    got = ShadowScorer(pm.scorer, load_profile(jdir), sample_rate=1.0,
                       halflife_rows=1e6, explainer=ex)
    want = JaxShadow(jm.scorer, jax_load_profile(jdir), sample_rate=1.0,
                     halflife_rows=1e6, explainer=jax_explainer(jm))
    assert got.maybe_observe(x, champ, champ_idx) and want.maybe_observe(x, champ, champ_idx)
    g, w = got.stats(), want.stats()
    for key in ("window_rows", "disagreement", "mean_abs_delta", "score_psi",
                "reason_divergence"):
        assert g[key] == pytest.approx(w[key], abs=1e-6), key


def test_snapshot_rides_the_model_and_the_loader(tmp_path, trained):
    """``save`` stamps the sidecar and ``load`` carries it; a forest beside
    a ledger sidecar is what JAX's loader makes of it (covered in
    test_torch_models); a stateless directory carries none."""
    _, pdir = trained["port"]
    pm = FraudLogisticModel.load(pdir, device="cpu")
    d = str(tmp_path / "m")
    pm.save(d, joblib_too=False)
    back = load_any_model(d, device="cpu")
    for f in ("n_base", "slots", "halflife_s", "amount_col", "ts_origin"):
        assert getattr(back.ledger_spec, f) == getattr(pm.ledger_spec, f), f
    np.testing.assert_array_equal(back.ledger_spec.null_features,
                                  pm.ledger_spec.null_features)
    _assert_bitwise(pm.ledger_state, back.ledger_state, "save/load")
    assert back.base_feature_names == KAGGLE
    assert back.scorer.n_base_features == D and back.scorer.n_features == D + LEDGER_K
    jm = JaxModel.load(d)
    np.testing.assert_allclose(back.scorer.predict_proba(np.ones((4, D), np.float32)),
                               np.asarray(jm.scorer.predict_proba(np.ones((4, D), np.float32))),
                               rtol=0, atol=1e-6)
