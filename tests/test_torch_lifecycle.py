"""The port's lifecycle loop against the JAX package's: the durable store,
the challenger gate, the retrain and the conductor's state machine with
crash-resume (``fraud_detection_tpu_torch/lifecycle/``), on the CPU.

The same inputs, made from a seed with numpy, go through both packages. The
JAX side runs as ``tests/test_lifecycle.py`` runs it: on the 8-virtual-device
CPU mesh, its retrain fitting the sharded L-BFGS. Tolerances:

- the store's window, reservoir, counts and state machine: equal;
- the gate's four statistics: within 1e-5 of JAX and of a float64 numpy
  recomputation, and padding to the bucket leaves them bitwise unchanged;
- the retrain without SMOTE: the challenger's coefficients within 1e-4,
  holdout AUC within 1e-3, the same verdict and reasons (numbers aside);
  with SMOTE, holdout AUC within 0.01 (the draws differ: threefry against a
  torch generator, ROADMAP queue 3);
- the ledger retrain's replayed features within 1e-5 (rtol and atol, the
  ledger tests' tolerance); the wide retrain within 1e-5 of JAX's fit on a
  model-axis-only mesh (the 1×1 fit, as ``test_torch_wide.py`` holds it);
- the conductor: the same outcomes, aliases and states, case for case, and
  crash-resume exactly once at every named fault point.
"""

import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fraud_detection_tpu.lifecycle as jlc
import fraud_detection_tpu_torch.lifecycle as tlc
from fraud_detection_tpu.data.loader import stratified_split
from fraud_detection_tpu.lifecycle import store as jst
from fraud_detection_tpu.lifecycle.gate import _gate_stats as jax_gate_stats
from fraud_detection_tpu.lifecycle.retrain import _replay_widened as jax_replay_widened
from fraud_detection_tpu.lifecycle.retrain import run_retrain as jax_run_retrain
from fraud_detection_tpu.lifecycle.retrain import warm_start_from as jax_warm_start
from fraud_detection_tpu.ledger.state import LedgerSpec as JaxLedgerSpec
from fraud_detection_tpu.mesh.retrain import mapreduce_pool_stats as jax_pool_stats
from fraud_detection_tpu.models import load_any_model as jax_load_any_model
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu.ops.logistic import logistic_fit_lbfgs as jax_lbfgs
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu.ops.scaler import scaler_transform as jax_scaler_transform
from fraud_detection_tpu.range import faults as jfaults
from fraud_detection_tpu.tracking import TrackingClient as JaxTrackingClient
from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ledger import LEDGER_FEATURE_NAMES, LedgerSpec
from fraud_detection_tpu_torch.ledger.state import init_state
from fraud_detection_tpu_torch.lifecycle import store as tst
from fraud_detection_tpu_torch.lifecycle.gate import _gate_stats, _slice_stats
from fraud_detection_tpu_torch.lifecycle.retrain import (
    _replay_widened,
    run_retrain,
    warm_start_from,
)
from fraud_detection_tpu_torch.lifecycle.store import open_lifecycle_store
from fraud_detection_tpu_torch.mesh.retrain import mapreduce_pool_stats
from fraud_detection_tpu_torch.models import load_any_model
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scaler import ScalerParams, scaler_fit, scaler_transform
from fraud_detection_tpu_torch.range import faults as tfaults
from fraud_detection_tpu_torch.tracking import TrackingClient

torch.set_num_threads(1)

KAGGLE = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
D = 30
N_BASE = 2400
W_TRUE = np.random.default_rng(7).standard_normal(D).astype(np.float32)
#: the retrain's challenger coefficients across the packages (no SMOTE)
COEF_ATOL = 1e-4
#: holdout AUC across the packages (no SMOTE)
AUC_ATOL = 1e-3
#: holdout AUC across the packages with SMOTE (the draws differ)
SMOTE_AUC_ATOL = 0.01
#: the gate's statistics against JAX and a float64 recomputation
STAT_ATOL = 1e-5


def _make_rows(n: int, rng, shift: float = 0.0):
    x = (rng.standard_normal((n, D)) + shift).astype(np.float32)
    logits = x @ W_TRUE - 2.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int32)
    return x, y


def _write_csv(path: str, x: np.ndarray, y: np.ndarray) -> str:
    with open(path, "w") as f:
        f.write(",".join(KAGGLE + ["Class"]) + "\n")
        for row, label in zip(x, y):
            f.write(",".join(f"{v:.6f}" for v in row) + f",{int(label)}\n")
    return path


def _loose(lc):
    """Permissive bounds for the happy paths (the JAX test's LOOSE)."""
    return lc.GateThresholds(auc_margin=0.05, ece_bound=0.5, psi_bound=2.0,
                             min_eval_rows=64)


# the two packages behind one interface: module handles and how each side
# builds its objects
SIDES = {
    "jax": SimpleNamespace(lc=jlc, st=jst, faults=jfaults, client=JaxTrackingClient,
                           load=jax_load_any_model, kw={}),
    "torch": SimpleNamespace(lc=tlc, st=tst, faults=tfaults, client=TrackingClient,
                             load=lambda d: load_any_model(d, device="cpu"),
                             kw={"device": "cpu"}),
}


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """A registered champion (@prod, with its monitor profile) in a registry
    per package, a lifecycle store per package, and a conductor per package
    over a small synthetic base CSV: the JAX test's fixture, twice."""
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "nowhere" / "model.joblib"))
    rng = np.random.default_rng(11)
    x, y = _make_rows(N_BASE, rng)
    csv = _write_csv(str(tmp_path / "base.csv"), x, y)
    monkeypatch.setenv("DATA_CSV", csv)
    # the champion: fitted on the frozen split retrain uses (seed 42)
    tr, _ = stratified_split(y, 0.2, 42)
    scaler = jax_scaler_fit(x[tr])
    params = jax_lbfgs(jax_scaler_transform(scaler, x[tr]), y[tr], max_iter=100)
    champion = JaxModel(params, scaler, KAGGLE)
    art = str(tmp_path / "champion")
    champion.save(art, joblib_too=False)
    scores = np.asarray(champion.scorer.predict_proba(x[:512]))
    save_profile(art, build_baseline_profile(x[tr], scores, feature_names=KAGGLE))
    out = {"tmp": tmp_path, "csv": csv, "x": x, "y": y, "rng": rng, "art": art}
    for name, side in SIDES.items():
        client = side.client(f"file:{tmp_path}/{name}/mlruns")
        v1 = client.registry.register("fraud", art)
        client.registry.set_alias("fraud", "prod", v1)
        url = f"sqlite:///{tmp_path}/{name}/lifecycle.db"
        store = side.lc.LifecycleStore(url, window_size=600, reservoir_size=200, seed=3)
        conductor = side.lc.Conductor(
            store=store, tracking_client=client,
            retrain_kwargs={"data_csv": csv, "use_smote": False, "max_iter": 100,
                            "thresholds": _loose(side.lc)},
            **side.kw,
        )
        out[name] = SimpleNamespace(
            side=side, client=client, registry=client.registry, store=store,
            conductor=conductor, v1=v1, url=url,
            champion=side.load(art),
        )
    yield out
    for name in SIDES:
        out[name].store.close()


def _feed(stores, rng, n=512, marker=None, meta=False):
    """The same labeled batch into every store."""
    x, y = _make_rows(n, rng)
    if marker is not None:
        x[:, 0] = marker
    scores = (1.0 / (1.0 + np.exp(-(x @ W_TRUE - 2.0)))).astype(np.float32)
    kw = {}
    if meta:
        kw = {"entity_ids": [f"card-{i % 17}" if i % 5 else None for i in range(n)],
              "timestamps": [1.7e9 + 3.0 * i if i % 7 else None for i in range(n)]}
    for s in stores:
        s.add_feedback(x, scores, y, **kw)
    return x, y


def _both(env):
    return env["jax"], env["torch"]


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def test_store_pools_and_counts_equal_jax(tmp_path):
    """Both stores take the same eight batches: the window (newest first),
    the reservoir (Vitter's R, the same numpy stream) and the counts are
    equal, and a reopened store continues the same reservoir stream."""
    stores = [lc.LifecycleStore(f"sqlite:///{tmp_path}/{i}.db", window_size=100,
                                reservoir_size=50, seed=5)
              for i, lc in enumerate((jlc, tlc))]
    rng = np.random.default_rng(0)
    for i in range(8):
        _feed(stores, rng, n=50, marker=float(i))
    assert stores[0].feedback_counts() == stores[1].feedback_counts() == {
        "window": 100, "reservoir": 50, "seen": 400,
    }
    for fetch in ("window_rows", "reservoir_rows"):
        for a, b in zip(getattr(stores[0], fetch)(), getattr(stores[1], fetch)()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    wx, _, _ = stores[1].window_rows()
    assert set(np.unique(wx[:, 0])) == {6.0, 7.0}
    assert (stores[1].reservoir_rows()[0][:, 0] < 6.0).any()
    for s in stores:
        s.close()
    again = [lc.LifecycleStore(f"sqlite:///{tmp_path}/{i}.db", window_size=100,
                               reservoir_size=50, seed=6)
             for i, lc in enumerate((jlc, tlc))]
    _feed(again, rng, n=50, marker=8.0)
    assert again[0].feedback_counts() == again[1].feedback_counts()
    np.testing.assert_array_equal(again[1].reservoir_rows()[0], again[0].reservoir_rows()[0])
    for s in again:
        s.close()


def test_store_entity_meta_equals_jax(tmp_path):
    """The ledger's columns ride the same fetch as the rows: entities (None
    for an entity-less row) and timestamps (0.0 where none was given)."""
    stores = [lc.LifecycleStore(f"sqlite:///{tmp_path}/{i}.db", window_size=300,
                                reservoir_size=40, seed=2)
              for i, lc in enumerate((jlc, tlc))]
    _feed(stores, np.random.default_rng(1), n=120, meta=True)
    for fetch in ("window_rows_meta", "reservoir_rows_meta"):
        want, got = (getattr(s, fetch)() for s in stores)
        for a, b in zip(want[:3] + want[4:], got[:3] + got[4:]):
            np.testing.assert_array_equal(b, a)
        assert got[3] == want[3]
        assert None in got[3] and (got[4] == 0.0).any()
    for s in stores:
        s.close()


@pytest.mark.parametrize("bad", ["length", "nan", "score", "label", "timestamp"])
def test_store_guards_reject_what_jax_rejects(tmp_path, bad):
    x = np.zeros((3, D), np.float32)
    s = np.full(3, 0.5, np.float32)
    y = np.zeros(3, np.int32)
    kw = {}
    if bad == "length":
        s = s[:2]
    elif bad == "nan":
        x[1, 2] = np.nan
    elif bad == "score":
        s[0] = 1.5
    elif bad == "label":
        y[2] = 2
    else:
        kw = {"timestamps": [1.0, -1.0, 2.0]}
    for i, lc in enumerate((jlc, tlc)):
        store = lc.LifecycleStore(f"sqlite:///{tmp_path}/{i}.db")
        with pytest.raises(ValueError):
            store.add_feedback(x, s, y, **kw)
        assert store.feedback_counts()["seen"] == 0
        store.close()


def test_state_machine_transitions_equal_jax(tmp_path):
    """The same sequence of CAS transitions, owner guards, heartbeats and
    reclaims gives the same answers and the same rows on both stores."""
    def drive(st, store):
        got = [
            store.transition("fraud", (st.IDLE,), st.RETRAINING, owner="w1", reason="r"),
            store.transition("fraud", (st.IDLE,), st.RETRAINING),
            store.heartbeat("fraud", "w1"),
            store.heartbeat("fraud", "somebody-else"),
            store.reclaim_stale_retrain("fraud", 3600),
            store.transition("fraud", (st.RETRAINING,), st.GATED,
                             owner_guard="somebody-else"),
            store.transition("fraud", (st.RETRAINING,), st.GATED, owner_guard="w1",
                             owner=None, challenger_version=2, champion_version=1,
                             gate={"passed": True}),
            store.transition("fraud", (st.GATED,), st.SHADOWING),
        ]
        row = store.get_state("fraud")
        del row["updated_at"]
        store.set_state("fraud", st.IDLE)
        got.append(store.get_state("fraud")["state"])
        with pytest.raises(ValueError):
            store.transition("fraud", (st.IDLE,), "nonsense")
        return got, row

    results = []
    for i, (lc, st) in enumerate(((jlc, jst), (tlc, tst))):
        store = lc.LifecycleStore(f"sqlite:///{tmp_path}/{i}.db")
        results.append(drive(st, store))
        store.close()
    assert results[1] == results[0]
    assert results[1][1]["state"] == "shadowing"
    assert results[1][0] == [True, False, True, False, False, False, True, True, "idle"]


def test_transition_cas_admits_exactly_one_winner(tmp_path):
    """Six connections to one database race idle → retraining: exactly one
    wins (the single guarded UPDATE decides)."""
    url = f"sqlite:///{tmp_path}/cas.db"
    tlc.LifecycleStore(url).close()  # the schema once, no racing DDL
    stores = [tlc.LifecycleStore(url) for _ in range(6)]
    start = threading.Barrier(len(stores))
    wins = []

    def race(s, i):
        start.wait()
        if s.transition("fraud", (tst.IDLE,), tst.RETRAINING, owner=f"w{i}"):
            wins.append(i)

    threads = [threading.Thread(target=race, args=(s, i)) for i, s in enumerate(stores)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1, wins
    assert stores[0].get_state("fraud")["owner"] == f"w{wins[0]}"
    for s in stores:
        s.close()


def test_postgres_store_url_raises_naming_the_network_tier():
    with pytest.raises(NotImplementedError, match="8c"):
        open_lifecycle_store("postgresql://user@localhost:5432/fraud")
    with pytest.raises(NotImplementedError):
        open_lifecycle_store("mysql://nowhere/fraud")


def test_lifecycle_db_url_defaults_beside_the_broker(monkeypatch):
    monkeypatch.delenv("LIFECYCLE_DB_URL", raising=False)
    assert config.lifecycle_db_url("sqlite:////tmp/q.db") == "sqlite:////tmp/q.db"
    monkeypatch.setenv("LIFECYCLE_DB_URL", "sqlite:////tmp/lc.db")
    assert config.lifecycle_db_url("sqlite:////tmp/q.db") == "sqlite:////tmp/lc.db"


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def _f64_gate_stats(champ, chall, y):
    """The four statistics in float64 numpy, written out afresh."""
    champ, chall = np.float64(champ), np.float64(chall)
    y = np.asarray(y) > 0

    def auc(s):
        pos, neg = s[y], s[~y]
        gt = (pos[:, None] > neg[None, :]).sum() + 0.5 * (pos[:, None] == neg[None, :]).sum()
        return gt / (len(pos) * len(neg))

    def hist(s, n_bins):
        edges = np.linspace(0.0, 1.0, n_bins + 1)[1:-1].astype(np.float32)
        return np.bincount(np.searchsorted(edges, np.float32(s), side="right"),
                           minlength=n_bins).astype(np.float64)

    def mass(c):
        return (c + 1e-4) / (c.sum() + 1e-4 * len(c))

    p, q = mass(hist(chall, 20)), mass(hist(champ, 20))
    psi = float(np.sum((p - q) * np.log(p / q)))
    edges = np.linspace(0.0, 1.0, 11)[1:-1].astype(np.float32)
    idx = np.searchsorted(edges, np.float32(chall), side="right")
    ece = 0.0
    for b in range(10):
        m = idx == b
        if m.any():
            ece += m.mean() * abs(chall[m].mean() - y[m].mean())
    return auc(champ), auc(chall), ece, psi


@pytest.mark.parametrize("n", [37, 256, 300, 1000])
def test_gate_stats_equal_jax_and_float64(n):
    """The same two score vectors through both packages' gate statistic
    and a float64 numpy recomputation: all four within 1e-5."""
    from fraud_detection_tpu_torch.monitor.drift import PSI_EPS

    assert PSI_EPS == 1e-4  # the smoothing _f64_gate_stats writes out
    rng = np.random.default_rng(n)
    y = (rng.random(n) < 0.3).astype(np.float32)
    champ = np.clip(rng.beta(2, 5, n) + 0.2 * y, 0, 1).astype(np.float32)
    chall = np.clip(rng.beta(2, 5, n) + 0.25 * y, 0, 1).astype(np.float32)
    chall[:5] = champ[:5]  # some ties across the models
    w = np.ones(n, np.float32)
    se = np.linspace(0.0, 1.0, 21)[1:-1].astype(np.float32)
    ce = np.linspace(0.0, 1.0, 11)[1:-1].astype(np.float32)
    got = [float(t) for t in _gate_stats(*(torch.as_tensor(a) for a in (champ, chall, y, w, se, ce)))]
    want = [float(t) for t in jax_gate_stats(champ, chall, y, w, se, ce)]
    ref = _f64_gate_stats(champ, chall, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=STAT_ATOL)


@pytest.mark.parametrize("n", [37, 300, 1000])
def test_gate_padding_is_bitwise_inert(n):
    """Padding to the power-of-two bucket with weight-0 rows leaves the four
    statistics bitwise unchanged."""
    rng = np.random.default_rng(100 + n)
    y = (rng.random(n) < 0.2).astype(np.float32)
    champ = rng.random(n).astype(np.float32)
    chall = np.clip(champ + 0.1 * rng.standard_normal(n), 0, 1).astype(np.float32)
    se = torch.linspace(0.0, 1.0, 21)[1:-1]
    ce = torch.linspace(0.0, 1.0, 11)[1:-1]
    bare = _gate_stats(*(torch.as_tensor(a) for a in (champ, chall, y, np.ones(n, np.float32))),
                       se, ce)
    pad = 1024 - n

    def padded(a, v=0.0):
        return torch.as_tensor(np.pad(a, (0, pad), constant_values=v))

    for fill in (0.0, 0.7):  # the padding's scores never matter
        full = _gate_stats(padded(champ, fill), padded(chall, fill), padded(y),
                           padded(np.ones(n, np.float32)), se, ce)
        for a, b in zip(bare, full):
            assert a.numpy().tobytes() == b.numpy().tobytes()


def test_slice_stats_of_identical_models_agree(env):
    """Identical models judge alike on slices of different lengths; the
    width-aware view scores a narrow model on a widened block's prefix."""
    champ = env["torch"].champion
    x, y = env["x"], env["y"]
    for k in (300, 290):
        st = _slice_stats(champ, champ, x[:k], y[:k])
        assert st["champion_auc"] == st["challenger_auc"]
        assert st["score_psi_vs_champion"] == pytest.approx(0.0, abs=1e-9)
    wide = np.concatenate([x[:300], np.ones((300, 4), np.float32)], axis=1)
    assert _slice_stats(champ, champ, wide, y[:300]) == _slice_stats(champ, champ, x[:300], y[:300])
    assert _slice_stats(champ, champ, x[:10], np.zeros(10)) is None


# ---------------------------------------------------------------------------
# the retrain
# ---------------------------------------------------------------------------


def test_warm_start_crosses_scaler_spaces_as_jax(env):
    """Folded-to-raw champion params re-expressed in a new scaler's space
    score as the champion does, and equal JAX's warm start."""
    x = env["x"][:256]
    jnew = jax_scaler_fit(env["x"][100:1200])
    tnew = scaler_fit(torch.as_tensor(env["x"][100:1200]))
    got = warm_start_from(env["torch"].champion, tnew)
    want = jax_warm_start(env["jax"].champion, jnew)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=1e-5, atol=1e-6)
    assert float(got.intercept) == pytest.approx(float(want.intercept), abs=1e-5)
    xs = scaler_transform(tnew, torch.as_tensor(x)).numpy()
    warm = 1.0 / (1.0 + np.exp(-(xs @ got.coef.numpy() + float(got.intercept))))
    np.testing.assert_allclose(warm, env["torch"].champion.scorer.predict_proba(x),
                               rtol=2e-4, atol=2e-5)
    assert warm_start_from(SimpleNamespace(params=None), tnew) is None


def _strip_numbers(reasons):
    return [re.sub(r"-?\d+\.\d+", "#", r) for r in reasons]


def _retrain_both(env, use_smote, thresholds=None):
    """One run_retrain a package over its own (identically fed) store;
    ``thresholds`` maps a package to its GateThresholds (default loose)."""
    out = {}
    for name, fn, extra in (("jax", jax_run_retrain, {}),
                            ("torch", run_retrain, {"device": "cpu"})):
        e = env[name]
        thr = (thresholds or {}).get(name) or _loose(e.side.lc)
        out[name] = fn(e.store, e.champion, e.v1, data_csv=env["csv"], max_iter=100,
                       use_smote=use_smote, tracking_client=e.client, thresholds=thr,
                       **extra)
    return out["jax"], out["torch"]


@pytest.mark.parametrize("strict", [False, True])
def test_retrain_without_smote_matches_jax(env, strict):
    """No SMOTE: the challenger's coefficients within 1e-4, holdout AUC
    within 1e-3, the same verdict and reasons; under an impossible AUC
    margin both reject for the same reason."""
    _feed([env["jax"].store, env["torch"].store], env["rng"], n=512)
    thr = None
    if strict:
        thr = {n: SIDES[n].lc.GateThresholds(
            auc_margin=-0.5, ece_bound=0.5, psi_bound=2.0, min_eval_rows=64)
            for n in SIDES}
    want, got = _retrain_both(env, use_smote=False, thresholds=thr)
    np.testing.assert_allclose(got.challenger.params.coef.numpy(),
                               np.asarray(want.challenger.params.coef), rtol=0, atol=COEF_ATOL)
    assert float(got.challenger.params.intercept) == pytest.approx(
        float(want.challenger.params.intercept), abs=COEF_ATOL)
    for k in ("holdout_challenger_auc", "holdout_champion_auc", "recent_challenger_auc"):
        assert got.gate.metrics[k] == pytest.approx(want.gate.metrics[k], abs=AUC_ATOL), k
    assert got.gate.passed == want.gate.passed == (not strict)
    assert _strip_numbers(got.gate.reasons) == _strip_numbers(want.gate.reasons)
    assert got.metrics["n_feedback_rows"] == want.metrics["n_feedback_rows"]
    assert set(got.metrics["stages"]) >= {"load", "fit", "gate", "artifacts"}
    ch = load_any_model(got.artifact_dir, device="cpu")
    np.testing.assert_array_equal(ch.scorer.predict_proba(env["x"][:64]),
                                  got.challenger.scorer.predict_proba(env["x"][:64]))


def test_retrain_with_smote_matches_jax_within_the_draw_deviation(env):
    _feed([env["jax"].store, env["torch"].store], env["rng"], n=512)
    want, got = _retrain_both(env, use_smote=True)
    assert got.gate.passed == want.gate.passed
    assert got.gate.metrics["holdout_challenger_auc"] == pytest.approx(
        want.gate.metrics["holdout_challenger_auc"], abs=SMOTE_AUC_ATOL)
    assert got.metrics["n_synthetic_rows"] > 0


def test_smote_retrain_is_deterministic(env):
    """Two retrains of one store build the same SMOTE rows (the draws come
    from torch.Generator(seed + 1000)) and the same challenger."""
    _feed([env["torch"].store], env["rng"], n=512)
    e = env["torch"]
    runs = [run_retrain(e.store, e.champion, e.v1, data_csv=env["csv"], max_iter=60,
                        tracking_client=e.client, device="cpu", keep_fit_rows=True,
                        thresholds=_loose(tlc)) for _ in range(2)]
    assert runs[0].fit_rows[0].tobytes() == runs[1].fit_rows[0].tobytes()
    assert torch.equal(runs[0].challenger.params.coef, runs[1].challenger.params.coef)


def test_pool_stats_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, D)).astype(np.float32)
    y = (rng.random(300) < 0.3).astype(np.float32)
    s = rng.random(300).astype(np.float32)
    got, want = mapreduce_pool_stats(x, y, s, device="cpu"), jax_pool_stats(x, y, s)
    assert (got["rows"], got["positives"]) == (want["rows"], want["positives"])
    for k in ("label_rate", "score_mean"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)
    for k in ("feature_mean", "feature_std"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    assert mapreduce_pool_stats(np.zeros((0, D)), [], [], device="cpu")["rows"] == 0


def test_mesh_retrain_raises_naming_item_12(env, monkeypatch):
    monkeypatch.setenv("MESH_RETRAIN", "1")
    e = env["torch"]
    with pytest.raises(NotImplementedError, match="item 12"):
        run_retrain(e.store, e.champion, e.v1, data_csv=env["csv"], device="cpu",
                    tracking_client=e.client)
    # through the conductor the episode fails with that reason, never a
    # quiet single-device fit
    out = e.conductor.handle_retrain("mesh retrain asked")
    assert out["outcome"] == "failed" and "item 12" in out["error"]


def _ledger_specs():
    kw = dict(n_base=D, slots=64, halflife_s=600.0, amount_col=-1,
              null_features=np.zeros(len(LEDGER_FEATURE_NAMES), np.float32))
    return JaxLedgerSpec(**kw), LedgerSpec(**kw)


def test_ledger_replay_equals_jax():
    """The ledger retrain's causal replay over base + feedback rows (with
    and without recorded entities and times): the widened blocks within
    1e-5, the final table's exact columns equal."""
    js, ps = _ledger_specs()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((600, D)).astype(np.float32)
    x[:, 0] = np.sort(rng.uniform(0, 7200, 600))
    x[:, -1] = np.abs(x[:, -1]) * 50.0
    fx_w = rng.standard_normal((80, D)).astype(np.float32)
    fx_r = rng.standard_normal((30, D)).astype(np.float32)
    fe_w = [f"card-{i % 9}" if i % 4 else None for i in range(80)]
    ft_w = np.where(np.arange(80) % 3, 1e9 + 5.0 * np.arange(80), 0.0).astype(np.float32)
    fe_r = [f"card-{i % 5}" for i in range(30)]
    ft_r = np.zeros(30, np.float32)
    args = (x, KAGGLE, 11, fx_w, fe_w, ft_w, fx_r, fe_r, ft_r)
    want = jax_replay_widened(js, *args)
    got = _replay_widened(ps, *args, "cpu")
    assert got[1] == want[1] == KAGGLE + list(LEDGER_FEATURE_NAMES)
    for i in (0, 4, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-5)
    for name in ("last_ts", "fingerprint", "collisions", "evictions"):
        np.testing.assert_array_equal(getattr(got[3], name), np.asarray(getattr(want[3], name)))


def test_ledger_retrain_stamps_a_widened_challenger(env):
    """A ledger-widened champion retrains on the replayed widened rows: the
    challenger is widened, and its stamped table is the replay's."""
    _, ps = _ledger_specs()
    rng = np.random.default_rng(3)
    k = len(LEDGER_FEATURE_NAMES)
    params = LogisticParams(coef=torch.as_tensor(rng.standard_normal(D + k).astype(np.float32) * 0.1),
                            intercept=torch.tensor(-2.0))
    eye = ScalerParams(mean=torch.zeros(D + k), scale=torch.ones(D + k), var=torch.ones(D + k),
                       n_samples=torch.tensor(1.0))
    champion = FraudLogisticModel(params, eye, KAGGLE + list(LEDGER_FEATURE_NAMES), device="cpu",
                                  ledger_spec=ps, ledger_state=init_state(64))
    e = env["torch"]
    fx, fy = _make_rows(200, rng)
    e.store.add_feedback(fx, np.full(200, 0.4, np.float32), fy,
                         entity_ids=[f"card-{i % 20}" for i in range(200)],
                         timestamps=[1e9 + i for i in range(200)])
    res = run_retrain(e.store, champion, 1, data_csv=env["csv"], use_smote=False, max_iter=60,
                      tracking_client=e.client, device="cpu",
                      thresholds=tlc.GateThresholds(0.5, 1.0, 10.0, 32))
    ch = res.challenger
    assert ch.ledger_spec is not None and ch.scorer.n_features == D + k
    loaded = load_any_model(res.artifact_dir, device="cpu")
    assert loaded.ledger_spec.slots == 64
    for a, b in zip(loaded.ledger_state, ch.ledger_state):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "holdout_challenger_auc" in res.gate.metrics


def test_wide_retrain_matches_jax_one_by_one(env, monkeypatch):
    """WIDE_ENABLED under a narrow champion: both packages fit the wide
    challenger (JAX on a 1×8 model-axis mesh, the model-axis-invariant
    form of the 1×1 fit); the table, the coef and the intercept within
    1e-5, the same verdict; then the wide → wide retrain does too."""
    monkeypatch.setenv("WIDE_ENABLED", "1")
    monkeypatch.setenv("WIDE_BUCKETS", "1024")
    monkeypatch.setenv("MESH_MODEL_DEVICES", "8")
    rng = np.random.default_rng(4)
    fx, fy = _make_rows(200, rng)
    ents = [f"card-{i % 13}" if i % 3 else None for i in range(200)]
    for e in _both(env):
        e.store.add_feedback(fx, np.full(200, 0.3, np.float32), fy, entity_ids=ents)
    thr = {"jax": jlc.GateThresholds(0.10, 0.9, 5.0, 64),
           "torch": tlc.GateThresholds(0.10, 0.9, 5.0, 64)}
    champs = {"jax": env["jax"].champion, "torch": env["torch"].champion}
    for round_ in range(2):
        res = {}
        for name, fn, extra in (("jax", jax_run_retrain, {}),
                                ("torch", run_retrain, {"device": "cpu"})):
            e = env[name]
            res[name] = fn(e.store, champs[name], 1, data_csv=env["csv"], use_smote=False,
                           max_iter=60, thresholds=thr[name], tracking_client=e.client,
                           **extra)
        want, got = res["jax"].challenger, res["torch"].challenger
        assert got.wide_spec is not None and tuple(got.wide_spec) == tuple(want.wide_spec)
        np.testing.assert_allclose(got.wide_table.numpy(), np.asarray(want.wide_table),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.params.coef.numpy(), np.asarray(want.params.coef),
                                   rtol=0, atol=1e-5)
        assert float(got.params.intercept) == pytest.approx(float(want.params.intercept),
                                                            abs=1e-5)
        assert res["torch"].gate.passed == res["jax"].gate.passed
        assert res["torch"].gate.metrics["holdout_challenger_auc"] == pytest.approx(
            res["jax"].gate.metrics["holdout_challenger_auc"], abs=1e-5)
        # round 2: the wide challengers become the champions (wide → wide)
        champs = {"jax": jax_load_any_model(res["jax"].artifact_dir),
                  "torch": load_any_model(res["torch"].artifact_dir, device="cpu")}


# ---------------------------------------------------------------------------
# the conductor, case for case
# ---------------------------------------------------------------------------


def _aliases(e):
    return (e.registry.get_version_by_alias("fraud", "prod"),
            e.registry.get_version_by_alias("fraud", "shadow"))


def _run_to_shadowing(env) -> dict:
    _feed([e.store for e in _both(env)], env["rng"], n=512)
    outs = {}
    for name in SIDES:
        out = env[name].conductor.handle_retrain("drift: promote path")
        assert out["outcome"] == "gated", out
        outs[name] = out["version"]
    return outs


def test_retrain_gate_pass_registers_shadow_with_lineage(env):
    v2 = _run_to_shadowing(env)
    assert v2["torch"] == v2["jax"] == env["torch"].v1 + 1
    for e in _both(env):
        assert _aliases(e) == (e.v1, v2["torch"])
        meta = e.registry.get_meta("fraud", v2["torch"])
        assert meta["lineage"]["parent_version"] == e.v1
        assert meta["lineage"]["trained_by"] == "conductor"
        assert meta["lineage"]["gate"]["passed"] is True
        assert meta["lineage"]["feedback_window_rows"] == 512
        assert e.store.get_state("fraud")["state"] == "shadowing"
    import os

    assert os.path.exists(os.path.join(
        env["torch"].registry.artifact_dir("fraud", v2["torch"]), "monitor_profile.npz"))


def test_retrain_latch_drops_duplicate_episodes(env):
    for e in _both(env):
        assert e.store.transition("fraud", ("idle",), "retraining")
        assert e.conductor.handle_retrain("duplicate trigger") == {
            "outcome": "skipped", "state": "retraining"}


def test_gate_failure_rolls_back_without_registering(env):
    _feed([e.store for e in _both(env)], env["rng"], n=300)
    outs = []
    for e in _both(env):
        e.conductor.retrain_kwargs["thresholds"] = e.side.lc.GateThresholds(
            auc_margin=-0.5, ece_bound=0.5, psi_bound=2.0, min_eval_rows=64)
        out = e.conductor.handle_retrain("drift: doomed episode")
        assert out["outcome"] == "gate_failed"
        assert any("AUC" in r for r in out["reasons"])
        state = e.store.get_state("fraud")
        assert state["state"] == "rolled_back" and "gate failed" in state["reason"]
        assert _aliases(e) == (e.v1, None)
        assert e.registry.latest_version("fraud") == e.v1
        assert e.store.transition("fraud", ("rolled_back",), "retraining")
        outs.append(_strip_numbers(out["reasons"]))
    assert outs[0] == outs[1]


def test_retrain_without_champion_fails_cleanly(tmp_path):
    for name, side in SIDES.items():
        store = side.lc.LifecycleStore(f"sqlite:///{tmp_path}/{name}.db")
        conductor = side.lc.Conductor(
            store=store, tracking_client=side.client(f"file:{tmp_path}/{name}/mlruns"),
            **side.kw)
        assert conductor.handle_retrain("no champion yet")["outcome"] == "failed"
        assert store.get_state("fraud")["state"] == "rolled_back"
        store.close()


def test_promote_flips_alias_and_rollback_restores(env):
    v2 = _run_to_shadowing(env)["torch"]
    for e in _both(env):
        promoted = []
        e.conductor.on_promote = promoted.append
        out = e.conductor.handle_promote("watchtower: promote_challenger")
        assert out == {"outcome": "promoted", "version": v2, "prior": e.v1}
        assert _aliases(e) == (v2, None)
        assert e.store.get_state("fraud")["state"] == "done"
        assert promoted == [v2]
        out = e.conductor.handle_rollback("operator rollback")
        assert out == {"outcome": "rolled_back", "restored": e.v1}
        assert _aliases(e) == (e.v1, None)
        assert e.store.get_state("fraud")["state"] == "rolled_back"


def test_promote_requires_shadowing_unless_forced(env):
    v2 = _run_to_shadowing(env)["torch"]
    for e in _both(env):
        e.store.set_state("fraud", "idle")
        assert e.conductor.handle_promote("not shadowing")["outcome"] == "skipped"
        assert _aliases(e)[0] == e.v1
        assert e.conductor.handle_promote("manual override", force=True)["outcome"] == "promoted"
        assert _aliases(e)[0] == v2


def test_rollback_while_shadowing_drops_challenger_only(env):
    v2 = _run_to_shadowing(env)["torch"]
    for e in _both(env):
        assert _aliases(e) == (e.v1, v2)
        out = e.conductor.handle_rollback("watchtower: rollback_challenger")
        assert out == {"outcome": "rolled_back", "restored": None}
        assert _aliases(e) == (e.v1, None)


def test_resume_does_not_hijack_live_retraining_episode(tmp_path, monkeypatch):
    outs = []
    for name, side in SIDES.items():
        store = side.lc.LifecycleStore(f"sqlite:///{tmp_path}/{name}.db")
        assert store.transition("fraud", ("idle",), "retraining", owner="live-worker",
                                reason="legit episode")
        conductor = side.lc.Conductor(
            store=store, tracking_client=side.client(f"file:{tmp_path}/{name}/mlruns"),
            **side.kw)
        monkeypatch.delenv("LIFECYCLE_RETRAIN_STALE_AFTER_S", raising=False)
        assert conductor.resume() is None
        state = store.get_state("fraud")
        assert (state["state"], state["owner"]) == ("retraining", "live-worker")
        monkeypatch.setenv("LIFECYCLE_RETRAIN_STALE_AFTER_S", "0")
        out = conductor.resume()
        outs.append(out["outcome"])
        assert store.get_state("fraud")["state"] == "rolled_back"
        store.close()
    assert outs == ["failed", "failed"]


def test_crash_resume_mid_gated_restores_shadow_alias(env):
    v2 = _run_to_shadowing(env)["torch"]
    for e in _both(env):
        e.registry.delete_alias("fraud", "shadow")
        e.store.set_state("fraud", "gated", challenger_version=v2, champion_version=e.v1)
        assert e.conductor.resume() == {"outcome": "resumed_shadowing", "version": v2}
        assert _aliases(e) == (e.v1, v2)
        assert e.store.get_state("fraud")["state"] == "shadowing"


#: every named fault point of the conductor, and the step that reaches it
FIRE_POINTS = {
    "conductor.gated.pre_alias": "retrain",
    "conductor.promoting.pre_alias": "promote",
    "conductor.promoting.mid_alias": "promote",
    "conductor.promoting.pre_finalize": "promote",
    "conductor.rolling_back.pre_alias": "rollback",
}


@pytest.mark.parametrize("point", sorted(FIRE_POINTS))
def test_crash_resume_exactly_once_at_every_fault_point(env, point):
    """A FaultPlan kills the process at ``point``; a fresh conductor's
    resume() converges the episode exactly once (a second resume is a
    no-op), with the same outcome, aliases and state on both packages."""
    step = FIRE_POINTS[point]
    if step == "retrain":
        _feed([e.store for e in _both(env)], env["rng"], n=512)
    else:
        _run_to_shadowing(env)
    finals = []
    for name in SIDES:
        e = env[name]
        if step == "rollback":
            assert e.conductor.handle_promote("go")["outcome"] == "promoted"
        plan = e.side.faults.FaultPlan().kill(point)
        with plan.armed():
            with pytest.raises(e.side.faults.ReplicaKilled):
                {"retrain": lambda: e.conductor.handle_retrain("drift"),
                 "promote": lambda: e.conductor.handle_promote("go"),
                 "rollback": lambda: e.conductor.handle_rollback("bad")}[step]()
        assert plan.fired(point) == 1
        reborn = e.side.lc.Conductor(
            store=e.side.lc.LifecycleStore(e.url), tracking_client=e.client, **e.side.kw)
        out = reborn.resume()
        assert out is not None
        assert reborn.resume() is None  # parked: nothing to redo
        finals.append((out, _aliases(e), reborn.store.get_state("fraud")["state"]))
        reborn.store.close()
    assert finals[1] == finals[0]
    expect = {"retrain": "shadowing", "promote": "done", "rollback": "rolled_back"}[step]
    assert finals[1][2] == expect


def test_record_feedback_exports_the_pool_gauges(env):
    from fraud_detection_tpu_torch.service import metrics

    x, y = _make_rows(40, env["rng"])
    assert env["torch"].conductor.record_feedback(x, np.full(40, 0.5), y) == 40
    assert metrics.lifecycle_feedback_rows.get("window") == 40
    status = env["torch"].conductor.status()
    assert status["prod_version"] == env["torch"].v1 and status["feedback"]["seen"] == 40
