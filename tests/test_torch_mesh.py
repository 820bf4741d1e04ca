"""The serving mesh on the port against the JAX package's
(``fraud_detection_tpu/{parallel,mesh,ledger/placement}``): the grid's size
resolution, the hash-mod-shard placement, the sharded flushes (plain, int8
wire, explain, ledger, wide on a model axis of 1) against JAX's
``shard_map`` programs, the shard-axis flush bitwise its per-shard loop and
the merged ledger bitwise a single-device replay, the shard front case for
case with ``tests/test_mesh.py``, the mesh metrics, the merged flight
recorder and the app's ``/mesh/status`` and ``/admin/shard/drain`` against
the JAX app's answers.

JAX runs on the 8 virtual CPU devices ``tests/conftest.py`` forces."""

import asyncio
import dataclasses
import os
import json
import shutil
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fraud_detection_tpu.ledger.placement import shard_placement as jax_placement
from fraud_detection_tpu.ledger.state import LedgerSpec as JaxLedgerSpec
from fraud_detection_tpu.mesh.shardflush import MeshDriftMonitor as JaxMesh
from fraud_detection_tpu.mesh.topology import serving_mesh as jax_serving_mesh
from fraud_detection_tpu.mesh.topology import serving_mesh_size as jax_mesh_size
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile as jax_profile
from fraud_detection_tpu.monitor.baseline import save_profile as jax_save_profile
from fraud_detection_tpu.ops.crosses import CrossSpec as JaxCrossSpec
from fraud_detection_tpu.ops.crosses import widen_scaler as jax_widen_scaler
from fraud_detection_tpu.ops.crosses import widen_with_crosses as jax_widen
from fraud_detection_tpu.ops.gbt import GBTConfig, gbt_fit
from fraud_detection_tpu.ops.logistic import LogisticParams as JaxParams
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu.ops.scorer import BatchScorer as JaxScorer
from fraud_detection_tpu.ops.scorer import WideBatchScorer as JaxWideScorer
from fraud_detection_tpu.ops.scorer import _bucket as jax_bucket
from fraud_detection_tpu.ops.scorer import _raw_score_linear as jax_score
from fraud_detection_tpu.ops.tree_shap import build_tree_explainer as jax_tree_explainer
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu_torch.convert import (
    gbt_from_arrays,
    params_from_jax_arrays,
    profile_from_arrays,
    scaler_from_arrays,
    tree_explainer_from_arrays,
)
from fraud_detection_tpu_torch.ledger.placement import shard_placement
from fraud_detection_tpu_torch.ledger.state import LEDGER_K, LedgerSpec, host_state
from fraud_detection_tpu_torch.lifecycle.swap import ModelSlot
from fraud_detection_tpu_torch.mesh.front import (
    DEAD,
    DRAINING,
    HALF_OPEN,
    HEALTHY,
    NoHealthyShards,
    ShardFront,
)
from fraud_detection_tpu_torch.mesh.shardflush import (
    MeshDriftMonitor,
    ShardLoopMonitor,
    init_sharded_window,
    merge_window,
)
from fraud_detection_tpu_torch.mesh.topology import (
    MAX_FLUSH_SHARDS,
    serving_mesh,
    serving_mesh_model_size,
    serving_mesh_size,
)
from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
from fraud_detection_tpu_torch.parallel import mesh as pmesh
from fraud_detection_tpu_torch.monitor.watchtower import Thresholds, Watchtower
from fraud_detection_tpu_torch.ops.crosses import CrossSpec
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scorer import (
    BatchScorer,
    GBTBatchScorer,
    _bucket,
    _raw_score_linear,
)
from fraud_detection_tpu_torch.parallel import (
    MeshSpec,
    batch_sharding,
    create_mesh,
    global_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from fraud_detection_tpu_torch.range import faults
from fraud_detection_tpu_torch.service import binlane, metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import Request, TestClient
from fraud_detection_tpu_torch.service.microbatch import (
    AdmissionFull,
    IngestBlock,
    MicroBatcher,
)
from fraud_detection_tpu_torch.telemetry import (
    FlightRecorder,
    RecorderSet,
    RequestTimeline,
    compile_sentinel,
    roofline,
    slo,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 30
K = 3
NAMES = [f"f{i}" for i in range(D)]
#: one flush's scores and attributions across the packages, windows after
#: decayed folds (tests/test_torch_monitor.py)
SCORE_ATOL = VAL_ATOL = 1e-6
WIN_TOL = 1e-5
#: the ledger's floats across the packages (ROADMAP queue 3)
LEDGER_TOL = 1e-5
NEVER = Thresholds(5.0, 5.0, 5.0, 1.0, 10**9)


def _mesh(n):
    return serving_mesh(n, devices=["cpu"])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4096, D)) * 2.0 + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def linear(data):
    """(JAX scorer factory, port scorer factory) over the same weights and
    a scaler fitted on the rows (so the int8 lattice covers them)."""
    rng = np.random.default_rng(0)
    jp = JaxParams(coef=rng.standard_normal(D).astype(np.float32) * 0.3,
                   intercept=np.float32(-1.0))
    js = jax_scaler_fit(data)
    tp = params_from_jax_arrays({k: np.asarray(v) for k, v in jp._asdict().items()})
    ts = scaler_from_arrays({k: np.asarray(v) for k, v in js._asdict().items()})
    return (lambda wire: JaxScorer(jp, js, io_dtype=wire),
            lambda wire: BatchScorer(tp, ts, io_dtype=wire, device="cpu"))


@pytest.fixture(scope="module")
def profiles(data, linear):
    s = np.asarray(linear[0]("float32").predict_proba(data)).reshape(-1)
    p = jax_profile(data, s, feature_names=NAMES)
    return p, profile_from_arrays(p.__dict__)


def _jax_flush(scorer, mon, rows, k=0):
    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(jax_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_rows(slot, list(rows))
        out = mon.fused_flush(
            jnp.asarray(hx), jnp.asarray(slot.valid), n, spec.score_args, spec.score_fn,
            dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
            explain_args=spec.explain_args if k else None, explain_k=k,
        )
        return tuple(np.asarray(o)[:n] for o in (out if isinstance(out, tuple) else (out,)))
    finally:
        scorer.staging.release(slot)


def _port_flush(scorer, mon, rows, k=0):
    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, [(r,) for r in rows])
        out = mon.fused_flush(
            scorer.to_device(hx), scorer.to_device(slot.valid), n,
            spec.score_args, spec.score_fn, dequant_scale=spec.dequant_scale,
            score_codes=spec.score_codes,
            explain_args=spec.explain_args if k else None, explain_k=k,
        )
        return tuple(o.numpy()[:n].copy() for o in (out if isinstance(out, tuple) else (out,)))
    finally:
        scorer.staging.release(slot)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


# ---------------------------------------------------------------------------
# the grid, its layouts, the placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("requested", range(21))
def test_serving_mesh_size_equals_jax(requested):
    """JAX clamps to its 8 virtual devices and to MAX_FLUSH_SHARDS; the
    port's virtual shards only to the latter: the same answer for every
    request (ROADMAP queue 3)."""
    assert serving_mesh_size(requested) == jax_mesh_size(requested)


def test_serving_mesh_shapes_and_refusals(monkeypatch):
    for n in (1, 2, 4, 8):
        mesh = _mesh(n)
        assert mesh.size == n == jax_serving_mesh(n).devices.size
        assert mesh.shape == {"data": n, "model": 1} and mesh.device.type == "cpu"
    for bad in (3, 16):
        with pytest.raises(ValueError):
            _mesh(bad)
        with pytest.raises(ValueError):
            jax_serving_mesh(bad)
    # the accepted 2-D grids, as JAX's
    for n, m in ((2, 2), (4, 2), (2, 4), (1, 8)):
        mesh = serving_mesh(n, devices=["cpu"], model_devices=m)
        assert mesh.shape == {"data": n, "model": m} == dict(jax_serving_mesh(n, model_devices=m).shape)
        assert [mesh.flat_index(d, k) for d in range(n) for k in range(m)] == list(range(n * m))
    # the refusals that remain: a model axis not a power of two, an explicit
    # grid above the smallest bucket, a model axis spanning processes
    for n, m in ((2, 3), (4, 4), (1, 16)):
        with pytest.raises(ValueError):
            serving_mesh(n, devices=["cpu"], model_devices=m)
        with pytest.raises(ValueError):
            jax_serving_mesh(n, model_devices=m)
    monkeypatch.setenv("MESH_MODEL_DEVICES", "6")
    with pytest.raises(ValueError, match="power of two"):
        serving_mesh_model_size()
    monkeypatch.setenv("MESH_MODEL_DEVICES", "4")
    assert serving_mesh_model_size() == 4
    monkeypatch.setattr(pmesh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="model axis stays inside a process"):
        global_mesh(MeshSpec(data=1, model=2), "cpu")
    assert global_mesh(MeshSpec(data=4, model=2), "cpu").shape == {"data": 2, "model": 2}
    monkeypatch.setattr(pmesh, "process_count", lambda: 1)
    # the knobs' grid clamps its data axis to stay within 8 shards, as JAX's
    monkeypatch.setenv("MESH_FLUSH_DEVICES", "8")
    assert _mesh(None).shape == {"data": 2, "model": 4} == dict(jax_serving_mesh().shape)
    monkeypatch.setenv("MESH_MODEL_DEVICES", "1")
    assert serving_mesh_model_size() == 1
    monkeypatch.setenv("MESH_FLUSH_DEVICES", "6")
    assert _mesh(None).size == 4
    # one device repeated is a grid; two distinct devices are a process a
    # card, joined by initialize_distributed
    assert create_mesh(MeshSpec(data=0), devices=["cpu"] * 4).shape["data"] == 4
    with pytest.raises(NotImplementedError, match="initialize_distributed"):
        create_mesh(devices=["cpu", "meta"])
    with pytest.raises(ValueError):
        create_mesh(MeshSpec(data=3), devices=["cpu"] * 4)


def test_shard_axis_layouts():
    mesh = _mesh(4)
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    padded, n = pad_to_multiple(x, 4)
    assert padded.shape == (12, 3) and n == 10 and not padded[10:].any()
    t, n = shard_batch(x, mesh)
    assert tuple(t.shape) == (12, 3) and n == 10
    seg = batch_sharding(mesh).segments(t)
    assert tuple(seg.shape) == (4, 3, 3) and torch.equal(seg[1], t[3:6])
    assert replicated(mesh).segments(t) is t
    tp, n = pad_to_multiple(torch.ones(5, 2), 8)
    assert tuple(tp.shape) == (8, 2) and n == 5 and float(tp.sum()) == 10.0
    with pytest.raises(ValueError):
        batch_sharding(mesh).segments(torch.zeros(6, 2))


def _placement_mix(kind, seed):
    rng = np.random.default_rng(seed)
    n = 50 + 13 * seed
    if kind == "skewed":  # most rows on one entity: a bumped bucket
        slots = np.where(rng.random(n) < 0.7, 12, rng.integers(0, 512, n)).astype(np.int64)
        has = np.ones(n, bool)
    elif kind == "entity_less":
        slots, has = np.zeros(n, np.int64), np.zeros(n, bool)
    else:
        slots = rng.integers(0, 512, n).astype(np.int64)
        has = rng.random(n) < 0.8
    return slots, has


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("kind", ["skewed", "entity_less", "mixed"])
def test_shard_placement_equals_jax(kind, n_shards):
    for seed in range(3):
        slots, has = _placement_mix(kind, seed)
        bucket, pos = shard_placement(slots, has, n_shards, min_bucket=8)
        jb, jpos = jax_placement(slots.astype(np.int32), has, n_shards, min_bucket=8)
        assert bucket == jb and np.array_equal(pos, jpos)
        seg = bucket // n_shards
        assert len(set(pos.tolist())) == len(slots)
        for i in np.flatnonzero(has):
            assert pos[i] // seg == slots[i] % n_shards
    if kind == "skewed":
        assert bucket > _bucket(len(slots), 8)  # the skew bumped the bucket


def test_placed_staging_lands_each_row_at_its_position(data, linear):
    """``stage_items_placed`` (single rows and a block) and
    ``stage_rows_placed`` stage the same bucket: each row at its position,
    valid 1 there and 0 on the padding, the wire encoded once."""
    scorer = linear[1]("int8")
    slots, has = _placement_mix("mixed", 1)
    bucket, pos = shard_placement(slots, has, 4, min_bucket=8)
    n = len(slots)
    rows = data[:n]
    a, b = scorer.staging.acquire(bucket), scorer.staging.acquire(bucket)
    try:
        items = [(rows[i], None) for i in range(n - 10)] + [(rows[n - 10:], None)]
        ha = scorer.stage_items_placed(a, items, pos)
        hb = scorer.stage_rows_placed(b, list(rows), pos)
        assert _bits(ha) == _bits(hb) and _bits(a.valid) == _bits(b.valid)
        assert _bits(a.f32[pos]) == _bits(rows) and a.valid.sum() == n
        pad = np.setdiff1d(np.arange(bucket), pos)
        assert not a.f32[pad].any() and not a.valid[pad].any()
    finally:
        scorer.staging.release(a)
        scorer.staging.release(b)


# ---------------------------------------------------------------------------
# the sharded flushes against JAX's shard_map programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("explain_k", [0, K])
@pytest.mark.parametrize("wire", ["float32", "int8"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_flush_matches_jax(data, linear, profiles, n_shards, wire, explain_k):
    """Two flushes (37 and 200 rows): scores within 1e-6, reason indices
    equal and values within 1e-6, the per-shard windows within 1e-5 after
    decayed folds."""
    jprof, pprof = profiles
    jsc, psc = linear[0](wire), linear[1](wire)
    jm = JaxMesh(jprof, jax_serving_mesh(n_shards), halflife_rows=500.0)
    pm = MeshDriftMonitor(pprof, _mesh(n_shards), halflife_rows=500.0)
    for lo, n in ((0, 37), (100, 200)):
        rows = data[lo:lo + n]
        want = _jax_flush(jsc, jm, rows, explain_k)
        got = _port_flush(psc, pm, rows, explain_k)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SCORE_ATOL)
        if explain_k:
            np.testing.assert_array_equal(got[1].astype(np.int64), want[1].astype(np.int64))
            np.testing.assert_allclose(got[2], want[2], rtol=0, atol=VAL_ATOL)
    for jt, pt in zip(jm.shard_window, pm.shard_window.tensors()):
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=WIN_TOL, atol=WIN_TOL)
    assert pm.stats()["window_rows"] == pytest.approx(jm.stats()["window_rows"], rel=1e-6)


def _monitors(profile, n_shards, halflife=float("inf")):
    """The shard-axis monitor, its per-shard loop and the single window."""
    mesh = _mesh(n_shards)
    return (MeshDriftMonitor(profile, mesh, halflife_rows=halflife),
            ShardLoopMonitor(profile, mesh, halflife_rows=halflife),
            DriftMonitor(profile, halflife_rows=halflife, device="cpu"))


@pytest.mark.parametrize("explain_k", [0, K])
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_axis_flush_is_the_shard_loop(data, linear, profiles, n_shards, wire, explain_k):
    """Bitwise: the shard-axis flush's scores and reason codes are the
    per-shard loop's and the single window's; its per-shard windows are the
    loop's; merged, they are the single window at an infinite half-life."""
    psc = linear[1](wire)
    sharded, loop, single = _monitors(profiles[1], n_shards)
    for lo, n in ((0, 5), (40, 64), (300, 700)):
        outs = [_port_flush(psc, m, data[lo:lo + n], explain_k) for m in (sharded, loop, single)]
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                assert _bits(a) == _bits(b)
    for a, b in zip(sharded.shard_window.tensors(), loop.shard_window.tensors()):
        assert _bits(a) == _bits(b)
    for a, b in zip(sharded._window_for_stats().tensors(), single.window.tensors()):
        assert _bits(a) == _bits(b)
    assert sharded.stats() == single.stats()


def test_decayed_merge_tracks_the_single_window(data, linear, profiles):
    """With a finite half-life the merge reassociates decayed sums: within
    1e-5 relative of the single window."""
    psc = linear[1]("float32")
    sharded, _, single = _monitors(profiles[1], 4, halflife=500.0)
    for lo, n in ((0, 200), (200, 200), (600, 37)):
        _port_flush(psc, sharded, data[lo:lo + n])
        _port_flush(psc, single, data[lo:lo + n])
    for a, b in zip(sharded._window_for_stats().tensors(), single.window.tensors()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def forest(data):
    rng = np.random.default_rng(13)
    w = rng.standard_normal(D).astype(np.float32)
    y = (rng.random(len(data)) < 1.0 / (1.0 + np.exp(-(data @ w - 2.0)))).astype(np.float32)
    jf = gbt_fit(data[:1024], y[:1024], GBTConfig(n_trees=8, max_depth=3, n_bins=16))
    jexpl = jax_tree_explainer(jf, data[:32])
    tf = gbt_from_arrays({k: np.asarray(v) for k, v in jf._asdict().items()})
    texpl = tree_explainer_from_arrays(tf, np.asarray(jexpl.bg_table),
                                       np.asarray(jexpl.expected_value))
    sc = GBTBatchScorer(tf, explainer=texpl)
    s = sc.predict_proba(data)
    return sc, profile_from_arrays(jax_profile(data, s, feature_names=NAMES).__dict__)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_forest_explain_flush_is_the_shard_loop(data, forest, n_shards):
    """The forest's margin and its TreeSHAP reason codes are per row: the
    shard-axis flush is bitwise the per-shard loop and the single window."""
    sc, prof = forest
    sharded, loop, single = _monitors(prof, n_shards)
    for lo, n in ((0, 9), (50, 130)):
        outs = [_port_flush(sc, m, data[lo:lo + n], K) for m in (sharded, loop, single)]
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                assert _bits(a) == _bits(b)
    for a, b in zip(sharded.shard_window.tensors(), loop.shard_window.tensors()):
        assert _bits(a) == _bits(b)


# -- the ledger ----------------------------------------------------------------


def _ledger_specs(slots=256):
    kw = dict(n_base=D, slots=slots, halflife_s=500.0, amount_col=-1,
              null_features=np.zeros(LEDGER_K, np.float32))
    return JaxLedgerSpec(**kw), LedgerSpec(**kw)


def _ledger_batches(spec, n_batches=5, bs=64, skew=False, seed=1):
    rng = np.random.default_rng(seed)
    t = 1.0
    out = []
    for b in range(n_batches):
        x = rng.standard_normal((bs, D)).astype(np.float32)
        x[:, -1] = np.abs(x[:, -1]) * 50.0
        ents = [
            ("card-hot" if skew and b == 2 and i % 4 else f"card-{rng.integers(0, 40)}")
            if rng.random() < 0.85 else None
            for i in range(bs)
        ]
        slots, fps = np.zeros(bs, np.int64), np.zeros(bs, np.int64)
        has, ts = np.zeros(bs, np.float32), np.zeros(bs, np.float32)
        for i, e in enumerate(ents):
            if e is None:
                continue
            slots[i], fps[i] = spec.row_keys(e)
            has[i], ts[i] = 1.0, t
            t += 0.5
        out.append((x, slots, fps, ts, has))
    return out


def _ledger_profile(seed=1):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((2000, D + LEDGER_K)).astype(np.float32)
    return jax_profile(xw, rng.random(800).astype(np.float32),
                       feature_names=[f"f{i}" for i in range(D + LEDGER_K)])


def _placed(batch, n_shards):
    """The batch staged as the sharded ledger flush stages it, or as it is
    for one shard."""
    x, slots, fps, ts, has = batch
    n = x.shape[0]
    if n_shards == 1:
        return n, np.arange(n), (x, slots, fps, ts, has, np.ones(n, np.float32))
    bucket, pos = shard_placement(slots, has, n_shards, min_bucket=8)
    cols = [np.zeros((bucket, D), np.float32), np.zeros(bucket, np.int64),
            np.zeros(bucket, np.int64), np.zeros(bucket, np.float32),
            np.zeros(bucket, np.float32), np.zeros(bucket, np.float32)]
    for c, v in zip(cols, (x, slots, fps, ts, has, np.ones(n, np.float32))):
        c[pos] = v
    return bucket, pos, tuple(cols)


def _port_ledger_flush(mon, cols, n, coef, k=0):
    x, slots, fps, ts, has, valid = (torch.from_numpy(np.ascontiguousarray(c)) for c in cols)
    out = mon.fused_flush(
        x, valid, n, (torch.from_numpy(coef), torch.tensor(np.float32(0.1))),
        _raw_score_linear, ledger_rows=(slots, fps, ts, has),
        explain_args=(torch.from_numpy(coef), torch.zeros(D + LEDGER_K)) if k else None,
        explain_k=k,
    )
    return tuple(o.numpy() for o in (out if isinstance(out, tuple) else (out,)))


def test_sharded_ledger_flush_matches_jax():
    """N = 4, a skewed batch among them: scores and the merged table's
    floats within 1e-5, ``last_ts``, fingerprints and the counts equal."""
    jspec, pspec = _ledger_specs()
    jprof = _ledger_profile()
    coef = np.random.default_rng(3).standard_normal(D + LEDGER_K).astype(np.float32) * 0.2
    jm = JaxMesh(jprof, jax_serving_mesh(4), halflife_rows=1000.0)
    jm.bind_ledger(jspec)
    pm = MeshDriftMonitor(profile_from_arrays(jprof.__dict__), _mesh(4), halflife_rows=1000.0)
    pm.bind_ledger(pspec)
    for batch in _ledger_batches(pspec, skew=True):
        bucket, pos, cols = _placed(batch, 4)
        n = batch[0].shape[0]
        jx, jsl, jfp, jts, jh, jv = cols
        want = jm.fused_flush(
            jnp.asarray(jx), jnp.asarray(jv), n, (jnp.asarray(coef), jnp.float32(0.1)),
            jax_score, ledger_rows=(jnp.asarray(jsl.astype(np.int32)),
                                    jnp.asarray(jfp.astype(np.uint32)),
                                    jnp.asarray(jts), jnp.asarray(jh)),
        )
        got, = _port_ledger_flush(pm, cols, n, coef)
        np.testing.assert_allclose(got[pos], np.asarray(want)[pos], rtol=0, atol=LEDGER_TOL)
    jt, pt = jm.ledger_snapshot(), host_state(pm.ledger_snapshot())
    for name, a, b in zip(("acc", "last_ts", "fingerprint", "collisions", "evictions"), jt, pt):
        if name == "acc":
            np.testing.assert_allclose(b, np.asarray(a), rtol=LEDGER_TOL, atol=LEDGER_TOL)
        else:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


@pytest.mark.parametrize("explain_k", [0, K])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_merged_ledger_is_a_single_device_replay(n_shards, explain_k):
    """Bitwise: the placed shard-axis ledger flush's scores and reason codes
    are the single-device flush's on the unplaced batch and the per-shard
    loop's, its sub-tables the loop's, and the merged table the single
    table; the bound snapshot merges back to itself."""
    _, pspec = _ledger_specs()
    prof = profile_from_arrays(_ledger_profile().__dict__)
    coef = np.random.default_rng(3).standard_normal(D + LEDGER_K).astype(np.float32) * 0.2
    sharded, loop, single = _monitors(prof, n_shards, halflife=1000.0)
    for m in (sharded, loop, single):
        m.bind_ledger(pspec)
    for batch in _ledger_batches(pspec, skew=True):
        n = batch[0].shape[0]
        _, pos, cols = _placed(batch, n_shards)
        a = _port_ledger_flush(sharded, cols, n, coef, explain_k)
        b = _port_ledger_flush(loop, cols, n, coef, explain_k)
        _, _, cols1 = _placed(batch, 1)
        c = _port_ledger_flush(single, cols1, n, coef, explain_k)
        for x, y, z in zip(a, b, c):
            assert _bits(x) == _bits(y)
            assert _bits(x[pos]) == _bits(z)
    for x, y in zip(sharded.ledger, loop.ledger):
        assert _bits(x) == _bits(y)
    for x, y in zip(host_state(sharded.ledger_snapshot()), host_state(single.ledger_snapshot())):
        assert _bits(x) == _bits(y)
    assert sharded.ledger_stats() == single.ledger_stats()
    merged = host_state(sharded.ledger_snapshot())
    rebound = MeshDriftMonitor(prof, _mesh(n_shards))
    rebound.bind_ledger(pspec, merged)
    for x, y in zip(host_state(rebound.ledger_snapshot()), merged):
        assert _bits(x) == _bits(y)


# -- the wide family on a model axis of 1 --------------------------------------

WIDE_LOG2B = 10
C = 4


def _wide(x):
    rng = np.random.default_rng(24)
    coef = np.concatenate([rng.standard_normal(D).astype(np.float32) * 0.3,
                           np.ones(C, np.float32)])
    table = (np.random.default_rng(23).standard_normal(1 << WIDE_LOG2B) * 0.2).astype(np.float32)
    mean = x.mean(0).astype(np.float32)
    scale = (x.std(0) + 1e-6).astype(np.float32)
    from fraud_detection_tpu.ops.scaler import ScalerParams as JaxScaler

    js = jax_widen_scaler(JaxScaler(mean=mean, scale=scale, var=scale**2,
                                    n_samples=np.float32(len(x))), C)
    jspec = JaxCrossSpec(n_base=D, log2_buckets=WIDE_LOG2B, amount_col=D - 1, time_col=0)
    pspec = CrossSpec(n_base=D, log2_buckets=WIDE_LOG2B, amount_col=D - 1, time_col=0)
    jsc = JaxWideScorer(JaxParams(coef=coef, intercept=np.float32(-1.0)), js, jspec, table)
    psc = BatchScorer(
        LogisticParams(torch.from_numpy(coef), torch.tensor(np.float32(-1.0))),
        scaler_from_arrays({f: np.asarray(getattr(js, f)) for f in js._fields}),
        device="cpu", wide_spec=pspec, wide_table=table,
    )
    f = np.random.default_rng(22).integers(1, 1 << 32, len(x), dtype=np.uint64).astype(np.uint32)
    f[:16] = 0
    xw = jax_widen(x, f, table, jspec)
    jprof = jax_profile(xw, np.asarray(jsc.predict_proba(xw)),
                        feature_names=NAMES + [f"c{i}" for i in range(C)])
    return jsc, psc, f, jprof


def _wide_flush(scorer, mon, rows, fps, k, jax_side):
    n = len(rows)
    spec = scorer.fused_spec()
    bucket = (jax_bucket if jax_side else _bucket)(n, scorer.min_bucket)
    slot = scorer.staging.acquire(bucket)
    try:
        if jax_side:
            hx = scorer.stage_rows(slot, list(rows))
            slot.ensure_ledger()
            slot.lf[:] = 0
            slot.lh[:] = 0.0
            slot.lf[:n] = fps
            slot.lh[:n] = (fps != 0).astype(np.float32)
            x, v = jnp.asarray(hx), jnp.asarray(slot.valid)
            wrows = (jnp.asarray(slot.lf), jnp.asarray(slot.lh))
        else:
            items = [(rows[i], None, None, (0, int(fps[i]), 0.0) if fps[i] else None)
                     for i in range(n)]
            hx = scorer.stage_items(slot, items)
            wrows = MicroBatcher._stage_wide(scorer, slot, items)
            x, v = scorer.to_device(hx), scorer.to_device(slot.valid)
        out = mon.fused_flush(
            x, v, n, spec.score_args, spec.score_fn, dequant_scale=spec.dequant_scale,
            score_codes=spec.score_codes, explain_args=spec.explain_args if k else None,
            explain_k=k, wide_args=spec.wide, wide_rows=wrows,
        )
        return [np.asarray(o)[:n].copy() for o in (out if isinstance(out, tuple) else (out,))]
    finally:
        scorer.staging.release(slot)


@pytest.mark.parametrize("explain_k", [0, K])
def test_wide_flush_on_model_axis_1_matches_jax(data, explain_k):
    """N = 4 on a model axis of 1: scores within 1e-6, reason indices equal,
    the windows' whole counts equal at an infinite half-life; and bitwise
    the per-shard loop."""
    x = data.copy()
    x[:, 0] = np.abs(x[:, 0]) * 40_000
    x[:, -1] = np.abs(x[:, -1]) * 150
    jsc, psc, f, jprof = _wide(x)
    pprof = profile_from_arrays(dataclasses.asdict(jprof))
    jm = JaxMesh(jprof, jax_serving_mesh(4, model_devices=1), halflife_rows=float("inf"))
    sharded, loop, _ = _monitors(pprof, 4)
    off = 0
    for n in (64, 200, 8):
        rows, fps = x[100 + off:100 + off + n], f[off:off + n].copy()
        off += n
        want = _wide_flush(jsc, jm, rows, fps, explain_k, True)
        got = _wide_flush(psc, sharded, rows, fps, explain_k, False)
        ref = _wide_flush(psc, loop, rows, fps, explain_k, False)
        np.testing.assert_allclose(got[0], want[0].astype(np.float32), rtol=0, atol=SCORE_ATOL)
        if explain_k:
            np.testing.assert_array_equal(got[1].astype(np.int64), want[1].astype(np.int64))
        for a, b in zip(got, ref):
            assert _bits(a) == _bits(b)
    for jt, pt in zip(jm.shard_window, sharded.shard_window.tensors()):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


# -- the monitor ---------------------------------------------------------------


def test_hot_swap_rebind_keeps_the_mesh(profiles):
    """A promotion's ``rebind_champion`` builds the new champion's monitor
    on the same mesh (a fresh per-shard window), as JAX's watchtower does."""
    wt = Watchtower(profiles[1], thresholds=NEVER, mesh=_mesh(4))
    try:
        first = wt.drift
        wt.rebind_champion(profiles[1])
        assert isinstance(wt.drift, MeshDriftMonitor) and wt.drift is not first
        assert wt.drift.n_shards == 4 and not wt.drift.shard_window.n_rows.any()
    finally:
        wt.close()


def test_feedback_replay_folds_into_mesh_calibration(data, linear, profiles):
    psc = linear[1]("float32")
    mm = MeshDriftMonitor(profiles[1], _mesh(2))
    _port_flush(psc, mm, data[:128])
    scores = psc.predict_proba(data[:64])
    mm.update(data[:64], scores, (scores > 0.5).astype(np.float32), calibration_only=True)
    st = mm.stats()
    assert st["n_labeled"] == pytest.approx(64, abs=1e-3)
    assert st["window_rows"] == pytest.approx(128, rel=1e-3)
    assert np.isfinite(st["ece"])


def test_merge_window_sums_shards():
    w = init_sharded_window(4, D, 16, 20, device="cpu")
    w.n_rows.copy_(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    merged = merge_window(w)
    assert float(merged.n_rows) == 10.0
    assert tuple(merged.feature_counts.shape) == (D, 16)


def test_warm_fused_leaves_sharded_window_untouched(data, linear, profiles):
    psc = linear[1]("float32")
    mm = MeshDriftMonitor(profiles[1], _mesh(4))
    _port_flush(psc, mm, data[:100])
    before = [t.clone() for t in mm.shard_window.tensors()]
    for b in (8, 64):
        mm.warm_fused(psc, b, explain_k=K)
    for a, b in zip(before, mm.shard_window.tensors()):
        assert torch.equal(a, b)


def test_mesh_monitor_rejects_shards_above_bucket_floor(profiles):
    with pytest.raises(ValueError, match="smallest flush bucket"):
        MeshDriftMonitor(profiles[1], _mesh(8), min_bucket=4)
    assert MAX_FLUSH_SHARDS == 8
    assert serving_mesh_size(16) == 8


def _batcher(scorer=None, slot=None, wt=None, **kw):
    kw = {"max_batch": 32, "max_wait_ms": 1.0, "telemetry": False, **kw}
    if slot is not None:
        return MicroBatcher(slot=slot, watchtower=wt, **kw)
    return MicroBatcher(scorer, watchtower=wt, **kw)


def test_mesh_flush_is_single_dispatch_through_microbatcher(data, linear, profiles):
    """The batcher's fused target is the mesh monitor: one shard-axis flush
    a batch, no split-path score or window update, device calls 1, and
    the compile sentinel notes the flush under ``mesh.sharded_flush``."""
    psc = linear[1]("float32")
    wt = Watchtower(profiles[1], thresholds=NEVER, mesh=_mesh(4))
    assert isinstance(wt.drift, MeshDriftMonitor)
    calls = {"sharded": 0, "split_score": 0, "split_update": 0}
    real = (MeshDriftMonitor.fused_flush, DriftMonitor.update, BatchScorer._score_padded)

    def spy(key, fn):
        def inner(self, *a, **k):
            calls[key] += 1
            return fn(self, *a, **k)
        return inner

    compile_sentinel.install()
    metrics.scorer_device_calls_per_flush.labels("0").set(0)

    async def run():
        mb = _batcher(psc, wt=wt, max_batch=64, fused=True)
        await mb.start()
        MeshDriftMonitor.fused_flush = spy("sharded", real[0])
        DriftMonitor.update = spy("split_update", real[1])
        BatchScorer._score_padded = spy("split_score", real[2])
        try:
            return await asyncio.gather(*(mb.score(data[i]) for i in range(48)))
        finally:
            MeshDriftMonitor.fused_flush, DriftMonitor.update, BatchScorer._score_padded = real
            await mb.stop()

    try:
        out = asyncio.run(run())
        assert any(ep == "mesh.sharded_flush" for ep, _ in roofline._costs)
    finally:
        compile_sentinel.uninstall()
        wt.close()
    assert len(out) == 48 and all(0.0 <= p <= 1.0 for p in out)
    np.testing.assert_allclose(out, psc.predict_proba(data[:48]), rtol=0, atol=1e-6)
    assert calls["sharded"] >= 1 and calls["split_score"] == 0 and calls["split_update"] == 0
    assert metrics.scorer_device_calls_per_flush.get("0") == 1
    assert wt.drift.rows_seen == 48


def test_ledger_batcher_places_rows_and_extends_the_ladder(profiles):
    """Through the micro-batcher: a skewed ledger batch is placed (its
    bucket bumped), the warm ladder reaches the shard factor, and the
    served table equals a single-window batcher's on the same items."""
    _, pspec = _ledger_specs(slots=64)
    prof = profile_from_arrays(_ledger_profile().__dict__)
    rng = np.random.default_rng(5)
    coef = rng.standard_normal(D + LEDGER_K).astype(np.float32) * 0.2
    scorer = BatchScorer(LogisticParams(torch.from_numpy(coef), torch.tensor(np.float32(0.1))),
                         device="cpu", ledger_spec=pspec)
    items = []
    for i in range(32):
        x = rng.standard_normal(D).astype(np.float32)
        s, fp = pspec.row_keys("hot" if i % 3 else f"c{i}")
        items.append((x, None, None, (s, fp, 10.0 + i) if i % 7 else None))

    def drive(mesh):
        wt = Watchtower(prof, thresholds=NEVER, device="cpu", mesh=mesh)
        wt.drift.bind_ledger(pspec)
        mb = _batcher(scorer, wt=wt, fused=True, explain=False)
        warmed = []
        real = wt.drift.warm_fused
        wt.drift.warm_fused = lambda sc, b, **kw: (warmed.append(b), real(sc, b, **kw))
        try:
            asyncio.run(mb.start())
            out = mb._flush_device(scorer, mb._fused_target(scorer), items)
            asyncio.run(mb.stop())
            scorer.staging.release(out[-1])
            return out[0].copy(), host_state(wt.drift.ledger_snapshot()), warmed
        finally:
            wt.close()

    s1, t1, w1 = drive(None)
    s4, t4, w4 = drive(_mesh(4))
    assert _bits(s1) == _bits(s4)
    for a, b in zip(t1, t4):
        assert _bits(a) == _bits(b)
    assert max(w4) == 4 * max(w1) == 128


# ---------------------------------------------------------------------------
# the shard front (tests/test_mesh.py, case for case)
# ---------------------------------------------------------------------------


def _front(n, scorer=None, slot=None, wt=None, max_errors=3, **kw):
    return ShardFront([_batcher(scorer, slot=slot, wt=wt) for _ in range(n)],
                      max_consecutive_errors=max_errors, **kw)


def test_front_balances_and_scores_correctly(data, linear):
    scorer = linear[1]("float32")

    async def run():
        front = _front(3, scorer=scorer)
        await front.start()
        out = await asyncio.gather(*(front.score(data[i]) for i in range(96)))
        status = front.status()
        await front.stop()
        return out, status

    out, status = asyncio.run(run())
    np.testing.assert_allclose(out, scorer.predict_proba(data[:96]), atol=1e-6)
    assert status["healthy"] == 3
    rows = [s["rows_total"] for s in status["per_shard"]]
    assert sum(rows) == 96
    assert all(r > 0 for r in rows), f"least-inflight left a shard idle: {rows}"


def test_front_sheds_load_off_dead_shard(data, linear):
    scorer = linear[1]("float32")

    def boom(shard=None, **_):
        if shard == 1:
            raise RuntimeError("injected shard fault")

    async def run():
        front = _front(3, scorer=scorer)
        await front.start()
        with faults.FaultPlan().call("mesh.shard_flush", boom, times=-1).armed():
            out = await asyncio.gather(*(front.score(data[i]) for i in range(64)))
        status = front.status()
        await front.stop()
        return out, status

    out, status = asyncio.run(run())
    assert len(out) == 64
    assert status["per_shard"][1]["state"] == DEAD
    assert status["healthy"] == 2
    assert status["per_shard"][1]["errors_total"] >= 3
    assert status["per_shard"][0]["rows_total"] + status["per_shard"][2]["rows_total"] == 64


def test_front_drain_and_revive(data, linear):
    scorer = linear[1]("float32")

    async def run():
        front = _front(2, scorer=scorer)
        await front.start()
        await asyncio.gather(*(front.score(data[i]) for i in range(16)))
        front.drain(0)
        assert front.wait_drained(0, timeout=5.0)
        assert front.shards[0].state == DRAINING
        before = front.shards[0].rows_total
        await asyncio.gather(*(front.score(data[i]) for i in range(16)))
        drained_rows = front.shards[0].rows_total - before
        front.revive(0)
        assert front.shards[0].state == HEALTHY
        await asyncio.gather(*(front.score(data[i]) for i in range(16)))
        revived_rows = front.shards[0].rows_total - before - drained_rows
        await front.stop()
        return drained_rows, revived_rows

    drained_rows, revived_rows = asyncio.run(run())
    assert drained_rows == 0, "draining shard still received traffic"
    assert revived_rows > 0, "revived shard received no traffic"


def test_front_refuses_to_drain_last_healthy_shard(data, linear):
    scorer = linear[1]("float32")

    async def run():
        front = _front(2, scorer=scorer)
        await front.start()
        try:
            front.drain(0)
            with pytest.raises(ValueError, match="last healthy shard"):
                front.drain(1)
            assert 0.0 <= await front.score(data[0]) <= 1.0
            front.revive(0)
            front.drain(1)  # legal again
        finally:
            await front.stop()

    asyncio.run(run())


def test_front_all_dead_raises(data, linear):
    scorer = linear[1]("float32")

    async def run():
        front = _front(2, scorer=scorer)
        await front.start()
        for h in front.shards:
            h.set_state(DEAD)
        front._refresh_health_gauge()
        try:
            with pytest.raises(NoHealthyShards):
                await front.score(data[0])
        finally:
            await front.stop()

    asyncio.run(run())


def test_front_half_open_probe_recovers_from_total_outage(data, linear):
    scorer = linear[1]("float32")
    revived = []

    async def run():
        front = _front(2, scorer=scorer, reopen_after=0.05, on_revive=revived.append)
        await front.start()
        try:
            for h in front.shards:
                h.set_state(DEAD)
                h.dead_since = time.monotonic() - 1.0
            front._refresh_health_gauge()
            assert 0.0 <= await front.score(data[0]) <= 1.0
            assert front.status()["healthy"] >= 1
            probe = next(h for h in front.shards if h.state == HEALTHY)
            assert probe.probation is False
            assert revived == [probe.shard_id]
            assert metrics.mesh_shards_healthy.get() == 1
        finally:
            await front.stop()

    asyncio.run(run())


def test_front_probation_shard_redies_on_first_failure(data, linear):
    scorer = linear[1]("float32")

    def boom(shard=None, **_):
        raise RuntimeError("still broken")

    async def run():
        front = _front(2, scorer=scorer, reopen_after=0.0)
        await front.start()
        try:
            for h in front.shards:
                h.set_state(DEAD)
                h.dead_since = time.monotonic() - 1.0
            front._refresh_health_gauge()
            with faults.FaultPlan().call("mesh.shard_flush", boom, times=-1).armed():
                with pytest.raises(RuntimeError, match="still broken"):
                    await front.score(data[0])
            for h in front.shards:
                assert h.state == DEAD and h.consecutive_errors == 1
        finally:
            await front.stop()

    asyncio.run(run())


def test_half_open_probe_is_single_request(linear):
    scorer = linear[1]("float32")

    async def run():
        front = _front(2, scorer=scorer)
        await front.start()
        try:
            a, b = front.shards
            a.set_state(HALF_OPEN)
            b.set_state(DEAD)
            b.dead_since = time.monotonic()
            front._refresh_health_gauge()
            with pytest.raises(NoHealthyShards):
                front.pick()
        finally:
            await front.stop()

    asyncio.run(run())


def test_front_sticky_entity_routing(linear):
    """An entity's rows prefer shard ``fingerprint mod N`` while it is
    healthy; availability beats stickiness."""
    front = _front(4, scorer=linear[1]("float32"))
    assert front.pick(entity=(3, 4 * 7 + 2, 1.0)).shard_id == 2
    front.drain(2)
    assert front.pick(entity=(3, 4 * 7 + 2, 1.0)).shard_id != 2
    assert front.pick(exclude={2}, entity=(0, 6, 0.0)).shard_id != 2


def test_front_hot_swap_shared_across_shards(data, linear, profiles):
    """One ModelSlot swap reaches every shard between flushes; no kernel
    library loads on the swap (the shared ladder was warmed)."""
    scorer_a = linear[1]("float32")
    rng = np.random.default_rng(1)
    scorer_b = BatchScorer(
        LogisticParams(torch.from_numpy(rng.standard_normal(D).astype(np.float32) + 0.5),
                       torch.tensor(np.float32(-1.0))), device="cpu",
    )
    wt = Watchtower(profiles[1], thresholds=NEVER, device="cpu")
    slot = ModelSlot(types.SimpleNamespace(scorer=scorer_a), "test:a", 1)
    compile_sentinel.install()
    base = metrics.xla_compiles.get("fastlane.flush")
    try:
        async def run():
            front = _front(3, slot=slot, wt=wt)
            await front.start()
            first = await asyncio.gather(*(front.score(data[i]) for i in range(32)))
            slot.swap(types.SimpleNamespace(scorer=scorer_b), "test:b", 2)
            second = await asyncio.gather(*(front.score(data[i]) for i in range(32)))
            await front.stop()
            return first, second

        first, second = asyncio.run(run())
    finally:
        compile_sentinel.uninstall()
        wt.close()
    np.testing.assert_allclose(first, scorer_a.predict_proba(data[:32]), atol=1e-6)
    np.testing.assert_allclose(second, scorer_b.predict_proba(data[:32]), atol=1e-6)
    assert metrics.xla_compiles.get("fastlane.flush") == base
    assert slot.version == 2


def _zero_mesh_series():
    for m in (metrics.mesh_shard_healthy, metrics.mesh_shard_inflight,
              metrics.mesh_shard_rows, metrics.mesh_shard_errors):
        m.clear()
    metrics.mesh_shards.set(0)
    metrics.mesh_shards_healthy.set(0)


def test_front_metrics_exported(data, linear):
    _zero_mesh_series()
    scorer = linear[1]("float32")

    def boom(shard=None, **_):
        if shard == 0:
            raise RuntimeError("injected")

    async def run():
        front = _front(2, scorer=scorer, max_errors=1)
        await front.start()
        with faults.FaultPlan().call("mesh.shard_flush", boom, times=1).armed():
            await front.score(data[0])
        await asyncio.gather(*(front.score(data[i]) for i in range(10)))
        await front.stop()

    asyncio.run(run())
    assert metrics.mesh_shards.get() == 2
    assert metrics.mesh_shards_healthy.get() == 1
    assert metrics.mesh_shard_healthy.get("0") == 0 and metrics.mesh_shard_healthy.get("1") == 1
    assert metrics.mesh_shard_errors.get("0") == 1
    assert metrics.mesh_shard_rows.get("1") == 11 and metrics.mesh_shard_inflight.get("1") == 0
    rendered = metrics.render().decode()
    for name in ("mesh_shards", "mesh_shards_healthy", "mesh_shard_healthy",
                 "mesh_shard_inflight", "mesh_shard_rows_total", "mesh_shard_errors_total"):
        assert name in rendered, f"{name} missing from the registry"


@pytest.fixture()
def fresh_slo(monkeypatch):
    monkeypatch.setenv("SLO_ENABLED", "1")
    slo._reset_for_tests()
    metrics.slo_requests.clear()
    yield
    slo._reset_for_tests()


def test_merged_flightrecorder_attributes_every_flush_to_its_shard(fresh_slo, data, linear):
    """Two shards, single rows and ingest blocks: every merged record names
    its shard, both shards appear, the rings stay bounded, the merge is
    newest first, and the per-shard flush counters and SLO series move."""
    scorer = linear[1]("float32")
    metrics.scorer_flushes.clear()
    recorders = [FlightRecorder(64), FlightRecorder(64)]
    merged = RecorderSet(recorders)
    front = ShardFront([
        MicroBatcher(scorer, max_batch=64, max_wait_ms=1.0, telemetry=True,
                     recorder=recorders[i], shard_id=i)
        for i in range(2)
    ])

    async def run():
        await front.start()
        try:
            await asyncio.gather(*(front.score(data[i], timeline=RequestTimeline(f"c{i}"))
                                   for i in range(40)))
            for k in range(6):
                slot = scorer.staging.acquire(64)
                try:
                    np.copyto(slot.f32[:16], data[100 + 16 * k:116 + 16 * k])
                    await front.score_block(IngestBlock(slot, 16),
                                            timeline=RequestTimeline(f"frame{k}"))
                finally:
                    scorer.staging.release(slot)
        finally:
            await front.stop()

    asyncio.run(run())
    dump = merged.dump()
    assert {rec["shard"] for rec in dump} == {0, 1}
    assert len(recorders[0]) <= 64 and len(recorders[1]) <= 64 and merged.capacity == 128
    ts = [rec["ts"] for rec in dump]
    assert ts == sorted(ts, reverse=True)
    assert merged.total_recorded == 46 and len(merged) <= 128
    text = metrics.render().decode()
    assert 'scorer_flushes_total{path="solo",shard="0"}' in text
    assert 'scorer_flushes_total{path="solo",shard="1"}' in text
    snap = slo.engine().snapshot()
    assert snap["availability:shard0"]["total_good"] > 0
    assert snap["availability:shard1"]["total_good"] > 0
    assert 'slo_requests_total{slo="availability:shard1",verdict="good"}' in text


def test_shard_death_drops_gauge_series_and_revive_rebinds(data, linear):
    scorer = linear[1]("float32")
    front = ShardFront([_batcher(scorer) for _ in range(2)])

    async def run():
        await front.start()
        try:
            for i in range(8):
                await front.score(data[i])
            assert 'scorer_queue_depth{shard="0"}' in metrics.render().decode()
            front.drain(0)
            text = metrics.render().decode()
            for g in ("scorer_queue_depth", "scorer_device_calls_per_flush",
                      "scorer_effective_wait_seconds", "scorer_admission_queue_rows"):
                assert f'{g}{{shard="0"}}' not in text
            assert 'scorer_queue_depth{shard="1"}' in text
            front.revive(0)
            front.drain(1)
            for i in range(8):
                await front.score(data[i])
            assert 'scorer_queue_depth{shard="0"}' in metrics.render().decode()
        finally:
            front.revive(1)
            await front.stop()

    asyncio.run(run())


def test_front_routes_blocks_and_hops_saturated_shards(data, linear):
    """A block lands whole on one shard; a shard at its admission bound is
    skipped without an error; all saturated sheds ``AdmissionFull``."""
    scorer = linear[1]("float32")
    front = ShardFront([_batcher(scorer, max_batch=64, admit_max_rows=64) for _ in range(2)])

    async def run():
        await front.start()
        try:
            slot = scorer.staging.acquire(64)
            np.copyto(slot.f32[:40], data[:40])
            front.shards[0].batcher._queued_rows = 60  # shard 0 saturated
            await front.score_block(IngestBlock(slot, 40))
            got = slot.scores[:40].copy()
            scorer.staging.release(slot)
            assert front.shards[0].rows_total == 0 and front.shards[1].rows_total == 40
            assert front.shards[0].errors_total == 0
            front.shards[1].batcher._queued_rows = 60
            slot = scorer.staging.acquire(64)
            with pytest.raises(AdmissionFull):
                await front.score_block(IngestBlock(slot, 40))
            scorer.staging.release(slot)
            for h in front.shards:
                h.batcher._queued_rows = 0
            return got
        finally:
            await front.stop()

    got = asyncio.run(run())
    assert _bits(got) == _bits(scorer.predict_proba(data[:40]))
    assert binlane.batcher_max_batch(front) == 64


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """models/ plus a monitor_profile.npz built from 2000 real rows."""
    d = str(tmp_path_factory.mktemp("mesh") / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    rows = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                      skiprows=1, max_rows=2000, dtype=np.float32)[:, :30]
    m = JaxModel.load(d)
    jax_save_profile(d, jax_profile(rows, np.asarray(m.scorer.predict_proba(rows)),
                                    feature_names=m.feature_names))
    return d, rows


@pytest.fixture()
def mesh_env(model_dir, tmp_path, monkeypatch):
    d, rows = model_dir
    for k, v in {
        "MODEL_PATH": os.path.join(d, "logistic_model.joblib"),
        "MLFLOW_TRACKING_URI": f"file:{tmp_path}/mlruns",
        "DATABASE_URL": f"sqlite:///{tmp_path}/fraud.db",
        "CELERY_BROKER_URL": f"sqlite:///{tmp_path}/taskq.db",
        "SCORER_EXPLAIN": "topk", "SCORER_MAX_BATCH": "64", "DEVICE": "cpu",
        "ADMIN_TOKEN": "s3cret", "MESH_SHARDS": "2", "MESH_FLUSH_DEVICES": "2",
        "MESH_SHARD_REOPEN_S": "30",
    }.items():
        monkeypatch.setenv(k, v)
    return rows


def _tx(row):
    return {"features": {n: float(v) for n, v in zip(
        ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"], row)}}


def _drive_admin(client, rows):
    """The same sequence through either app: status, predicts, bad bodies,
    a drain, the last-shard refusal, a revive, the token gate."""
    hdr = {"x-admin-token": "s3cret"}
    out = []

    def st():
        body = client.get("/mesh/status").json()
        for s in body.get("per_shard", []):
            s.pop("inflight")
        return body

    out.append(st())
    scores = [client.post("/predict", json=_tx(r)).json()["score"] for r in rows[:6]]
    for body in ({"shard": 7}, {"shard": 0, "action": "explode"}, {"action": "drain"}):
        r = client.post("/admin/shard/drain", json=body, headers=hdr)
        out.append(r.status_code)
    out.append(client.post("/admin/shard/drain", json={"shard": 0}).status_code)
    out.append(client.post("/admin/shard/drain", json={"shard": 0}, headers=hdr).json())
    out.append(client.post("/admin/shard/drain", json={"shard": 0}, headers=hdr).json())
    r = client.post("/admin/shard/drain", json={"shard": 1}, headers=hdr)
    out.append((r.status_code, "last healthy shard" in r.json()["detail"]))
    out.append(client.post("/admin/shard/drain", json={"shard": 0, "action": "revive"},
                           headers=hdr).json())
    s = st()
    out.append((s["healthy"], [p["state"] for p in s["per_shard"]]))
    return out, scores


def test_mesh_endpoints_answer_as_the_jax_app(mesh_env, tmp_path):
    """``/mesh/status`` and ``/admin/shard/drain`` (422, 401, drain, the
    idempotent drain, the 409 on the last healthy shard, revive) answer as
    the JAX app's; the scores of the two sharded apps agree within 1e-6;
    the port's watchtower holds a MeshDriftMonitor."""
    rows = mesh_env
    jax_app = jax_create_app(database_url=f"sqlite:///{tmp_path}/jfraud.db",
                             broker_url=f"sqlite:///{tmp_path}/jtaskq.db")
    with JaxClient(jax_app) as jc, TestClient(create_app()) as tc:
        want, jscores = _drive_admin(jc, rows)
        got, pscores = _drive_admin(tc, rows)
        assert isinstance(tc.app.state["watchtower"].drift, MeshDriftMonitor)
        assert tc.app.state["watchtower"].drift.n_shards == 2
        fr = tc.get("/debug/flightrecorder").json()
        assert fr["shards"] == 2
    assert got == want
    np.testing.assert_allclose(pscores, jscores, rtol=0, atol=1e-6)


def test_mesh_off_answers_as_the_jax_app(mesh_env, tmp_path, monkeypatch):
    monkeypatch.setenv("MESH_SHARDS", "0")
    monkeypatch.setenv("MESH_FLUSH_DEVICES", "0")
    jax_app = jax_create_app(database_url=f"sqlite:///{tmp_path}/jfraud.db",
                             broker_url=f"sqlite:///{tmp_path}/jtaskq.db")
    hdr = {"x-admin-token": "s3cret"}
    with JaxClient(jax_app) as jc, TestClient(create_app()) as tc:
        for c in (jc, tc):
            assert c.get("/mesh/status").json() == {"enabled": False, "shards": 0}
        assert (tc.post("/admin/shard/drain", json={"shard": 0}, headers=hdr).status_code
                == jc.post("/admin/shard/drain", json={"shard": 0}, headers=hdr).status_code
                == 409)
        assert not isinstance(tc.app.state["watchtower"].drift, MeshDriftMonitor)


def test_no_healthy_shards_answers_503_and_status_3(mesh_env, monkeypatch):
    """Every shard dead: ``/predict`` and ``/ingest/batch`` answer 503 with
    Retry-After (``MESH_SHARD_REOPEN_S``), the binary lane a status-3
    frame with that retry; a revive serves again. The app runs on a loop
    thread, as the HTTP server runs it, so the lane can reach it."""
    rows = mesh_env
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("INGEST_PORT", str(port))
    monkeypatch.setenv("INGEST_HOST", "127.0.0.1")
    app = create_app()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def call(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    def post(path, body, ctype="application/json"):
        return call(app.dispatch(Request("POST", path, {"content-type": ctype}, body)))

    predict = json.dumps(_tx(rows[0])).encode()
    try:
        call(app.startup())
        assert post("/predict", predict).status_code == 200
        front = app.state["batcher"]
        for h in front.shards:
            h.set_state(DEAD)
        r = post("/predict", predict)
        assert r.status_code == 503 and r.headers["retry-after"] == "30"
        assert r.json()["error"] == "no healthy scoring shards"
        r = post("/ingest/batch", binlane.encode_frame(rows[:4], length_prefix=False),
                 "application/x-fraud-frame")
        assert r.status_code == 503 and r.headers["retry-after"] == "30"
        with binlane.BinLaneClient("127.0.0.1", port) as cli:
            with pytest.raises(binlane.LaneBusy) as e:
                cli.score_batch(rows[:4])
            assert e.value.status == binlane.ST_UNAVAILABLE
            assert e.value.retry_after_s == 30.0
            for i in range(len(front.shards)):
                front.revive(i)
            scores, _ = cli.score_batch(rows[:4])
        assert post("/predict", predict).status_code == 200
        assert scores.shape == (4,)
        call(app.shutdown())
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=5.0)


def test_model_axis_of_2_serves_on_a_2x2_grid(mesh_env, monkeypatch):
    """``MESH_FLUSH_DEVICES=2 MESH_MODEL_DEVICES=2`` starts the app on a 2×2
    grid (as JAX's does): its monitor is the mesh monitor over 4 shards,
    ``/predict`` answers, the rows fold into the per-shard windows and
    ``/mesh/status`` stays the shard front's (``MESH_SHARDS=2``), naming
    no flush axis. A model axis
    that is not a power of two still fails the start-up."""
    monkeypatch.setenv("MESH_FLUSH_DEVICES", "2")
    monkeypatch.setenv("MESH_MODEL_DEVICES", "2")
    with TestClient(create_app()) as tc:
        assert tc.get("/health").status_code == 200
        drift = tc.app.state["watchtower"].drift
        assert isinstance(drift, MeshDriftMonitor)
        assert (drift.n_data, drift.n_model, drift.n_shards) == (2, 2, 4)
        r = tc.post("/predict", json=_tx(np.linspace(-1.0, 1.0, 30)))
        assert r.status_code == 200 and 0.0 <= r.json()["score"] <= 1.0
        assert float(drift.shard_window.n_rows.sum()) == 1.0
        status = tc.get("/mesh/status").json()
        assert status["enabled"] is True and status["shards"] == 2
        assert "model" not in json.dumps(status)
    monkeypatch.setenv("MESH_MODEL_DEVICES", "3")
    with TestClient(create_app()) as tc:
        with pytest.raises(ValueError, match="power of two"):
            tc.get("/health")
        assert tc.app.state["watchtower"] is None and tc.app.state["batcher"] is None

