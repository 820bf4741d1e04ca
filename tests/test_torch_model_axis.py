"""The model axis on the port against the JAX package's broadside
(``fraud_detection_tpu/{ops/crosses,mesh/shardflush,mesh/retrain}``,
``tests/test_broadside.py``): the model shard's partial gather under
``shard_map`` and the zero signs of the assembled block; the model-axis
collectives; the 2-D wide flush at 2×2, 4×2 and 2×4 bitwise the port's 1×1
flush and its per-data-shard loop, and against JAX's 2-D mesh; the narrow
and ledger families on a 2×2 grid; widebench's mechanism gates (table
bytes a model shard, zero-allocation staging); the 2-D ``wide_sgd_fit``
against JAX's and bitwise across the model axis; ``train(wide=True)`` and
the conductor's wide retrain on a model axis of 2; an app on a 2×2 grid
serving a wide and a ledger model as the 1×1 app does; and the one-shard
fits of ``train()`` (the unsharded graph).

JAX runs on the 8 virtual CPU devices ``tests/conftest.py`` forces."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fraud_detection_tpu.ledger.state import LedgerSpec as JaxLedgerSpec
from fraud_detection_tpu.lifecycle.gate import GateThresholds as JaxGate
from fraud_detection_tpu.lifecycle.retrain import run_retrain as jax_run_retrain
from fraud_detection_tpu.lifecycle.store import LifecycleStore as JaxStore
from fraud_detection_tpu.mesh.retrain import wide_sgd_fit as jax_wide_fit
from fraud_detection_tpu.mesh.shardflush import MeshDriftMonitor as JaxMesh
from fraud_detection_tpu.mesh.topology import serving_mesh as jax_serving_mesh
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile as jax_profile
from fraud_detection_tpu.ops.crosses import CrossSpec as JaxCrossSpec
from fraud_detection_tpu.ops.crosses import _gather_contrib as jax_gather
from fraud_detection_tpu.ops.crosses import _gather_contrib_shard as jax_gather_shard
from fraud_detection_tpu.ops.crosses import cross_indices as jax_cross_indices
from fraud_detection_tpu.ops.crosses import widen_scaler as jax_widen_scaler
from fraud_detection_tpu.ops.crosses import widen_with_crosses as jax_widen
from fraud_detection_tpu.ops.logistic import LogisticParams as JaxParams
from fraud_detection_tpu.ops.logistic import logistic_fit_lbfgs as jax_lbfgs
from fraud_detection_tpu.ops.scaler import ScalerParams as JaxScaler
from fraud_detection_tpu.ops.scaler import scaler_fit as jax_scaler_fit
from fraud_detection_tpu.ops.scaler import scaler_transform as jax_scaler_transform
from fraud_detection_tpu.ops.scorer import BatchScorer as JaxScorer
from fraud_detection_tpu.ops.scorer import WideBatchScorer as JaxWideScorer
from fraud_detection_tpu.ops.scorer import _bucket as jax_bucket
from fraud_detection_tpu.ops.scorer import _raw_score_linear as jax_score
from fraud_detection_tpu.parallel.compat import shard_map
from fraud_detection_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from fraud_detection_tpu.parallel.mesh import create_mesh as jax_create_mesh
from fraud_detection_tpu.train import train as jax_train
from fraud_detection_tpu_torch.convert import (
    params_from_jax_arrays,
    profile_from_arrays,
    scaler_from_arrays,
)
from fraud_detection_tpu_torch.data.synthetic import generate_synthetic_data
from fraud_detection_tpu_torch.ledger.placement import shard_placement
from fraud_detection_tpu_torch.ledger.state import LEDGER_K, LedgerSpec, host_state
from fraud_detection_tpu_torch.lifecycle.gate import GateThresholds
from fraud_detection_tpu_torch.lifecycle.retrain import run_retrain
from fraud_detection_tpu_torch.lifecycle.store import LifecycleStore
from fraud_detection_tpu_torch.mesh import retrain as mesh_retrain
from fraud_detection_tpu_torch.mesh.retrain import wide_sgd_fit, wide_training_mesh
from fraud_detection_tpu_torch.mesh.shardflush import (
    MeshDriftMonitor,
    ShardLoopMonitor,
    merge_window,
)
from fraud_detection_tpu_torch.mesh.topology import serving_mesh
from fraud_detection_tpu_torch.models.logistic import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
from fraud_detection_tpu_torch.ops import gbt as gbt_mod
from fraud_detection_tpu_torch.ops.crosses import (
    CrossSpec,
    _gather_contrib,
    _gather_contrib_model,
    _gather_contrib_shard,
    _model_partials,
)
from fraud_detection_tpu_torch.ops.logistic import LogisticParams, logistic_fit_lbfgs
from fraud_detection_tpu_torch.ops.scorer import BatchScorer, _bucket, _raw_score_linear
from fraud_detection_tpu_torch.parallel import (
    MeshSpec,
    all_gather,
    all_gather_blocks,
    collectives,
    create_mesh,
    global_mesh,
    psum,
    psum_model,
    psum_scatter,
    psum_scatter_blocks,
)
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import TestClient
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher
from fraud_detection_tpu_torch.train import train

torch.set_num_threads(1)

D = 30
C = 4
K = 3
LOG2B = 10
SPEC = CrossSpec(n_base=D, log2_buckets=LOG2B, amount_col=D - 1, time_col=0)
JSPEC = JaxCrossSpec(n_base=D, log2_buckets=LOG2B, amount_col=D - 1, time_col=0)
NAMES = [f"f{i}" for i in range(D)]
KAGGLE = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
GRIDS = [(2, 2), (4, 2), (2, 4)]
#: one flush's scores and attributions across the packages
SCORE_ATOL = VAL_ATOL = 1e-6
#: windows after decayed folds, the ledger's floats (tests/test_torch_mesh.py)
WIN_TOL = LEDGER_TOL = 1e-5
#: the 2-D fit against JAX's (JAX's own model-axis invariance bar)
FIT_ATOL = 1e-5
#: the conductor's challengers across the packages (tests/test_torch_lifecycle.py)
COEF_ATOL = 1e-4
INF = float("inf")


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _grid(d, m):
    return serving_mesh(d, devices=["cpu"], model_devices=m)


# ---------------------------------------------------------------------------
# the model shard's gather and the zero signs
# ---------------------------------------------------------------------------


def _gather_inputs(seed=5, rows=96):
    """A table with negative weights and a −0.0 one, indices over it,
    entity-less rows among them (two rows land on the −0.0 weight)."""
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal(1 << LOG2B) * 0.3).astype(np.float32)
    table[7] = -0.0
    idx = rng.integers(0, 1 << LOG2B, (rows, C)).astype(np.int32)
    idx[0, 0] = idx[1, 1] = 7
    has = (rng.random(rows) < 0.7).astype(np.float32)
    has[0] = 0.0
    has[1] = 1.0
    return table, idx, has


def _jax_shard_map(m, body, out_spec):
    mesh = jax_create_mesh(JaxMeshSpec(data=1, model=m), jax.devices()[:m])
    return shard_map(body, mesh=mesh, in_specs=(P("model"), P(), P()), out_specs=out_spec,
                     check_vma=False)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_gather_contrib_shard_equals_jax_under_shard_map(m):
    """Each model shard's partial (+0.0 outside its range, times has-entity)
    is JAX's bit for bit; the port's model-axis block is the single-device
    gather's bits in both packages. JAX's own ``psum`` of its partials
    departs from them only in the sign of zero: its entity-less rows over a
    negative weight read +0.0 where the single-device gather keeps −0.0."""
    table, idx, has = _gather_inputs()
    part = _jax_shard_map(m, lambda wl, i, h: jax_gather_shard(wl, i, h, "model")[None],
                          P("model"))
    want = np.asarray(part(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(has)))
    tables = torch.from_numpy(table).view(m, -1)
    ti, th = torch.from_numpy(idx).long(), torch.from_numpy(has)
    for k in range(m):
        assert _bits(_gather_contrib_shard(tables[k], ti, k, th)) == _bits(want[k])
    # the port's form: −0.0 outside, the mask after the model-axis sum
    parts = _model_partials(tables, ti)
    for k in range(m):
        assert _bits(parts[k]) == _bits(_gather_contrib_shard(tables[k], ti, k))
    got = _gather_contrib_model(tables, ti, th).numpy()
    single = np.asarray(jax_gather(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(has)))
    assert _bits(got) == _bits(_gather_contrib(torch.from_numpy(table), ti, th)) == _bits(single)
    summed = np.asarray(_jax_shard_map(
        m, lambda wl, i, h: jax.lax.psum(jax_gather_shard(wl, i, h, "model"), "model"), P()
    )(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(has)))
    differ = got.view(np.uint32) != summed.view(np.uint32)
    assert np.array_equal(got, summed)  # equal as numbers everywhere
    assert differ.any()
    assert np.all(np.signbit(got[differ]) & ~np.signbit(summed[differ]) & (got[differ] == 0))


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_model_axis_block_keeps_every_zero_sign(m):
    """Entity-less rows over negative weights (−0.0 products), a −0.0
    weight under a row with an entity, and positive weights under
    entity-less rows (+0.0): the assembled block is bitwise the
    single-device gather's, zero signs included."""
    table, idx, has = _gather_inputs(seed=6, rows=256)
    t, ti, th = torch.from_numpy(table), torch.from_numpy(idx).long(), torch.from_numpy(has)
    want = _gather_contrib(t, ti, th)
    got = _gather_contrib_model(t.view(m, -1), ti, th)
    assert _bits(got) == _bits(want)
    neg_zero = (want == 0) & torch.signbit(want)
    assert neg_zero[0].any() and neg_zero[1, 1]  # w·0 < 0, and the −0.0 weight
    assert ((want == 0) & ~torch.signbit(want)).any()


def test_model_axis_collectives():
    """psum_model folds in model order; all_gather_blocks and
    psum_scatter_blocks are the data-axis collectives inside each model
    group; at a model axis of 1 each is its data-axis counterpart's bits."""
    rng = np.random.default_rng(8)
    for d, m in ((1, 1), (4, 1), (2, 2), (2, 4)):
        mesh = create_mesh(MeshSpec(data=d, model=m), devices=["cpu"] * (d * m))
        parts = torch.from_numpy(rng.standard_normal((d, m, 8, 3)).astype(np.float32))
        want = parts[:, 0].clone()
        for k in range(1, m):
            want = want + parts[:, k]
        assert _bits(psum_model(parts, mesh)) == _bits(want)
        blocks = torch.from_numpy(rng.standard_normal((d, m, 5)).astype(np.float32))
        gathered = all_gather_blocks(blocks, mesh)
        for k in range(m):
            assert _bits(gathered[k]) == _bits(blocks[:, k].reshape(-1))
        cols = torch.from_numpy(rng.standard_normal((d, m, 4 * d)).astype(np.float32))
        scattered = psum_scatter_blocks(cols, mesh)
        assert scattered.shape == (d, m, 4)
        for k in range(m):
            assert _bits(scattered[:, k]) == _bits(psum_scatter(cols[:, k].contiguous(), mesh))
        if m == 1:
            assert _bits(gathered[0]) == _bits(all_gather(blocks[:, 0], mesh).reshape(-1))
            assert _bits(psum_model(parts, mesh)) == _bits(parts[:, 0])
            assert _bits(psum(cols, mesh)[0].reshape(d, 4)) == _bits(scattered[:, 0])
    with pytest.raises(ValueError):
        psum_model(torch.zeros(2, 3), create_mesh(MeshSpec(data=2, model=2),
                                                  devices=["cpu"] * 4))


# ---------------------------------------------------------------------------
# the 2-D wide flush
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    """Rows of broadside's shape (Time × 40,000, Amount × 150), fingerprints
    with every ninth row entity-less, a table with negative weights, the
    JAX f32 wide scorer, the port's f32 and int8 wide scorers over a
    fitted scaler, and the widened profile in both packages."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2048, D)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) * 40_000
    x[:, -1] = np.abs(x[:, -1]) * 150
    f = np.random.default_rng(22).integers(1, 1 << 32, len(x), dtype=np.uint64).astype(np.uint32)
    f[::9] = 0
    table = (np.random.default_rng(23).standard_normal(1 << LOG2B) * 0.2).astype(np.float32)
    coef = np.concatenate([np.random.default_rng(24).standard_normal(D).astype(np.float32) * 0.3,
                           np.ones(C, np.float32)])
    mean, scale = x.mean(0).astype(np.float32), (x.std(0) + 1e-6).astype(np.float32)
    js = jax_widen_scaler(JaxScaler(mean=mean, scale=scale, var=scale**2,
                                    n_samples=np.float32(len(x))), C)
    jsc = JaxWideScorer(JaxParams(coef=coef, intercept=np.float32(-1.0)), js, JSPEC, table)
    ps = scaler_from_arrays({k: np.asarray(getattr(js, k)) for k in js._fields})
    port = {wire: BatchScorer(LogisticParams(torch.from_numpy(coef), torch.tensor(np.float32(-1.0))),
                              ps, io_dtype=wire, device="cpu", wide_spec=SPEC, wide_table=table)
            for wire in ("float32", "int8")}
    xw = jax_widen(x, f, table, JSPEC)
    jprof = jax_profile(xw, np.asarray(jsc.predict_proba(xw)),
                        feature_names=NAMES + [f"c{i}" for i in range(C)])
    return {"x": x, "f": f, "table": table, "jax": jsc, "port": port, "jprof": jprof,
            "pprof": profile_from_arrays(dataclasses.asdict(jprof))}


def _wide_flush(scorer, mon, rows, fps, k, jax_side=False):
    n = len(rows)
    spec = scorer.fused_spec()
    slot = scorer.staging.acquire((jax_bucket if jax_side else _bucket)(n, scorer.min_bucket))
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


FLUSHES = ((100, 64), (300, 200), (600, 8))  # (first row, rows): buckets 64, 256, 8


@pytest.mark.parametrize("explain_k", [0, K])
@pytest.mark.parametrize("wire", ["float32", "int8"])
@pytest.mark.parametrize("grid", GRIDS)
def test_2d_wide_flush_is_the_1x1_flush_and_its_loop(wide, grid, wire, explain_k):
    """The 2-D flush's scores, reason indices and values are bitwise the
    port's 1×1 flush's and the per-data-shard loop's; its windows are the
    loop's; each data shard's rows fold into its model-rank-0 window only,
    and the merged windows are the single window bit for bit."""
    d, m = grid
    psc = wide["port"][wire]
    mesh = _grid(d, m)
    one = DriftMonitor(wide["pprof"], halflife_rows=INF, device="cpu")
    sharded = MeshDriftMonitor(wide["pprof"], mesh, halflife_rows=INF)
    loop = ShardLoopMonitor(wide["pprof"], mesh, halflife_rows=INF)
    assert (sharded.n_data, sharded.n_model, sharded.n_shards) == (d, m, d * m)
    for lo, n in FLUSHES:
        rows, fps = wide["x"][lo:lo + n], wide["f"][lo:lo + n]
        assert (fps == 0).any()
        want = _wide_flush(psc, one, rows, fps, explain_k)
        for mon in (sharded, loop):
            got = _wide_flush(psc, mon, rows, fps, explain_k)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert _bits(a) == _bits(b)
    for a, b in zip(sharded.shard_window.tensors(), loop.shard_window.tensors()):
        assert _bits(a) == _bits(b)
    rows = sharded.shard_window.n_rows.view(d, m)
    assert rows[:, 0].sum() == sum(n for _, n in FLUSHES) and not rows[:, 1:].any()
    for a, b in zip(merge_window(sharded.shard_window).tensors(), one.window.tensors()):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("explain_k", [0, K])
@pytest.mark.parametrize("grid", GRIDS)
def test_2d_wide_flush_matches_jax(wide, grid, explain_k):
    """Against JAX's broadside flush on the same grid (f32 wire): scores
    within 1e-6, reason indices equal, every per-shard window's counts
    equal at an infinite half-life."""
    d, m = grid
    jm = JaxMesh(wide["jprof"], jax_serving_mesh(d, model_devices=m), halflife_rows=INF)
    pm = MeshDriftMonitor(wide["pprof"], _grid(d, m), halflife_rows=INF)
    assert (jm.n_data, jm.n_model) == (pm.n_data, pm.n_model)
    for lo, n in FLUSHES:
        rows, fps = wide["x"][lo:lo + n], wide["f"][lo:lo + n]
        want = _wide_flush(wide["jax"], jm, rows, fps, explain_k, jax_side=True)
        got = _wide_flush(wide["port"]["float32"], pm, rows, fps, explain_k)
        np.testing.assert_allclose(got[0], want[0].astype(np.float32), rtol=0, atol=SCORE_ATOL)
        if explain_k:
            np.testing.assert_array_equal(got[1].astype(np.int64), want[1].astype(np.int64))
            np.testing.assert_allclose(got[2], want[2].astype(np.float32), rtol=0, atol=VAL_ATOL)
    for jt, pt in zip(jm.shard_window, pm.shard_window.tensors()):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def test_table_bytes_a_model_shard_halve_as_the_axis_doubles(wide):
    """widebench's gate: a model shard holds buckets/M weights, laid out
    once a table (a new table is laid out again); a table the axis does
    not divide raises before any layout."""
    t = torch.from_numpy(wide["table"])
    nbytes = {}
    for m in (1, 2, 4, 8):
        mon = MeshDriftMonitor(wide["pprof"], _grid(1, m))
        placed = mon._placed_wide_table(SPEC, t)
        assert mon._placed_wide_table(SPEC, t) is placed
        shard = placed[0] if placed.dim() == 2 else placed
        nbytes[m] = shard.numel() * shard.element_size()
        if m > 1:
            assert _bits(placed.reshape(-1)) == _bits(t)
            assert mon._placed_wide_table(SPEC, t.clone()) is not placed
    assert nbytes == {m: (1 << LOG2B) * 4 // m for m in (1, 2, 4, 8)}
    small = CrossSpec(n_base=D, log2_buckets=2, amount_col=D - 1, time_col=0)
    mon = MeshDriftMonitor(wide["pprof"], _grid(1, 8))
    with pytest.raises(ValueError, match="does not column-shard"):
        mon._placed_wide_table(small, torch.zeros(4))
    assert mon._wide_placed is None


def test_steady_state_wide_flushes_allocate_no_staging(wide):
    """widebench's gate: after a warm flush a bucket, the 2-D wide flushes
    draw pooled staging slots (fingerprint lanes included): 0 allocations."""
    psc = wide["port"]["float32"]
    mon = MeshDriftMonitor(wide["pprof"], _grid(2, 2))
    for lo, n in FLUSHES:
        _wide_flush(psc, mon, wide["x"][lo:lo + n], wide["f"][lo:lo + n], K)
    before = psc.staging.allocations
    for _ in range(3):
        for lo, n in FLUSHES:
            _wide_flush(psc, mon, wide["x"][lo:lo + n], wide["f"][lo:lo + n], K)
    assert psc.staging.allocations == before


# ---------------------------------------------------------------------------
# the narrow and ledger families on a 2×2 grid
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4096, D)) * 2.0 + 0.5).astype(np.float32)
    jp = JaxParams(coef=np.random.default_rng(0).standard_normal(D).astype(np.float32) * 0.3,
                   intercept=np.float32(-1.0))
    js = jax_scaler_fit(x)
    tp = params_from_jax_arrays({k: np.asarray(v) for k, v in jp._asdict().items()})
    ts = scaler_from_arrays({k: np.asarray(v) for k, v in js._asdict().items()})
    jprof = jax_profile(x, np.asarray(JaxScorer(jp, js).predict_proba(x)).reshape(-1),
                        feature_names=NAMES)
    return {"x": x, "jax": lambda wire: JaxScorer(jp, js, io_dtype=wire),
            "port": lambda wire: BatchScorer(tp, ts, io_dtype=wire, device="cpu"),
            "jprof": jprof, "pprof": profile_from_arrays(jprof.__dict__)}


def _jax_flush(scorer, mon, rows, k):
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


def _port_flush(scorer, mon, rows, k):
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


@pytest.mark.parametrize("explain_k", [0, K])
@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_narrow_flush_on_a_2x2_grid(narrow, wire, explain_k):
    """The narrow family splits its rows over the flattened 2×2 grid (four
    windows, shard d·2 + m): bitwise its per-shard loop; against JAX's 2×2
    mesh scores and values within 1e-6, indices equal, windows within
    1e-5 after decayed folds."""
    jm = JaxMesh(narrow["jprof"], jax_serving_mesh(2, model_devices=2), halflife_rows=500.0)
    pm = MeshDriftMonitor(narrow["pprof"], _grid(2, 2), halflife_rows=500.0)
    loop = ShardLoopMonitor(narrow["pprof"], _grid(2, 2), halflife_rows=500.0)
    psc, jsc = narrow["port"](wire), narrow["jax"](wire)
    for lo, n in ((0, 37), (100, 200), (400, 5)):
        rows = narrow["x"][lo:lo + n]
        want = _jax_flush(jsc, jm, rows, explain_k)
        got = _port_flush(psc, pm, rows, explain_k)
        for a, b in zip(got, _port_flush(psc, loop, rows, explain_k)):
            assert _bits(a) == _bits(b)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SCORE_ATOL)
        if explain_k:
            np.testing.assert_array_equal(got[1].astype(np.int64), want[1].astype(np.int64))
            np.testing.assert_allclose(got[2], want[2], rtol=0, atol=VAL_ATOL)
    assert pm.shard_window.n_rows.shape == (4,) and bool((pm.shard_window.n_rows > 0).all())
    for a, b in zip(pm.shard_window.tensors(), loop.shard_window.tensors()):
        assert _bits(a) == _bits(b)
    for jt, pt in zip(jm.shard_window, pm.shard_window.tensors()):
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=WIN_TOL, atol=WIN_TOL)


def _ledger_batches(spec, n_batches=4, bs=64, seed=1):
    rng = np.random.default_rng(seed)
    t = 1.0
    out = []
    for b in range(n_batches):
        x = rng.standard_normal((bs, D)).astype(np.float32)
        x[:, -1] = np.abs(x[:, -1]) * 50.0
        slots, fps = np.zeros(bs, np.int64), np.zeros(bs, np.int64)
        has, ts = np.zeros(bs, np.float32), np.zeros(bs, np.float32)
        for i in range(bs):
            if rng.random() < 0.15:
                continue
            e = "card-hot" if b == 2 and i % 4 else f"card-{rng.integers(0, 40)}"
            slots[i], fps[i] = spec.row_keys(e)
            has[i], ts[i] = 1.0, t
            t += 0.5
        out.append((x, slots, fps, ts, has))
    return out


def test_ledger_flush_on_a_2x2_grid():
    """The ledger on a 2×2 grid: slots placed by ``slot mod 4``, bitwise the
    per-shard loop (scores, reason codes, sub-tables); against JAX's 2×2
    mesh the scores and the merged table within 1e-5, its anchors,
    fingerprints and counts equal."""
    kw = dict(n_base=D, slots=256, halflife_s=500.0, amount_col=-1,
              null_features=np.zeros(LEDGER_K, np.float32))
    jspec, pspec = JaxLedgerSpec(**kw), LedgerSpec(**kw)
    rng = np.random.default_rng(1)
    jprof = jax_profile(rng.standard_normal((2000, D + LEDGER_K)).astype(np.float32),
                        rng.random(800).astype(np.float32),
                        feature_names=[f"f{i}" for i in range(D + LEDGER_K)])
    pprof = profile_from_arrays(jprof.__dict__)
    coef = np.random.default_rng(3).standard_normal(D + LEDGER_K).astype(np.float32) * 0.2
    jm = JaxMesh(jprof, jax_serving_mesh(2, model_devices=2), halflife_rows=1000.0)
    jm.bind_ledger(jspec)
    pm = MeshDriftMonitor(pprof, _grid(2, 2), halflife_rows=1000.0)
    loop = ShardLoopMonitor(pprof, _grid(2, 2), halflife_rows=1000.0)
    for mon in (pm, loop):
        mon.bind_ledger(pspec)

    def port(mon, cols, n, k):
        x, slots, fps, ts, has, valid = (torch.from_numpy(np.ascontiguousarray(c)) for c in cols)
        out = mon.fused_flush(
            x, valid, n, (torch.from_numpy(coef), torch.tensor(np.float32(0.1))),
            _raw_score_linear, ledger_rows=(slots, fps, ts, has),
            explain_args=(torch.from_numpy(coef), torch.zeros(D + LEDGER_K)) if k else None,
            explain_k=k,
        )
        return tuple(o.numpy() for o in (out if isinstance(out, tuple) else (out,)))

    for i, batch in enumerate(_ledger_batches(pspec)):
        x, slots, fps, ts, has = batch
        n = x.shape[0]
        bucket, pos = shard_placement(slots, has, 4, min_bucket=8)
        seg = bucket // 4
        assert all(pos[r] // seg == slots[r] % 4 for r in range(n) if has[r])
        cols = [np.zeros((bucket, D), np.float32), np.zeros(bucket, np.int64),
                np.zeros(bucket, np.int64), np.zeros(bucket, np.float32),
                np.zeros(bucket, np.float32), np.zeros(bucket, np.float32)]
        for c, v in zip(cols, (x, slots, fps, ts, has, np.ones(n, np.float32))):
            c[pos] = v
        k = K if i % 2 else 0
        got = port(pm, cols, n, k)
        for a, b in zip(got, port(loop, cols, n, k)):
            assert _bits(a) == _bits(b)
        jx, jsl, jfp, jts, jh, jv = cols
        want = jm.fused_flush(
            jnp.asarray(jx), jnp.asarray(jv), n, (jnp.asarray(coef), jnp.float32(0.1)),
            jax_score, ledger_rows=(jnp.asarray(jsl.astype(np.int32)),
                                    jnp.asarray(jfp.astype(np.uint32)),
                                    jnp.asarray(jts), jnp.asarray(jh)),
            explain_args=(jnp.asarray(coef), jnp.zeros(D + LEDGER_K)) if k else None,
            explain_k=k,
        )
        want = want[0] if isinstance(want, tuple) else want
        np.testing.assert_allclose(got[0][pos], np.asarray(want)[pos], rtol=0, atol=LEDGER_TOL)
    for a, b in zip(pm.ledger, loop.ledger):
        assert _bits(a) == _bits(b)
    jt, pt = jm.ledger_snapshot(), host_state(pm.ledger_snapshot())
    for name, a, b in zip(("acc", "last_ts", "fingerprint", "collisions", "evictions"), jt, pt):
        if name == "acc":
            np.testing.assert_allclose(b, np.asarray(a), rtol=LEDGER_TOL, atol=LEDGER_TOL)
        else:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


# ---------------------------------------------------------------------------
# the 2-D fit
# ---------------------------------------------------------------------------


def _planted(seed=31, n=8192, n_entities=1200):
    """test_broadside's planted cross signal: each entity a characteristic
    amount, so its (entity × amount-bucket) cross recurs; the labels carry
    per-bucket signal. Returns scaled rows, indices, has-entity, labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    ent = rng.integers(0, n_entities, n)
    fps = (ent + 1).astype(np.uint32)
    x[:, -1] = (np.abs(rng.standard_normal(n_entities)).astype(np.float32) * 200)[ent]
    idx = jax_cross_indices(x, fps, JSPEC)
    has = np.ones(n, np.float32)
    has[::11] = 0.0
    w_true = rng.standard_normal(D).astype(np.float32) * 0.2
    w_true[-1] = 0.0
    sig = (rng.random(JSPEC.buckets) < 0.1).astype(np.float32) * 4.0
    z = x @ w_true + sig[idx[:, 0]] - 2.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.int64)
    xs = ((x - x.mean(0)) / (x.std(0) + 1e-6)).astype(np.float32)
    return xs, idx, has, y, sig


def _auc(s, y):
    order = np.argsort(s)
    r = np.empty(len(s))
    r[order] = np.arange(len(s))
    pos = y == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (r[pos].sum() - n_pos * (n_pos - 1) / 2) / (n_pos * n_neg)


def _port_fit(xs, idx, has, y, d, m, **kw):
    p, t = wide_sgd_fit(xs, idx, has, y, SPEC, mesh=global_mesh(MeshSpec(d, m), "cpu"), **kw)
    return p.coef.numpy(), float(p.intercept), t.numpy()


def test_2d_wide_sgd_fit_matches_jax_and_is_bitwise_across_the_model_axis():
    """At (2, 1), (2, 2), (2, 4) the port's fit is JAX's on the same mesh
    within 1e-5 (coef, intercept, table); at a fixed data axis every model
    axis gives the same bits (JAX holds 1e-5: it sums a shard's templates
    before the model-axis psum, the port assembles the block first); and
    the fit learns the planted crosses (JAX's AUC gate)."""
    xs, idx, has, y, sig = _planted()
    tr, te = np.arange(0, len(y), 2), np.arange(1, len(y), 2)
    kw = dict(epochs=12, batch_size=1024, lr=1.0, seed=1)
    fits = {}
    for m in (1, 2, 4):
        mesh = jax_create_mesh(JaxMeshSpec(data=2, model=m), jax.devices()[:2 * m])
        jp, jt = jax_wide_fit(xs[tr], idx[tr], has[tr], y[tr], JSPEC, mesh=mesh, **kw)
        coef, b, table = fits[m] = _port_fit(xs[tr], idx[tr], has[tr], y[tr], 2, m, **kw)
        np.testing.assert_allclose(coef, np.asarray(jp.coef), rtol=0, atol=FIT_ATOL)
        assert b == pytest.approx(float(jp.intercept), abs=FIT_ATOL)
        np.testing.assert_allclose(table, jt, rtol=0, atol=FIT_ATOL)
    for m in (2, 4):
        for a, b in zip(fits[m], fits[1]):
            assert _bits(a) == _bits(b), m
    coef, _, table = fits[1]
    zs = xs[te] @ coef[:D] + (table[idx[te]] * has[te, None]).sum(axis=1)
    assert _auc(zs, y[te]) > _auc(xs[te] @ coef[:D], y[te]) + 0.02
    assert table[sig > 0].mean() > table[sig == 0].mean() + 0.04


def test_2d_wide_sgd_fit_is_bitwise_across_the_model_axis_at_one_data_shard():
    """A data axis of 1 (train()'s grid in one process): the fit at model
    axes 2, 4 and 8 is the 1×1 fit bit for bit; the grid is
    ``wide_training_mesh``'s; a grid the table does not divide raises."""
    xs, idx, has, y, _ = _planted(seed=32, n=3000, n_entities=400)
    kw = dict(epochs=3, batch_size=512, lr=0.5, seed=2, class_weight="balanced")
    ref = _port_fit(xs, idx, has, y, 1, 1, **kw)
    for m in (2, 4, 8):
        mesh = wide_training_mesh(model_devices=m, device="cpu")
        assert (mesh.data, mesh.model) == (1, m)
        p, t = wide_sgd_fit(xs, idx, has, y, SPEC, mesh=mesh, **kw)
        for a, b in zip((p.coef.numpy(), float(p.intercept), t.numpy()), ref):
            assert _bits(a) == _bits(b), m
    big = global_mesh(MeshSpec(64, 32), "cpu")
    with pytest.raises(ValueError, match="does not shard"):
        wide_sgd_fit(xs, idx, has, y, SPEC, mesh=big, epochs=1)


def test_2d_wide_sgd_fit_warm_start_matches_jax():
    """JAX's warm-start case (one epoch at lr 0.01 from a seeded base coef
    and table) on a 2×2 grid: within 1e-5 of JAX's on the same mesh, near
    the incumbent, and the table genuinely seeded."""
    rng = np.random.default_rng(33)
    n = 2048
    x = rng.standard_normal((n, D)).astype(np.float32)
    fps = rng.integers(1, 500, n).astype(np.uint32)
    idx = jax_cross_indices(x, fps, JSPEC)
    has = np.ones(n, np.float32)
    y = (rng.random(n) < 0.3).astype(np.int64)
    coef0 = rng.standard_normal(D).astype(np.float32)
    table0 = (rng.standard_normal(JSPEC.buckets) * 0.5).astype(np.float32)
    mesh = jax_create_mesh(JaxMeshSpec(data=2, model=2), jax.devices()[:4])
    jp, jt = jax_wide_fit(x, idx, has, y, JSPEC, epochs=1, lr=0.01, seed=0, mesh=mesh,
                          warm_start=(JaxParams(coef=coef0, intercept=np.float32(-0.5)), table0))
    pw = (LogisticParams(torch.from_numpy(coef0), torch.tensor(-0.5)), table0)
    coef, b, table = _port_fit(x, idx, has, y, 2, 2, epochs=1, lr=0.01, seed=0, warm_start=pw)
    np.testing.assert_allclose(coef, np.asarray(jp.coef), rtol=0, atol=FIT_ATOL)
    assert b == pytest.approx(float(jp.intercept), abs=FIT_ATOL)
    np.testing.assert_allclose(table, jt, rtol=0, atol=FIT_ATOL)
    assert np.abs(coef[:D] - coef0).max() < 0.5 and np.abs(table - table0).max() < 0.5
    assert np.abs(table).max() > 0.1


# ---------------------------------------------------------------------------
# train(), the conductor and the app on a model axis of 2
# ---------------------------------------------------------------------------


def _grids_seen(monkeypatch):
    """Record the (data, model) grid of every wide fit the port runs."""
    seen = []
    real = mesh_retrain.wide_sgd_fit

    def spy(*a, mesh=None, **kw):
        seen.append((mesh.data, mesh.model))
        return real(*a, mesh=mesh, **kw)

    for mod in ("fraud_detection_tpu_torch.train", "fraud_detection_tpu_torch.mesh.retrain"):
        monkeypatch.setattr(f"{mod}.wide_sgd_fit", spy)
    return seen


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One synthetic CSV (3,000 rows, the Kaggle schema) trained with
    ``WIDE_BUCKETS=1024`` and ``MESH_MODEL_DEVICES=2`` by JAX's
    ``train(wide=True)`` (its 4×2 grid) and by the port's on the CPU (its
    1×2 grid), and by the port's at a model axis of 1."""
    root = tmp_path_factory.mktemp("model_axis_train")
    csv = str(root / "synth.csv")
    generate_synthetic_data(csv, n_samples=3000, fraud_ratio=0.03, seed=0, shift_scale=0.35)
    out = {"csv": csv}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WIDE_BUCKETS", "1024")
        seen = _grids_seen(mp)
        for name, fn, m, kw in (("jax", jax_train, "2", {}),
                                ("port", train, "2", {"device": "cpu"}),
                                ("port_m1", train, "1", {"device": "cpu"})):
            mp.setenv("MESH_MODEL_DEVICES", m)
            mp.setenv("MLFLOW_TRACKING_URI", f"file:{root}/{name}/mlruns")
            d = str(root / name / "models")
            out[name] = (fn(data_csv=csv, register=False, out_dir=d, wide=True, **kw), d)
        out["grids"] = list(seen)
    return out


def test_train_wide_on_a_model_axis_of_2_matches_jax(trained):
    """``train(wide=True)`` fits through ``wide_training_mesh()``: a 1×2 grid
    with ``MESH_MODEL_DEVICES=2``; the table, the coef, the intercept and
    the test AUC within 1e-5 of JAX's; bitwise the port's fit at a model
    axis of 1."""
    assert trained["grids"] == [(1, 2), (1, 1)]
    (got, pdir), (want, jdir) = trained["port"], trained["jax"]
    pm, jm = FraudLogisticModel.load(pdir, device="cpu"), JaxModel.load(jdir)
    np.testing.assert_allclose(pm.wide_table, jm.wide_table, rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(pm.params.coef.numpy(), np.asarray(jm.params.coef),
                               rtol=0, atol=FIT_ATOL)
    assert float(pm.params.intercept) == pytest.approx(float(jm.params.intercept), abs=FIT_ATOL)
    assert abs(got["test_auc"] - want["test_auc"]) <= 1e-5
    m1 = FraudLogisticModel.load(trained["port_m1"][1], device="cpu")
    assert _bits(m1.wide_table) == _bits(pm.wide_table)
    assert _bits(m1.params.coef) == _bits(pm.params.coef)
    assert _bits(m1.params.intercept) == _bits(pm.params.intercept)


def test_conductor_wide_retrain_on_a_2d_grid_matches_jax(tmp_path, monkeypatch):
    """JAX's ``test_conductor_retrains_wide_challenger_2d`` in both packages
    (``WIDE_ENABLED``, ``MESH_MODEL_DEVICES=2``, a narrow champion): the
    port's retrain fits over a 1×2 grid; the challengers' table, coef and
    intercept within COEF_ATOL of JAX's, the same verdict, the sidecar
    stamped."""
    monkeypatch.setenv("WIDE_ENABLED", "1")
    monkeypatch.setenv("WIDE_BUCKETS", str(1 << LOG2B))
    monkeypatch.setenv("MESH_MODEL_DEVICES", "2")
    seen = _grids_seen(monkeypatch)
    rng = np.random.default_rng(61)
    n = 2400
    x = rng.standard_normal((n, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ w - 2.0)))).astype(np.int32)
    csv = str(tmp_path / "base.csv")
    with open(csv, "w") as f:
        f.write(",".join(KAGGLE + ["Class"]) + "\n")
        for row, label in zip(x, y):
            f.write(",".join(f"{v:.6f}" for v in row) + f",{int(label)}\n")
    from fraud_detection_tpu.data.loader import stratified_split

    tr, _ = stratified_split(y, 0.2, 42)
    scaler = jax_scaler_fit(x[tr])
    champion = JaxModel(jax_lbfgs(jax_scaler_transform(scaler, x[tr]), y[tr], max_iter=60),
                        scaler, KAGGLE)
    art = str(tmp_path / "champion")
    champion.save(art, joblib_too=False)
    res = {}
    for name in ("jax", "port"):
        monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/{name}/mlruns")
        url = f"sqlite:///{tmp_path}/{name}_lc.db"
        if name == "jax":
            store = JaxStore(url, window_size=200, reservoir_size=64, seed=3)
            run = lambda s: jax_run_retrain(  # noqa: E731
                s, champion, champion_version=1, data_csv=csv, use_smote=False, max_iter=60,
                thresholds=JaxGate(auc_margin=0.10, ece_bound=0.9, psi_bound=5.0,
                                   min_eval_rows=64))
        else:
            store = LifecycleStore(url, window_size=200, reservoir_size=64, seed=3)
            champ = FraudLogisticModel.load(art, device="cpu")
            run = lambda s: run_retrain(  # noqa: E731
                s, champ, champion_version=1, data_csv=csv, use_smote=False, max_iter=60,
                thresholds=GateThresholds(auc_margin=0.10, ece_bound=0.9, psi_bound=5.0,
                                          min_eval_rows=64), device="cpu")
        try:
            res[name] = run(store)
        finally:
            store.close()
    assert seen == [(1, 2)]
    want, got = res["jax"].challenger, res["port"].challenger
    assert got.wide_spec is not None and tuple(got.wide_spec) == tuple(want.wide_spec)
    assert got.wide_spec.buckets == 1 << LOG2B and len(got.feature_names) == D + C
    assert os.path.exists(os.path.join(res["port"].artifact_dir, "wide_params.npz"))
    np.testing.assert_allclose(got.wide_table.numpy(), np.asarray(want.wide_table),
                               rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(got.params.coef.numpy(), np.asarray(want.params.coef),
                               rtol=0, atol=COEF_ATOL)
    assert float(got.params.intercept) == pytest.approx(float(want.params.intercept),
                                                        abs=COEF_ATOL)
    assert res["port"].gate.passed == res["jax"].gate.passed
    assert "holdout_challenger_auc" in res["port"].gate.metrics


@pytest.fixture(scope="module")
def ledger_dir(trained, tmp_path_factory):
    """The port's ``train(ledger=True)`` on the same CSV (64 slots, 3 folds)."""
    root = tmp_path_factory.mktemp("model_axis_ledger")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEDGER_SLOTS", "64")
        mp.setenv("MLFLOW_TRACKING_URI", f"file:{root}/mlruns")
        train(data_csv=trained["csv"], n_folds=3, register=False, out_dir=str(root / "models"),
              ledger=True, device="cpu")
    return str(root / "models")


@pytest.mark.parametrize("family", ["wide", "ledger"])
def test_app_on_a_2x2_grid_serves_as_the_1x1_app(family, trained, ledger_dir, tmp_path,
                                                 monkeypatch):
    """The app with ``MESH_FLUSH_DEVICES=2 MESH_MODEL_DEVICES=2`` starts on
    a 2×2 grid and answers every ``/predict`` (with entities, without, one
    at a time: the bucket of 8) bitwise as the 1×1 app does, scores and
    reason codes: the wide model (the port-trained 1×2 fit; its table
    column-sharded, ``wide_model_shards`` 2, an occupancy series a model
    shard) and the ledger model (its rows over the flattened grid, slots
    by ``slot mod 4``; the merged sub-tables the 1×1 app's table bit for
    bit)."""
    from fraud_detection_tpu_torch.ledger import load_ledger

    model_dir = trained["port"][1] if family == "wide" else ledger_dir
    monkeypatch.setenv("MODEL_PATH", os.path.join(model_dir, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/empty")
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("DEVICE", "cpu")
    x = np.loadtxt(trained["csv"], delimiter=",", skiprows=1, max_rows=24, dtype=np.float32)[:, :D]
    t0 = 0.0
    if family == "ledger":
        spec, state = load_ledger(model_dir)
        t0 = spec.ts_origin + float(np.max(state.last_ts)) + 10.0
    answers, tables = {}, {}
    for name, grid in (("one", None), ("grid", ("2", "2"))):
        for var in ("MESH_FLUSH_DEVICES", "MESH_MODEL_DEVICES"):
            monkeypatch.delenv(var, raising=False)
        if grid:
            monkeypatch.setenv("MESH_FLUSH_DEVICES", grid[0])
            monkeypatch.setenv("MESH_MODEL_DEVICES", grid[1])
        app = create_app(database_url=f"sqlite:///{tmp_path}/{name}_fraud.db",
                         broker_url=f"sqlite:///{tmp_path}/{name}_taskq.db")
        with TestClient(app) as tc:
            out = []
            for i in range(x.shape[0]):
                body = {"features": x[i].tolist()}
                if i % 3:
                    body["entity_id"] = f"card-{i % 5}"
                    if family == "ledger":
                        body["timestamp"] = t0 + 3.0 * i
                r = tc.post("/predict", json=body).json()
                out.append((r["score"], r["reason_codes"]))
            drift = tc.app.state["watchtower"].drift
            text = tc.get("/metrics").text
            if family == "ledger":
                tables[name] = [np.asarray(t).copy() for t in drift.ledger_snapshot()]
        answers[name] = out
        assert isinstance(drift, MeshDriftMonitor) == bool(grid)
        if grid:
            assert (drift.n_data, drift.n_model, drift.n_shards) == (2, 2, 4)
        if family == "wide":
            assert f"wide_model_shards {2.0 if grid else 1.0}" in text
            if grid:
                assert metrics.wide_bucket_occupancy.get("0") > 0.0
                assert metrics.wide_bucket_occupancy.get("1") > 0.0
        elif grid:
            assert drift.ledger.acc.shape[0] == 4
    assert answers["grid"] == answers["one"]
    assert len({s for s, _ in answers["one"]}) > 1
    for a, b in zip(tables.get("grid", ()), tables.get("one", ())):
        assert _bits(a) == _bits(b)


# ---------------------------------------------------------------------------
# train()'s one-shard fits
# ---------------------------------------------------------------------------


def test_one_shard_lbfgs_takes_the_unsharded_graph(monkeypatch):
    """``logistic_fit_lbfgs(sharded=True)`` over one global shard runs the
    unsharded graph (no per-shard copy, no psum) with its bits; over two
    shards the sharded graph runs."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((600, D)).astype(np.float32))
    y = (rng.random(600) < 0.2).astype(np.float32)
    calls = []
    for name in ("replicate", "psum"):
        real = getattr(collectives, name)
        monkeypatch.setattr(collectives, name,
                            lambda *a, _real=real, _name=name, **kw: (calls.append(_name),
                                                                     _real(*a, **kw))[1])
    one = create_mesh(MeshSpec(data=1), devices=["cpu"])
    sharded = logistic_fit_lbfgs(x, y, max_iter=50, class_weight="balanced", mesh=one,
                                 sharded=True)
    assert calls == []
    plain = logistic_fit_lbfgs(x, y, max_iter=50, class_weight="balanced")
    assert _bits(sharded.coef) == _bits(plain.coef)
    assert _bits(sharded.intercept) == _bits(plain.intercept)
    two = create_mesh(MeshSpec(data=2), devices=["cpu"] * 2)
    logistic_fit_lbfgs(x, y, max_iter=5, mesh=two, sharded=True)
    assert "replicate" in calls and "psum" in calls


def test_one_shard_cpu_forest_keeps_the_split_phase(monkeypatch):
    """On the CPU a one-shard sharded forest still runs the split phase (its
    fixed-point plain version): its forest is the same at every shard
    count. The whole launch a level is the card's one-shard route."""
    calls = []
    real = gbt_mod._split_hist
    monkeypatch.setattr(gbt_mod, "_split_hist",
                        lambda *a, **kw: (calls.append(kw["mesh"].size), real(*a, **kw))[1])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((400, 6)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.standard_normal(400) > 0.5).astype(np.float32)
    cfg = gbt_mod.GBTConfig(n_trees=2, max_depth=2, n_bins=16)
    one = gbt_mod.gbt_fit(x, y, cfg, mesh=create_mesh(MeshSpec(data=1), devices=["cpu"]),
                          sharded=True)
    assert calls and set(calls) == {1}
    two = gbt_mod.gbt_fit(x, y, cfg, mesh=create_mesh(MeshSpec(data=2), devices=["cpu"] * 2),
                          sharded=True)
    for a, b in zip(one, two):
        assert _bits(a) == _bits(b)
