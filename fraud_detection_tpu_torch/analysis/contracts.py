"""Collective budgets: the collective calls each sharded program of the port
makes a unit of its work.

The JAX package declares a ``collectives=`` budget on each entry point's
contract (``analysis/contracts.py``) and proves it on the entry point's
jaxpr at small shapes (``analysis/meshcheck.py``): the serving flushes
spend none (the bitwise N-shard contract), the 2-D wide flush exactly one
model-axis ``psum``, each training step its documented 2004.13336 spend,
the fleet's map bodies none and its merges exact ones. The port runs
eagerly, so a budget here is a count of calls — ``parallel.collectives``'
counts, keyed ``(kind, axis)`` — over one unit of a program (a step, a
tree level, a flush, a call), and a program that holds its budget holds
it at every shard count: a count that moves with the shard count is a
fault, not a budget.

Each :class:`Budget` names the JAX entry point, the port's program, the
unit and the counts a unit (``setup``: what a run spends once outside its
units, such as a fit's closing gather). Its ``build(mesh)`` lays the
program out at small shapes on ``mesh`` (as ``meshcheck``'s builders do)
and returns ``(run, units)``. :func:`check_budgets` runs every program at
each shard count (or, for a 2-D program, each ``data × model`` grid) of
virtual shards in one process and returns each violation as a stable
string, ``entrypoint:kind@axis expected N got M`` (``M`` the count a unit),
as JAX's ``violation_keys`` are.

Where the port's count differs from JAX's declaration, the budget's note
says why.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.parallel.collectives import (
    collective_counts,
    reset_collective_counts,
)
from fraud_detection_tpu_torch.parallel.mesh import Mesh, MeshSpec, create_mesh

ROWS, FEATURES, BATCH = 256, 6, 16  # the programs' shapes
FLUSH_ROWS = 37  # a flush's live rows (bucket 64)
SHARD_COUNTS = (1, 2, 8)
GRIDS = ((1, 1), (2, 2), (2, 4))
PSUM, PSUM_MODEL = ("psum", "data"), ("psum", "model")
ALL_GATHER, PSUM_SCATTER, PMAX = ("all_gather", "data"), ("psum_scatter", "data"), ("pmax", "data")


@dataclass(frozen=True)
class Budget:
    """One program's collective budget: ``counts`` a ``unit`` of
    ``program`` (``(kind, axis)`` → calls), ``setup`` once a run."""

    entrypoint: str  # the JAX package's entry point (or the port's name)
    program: str  # the port's callable
    unit: str
    counts: dict
    build: Callable[[Mesh], tuple[Callable[[], object], int]]
    note: str = ""
    setup: dict = field(default_factory=dict)
    grid: bool = False  # run on the 2-D grids, not the shard counts


# -- inputs ------------------------------------------------------------------

def _rows(n: int = ROWS, d: int = FEATURES, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (x @ w + 0.3 * rng.standard_normal(n) > 0.5).astype(np.float32)
    return x, y


def _steps(n: int, ndev: int, batch: int) -> int:
    """Steps an epoch of the sharded SGD fits: rows padded to ``ndev ·
    batch`` (the batch capped at a shard's rows), a shard's segment cut
    into batches."""
    from fraud_detection_tpu_torch.ops.logistic import _cap_batch_size

    b = _cap_batch_size(n, ndev, batch)
    n_pad = -(-n // (ndev * b)) * ndev * b
    return (n_pad // ndev) // b


def _cross_spec():
    from fraud_detection_tpu_torch.ops.crosses import CrossSpec

    return CrossSpec(n_base=FEATURES, log2_buckets=6, amount_col=FEATURES - 1, time_col=0)


def _fingerprints(n: int, seed: int = 4) -> np.ndarray:
    fps = np.random.default_rng(seed).integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    fps[::5] = 0  # entity-less rows
    return fps


def _flush(mon, scorer, rows, k: int = 0, fps=None):
    """One fused flush of ``rows`` through ``mon``, staged as the
    micro-batcher stages it (``fps``: the wide family's fingerprints)."""
    from fraud_detection_tpu_torch.ops.scorer import _bucket
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    n = len(rows)
    spec = scorer.fused_spec()
    items = [(rows[i], None, None,
              (0, int(fps[i]), 0.0) if fps is not None and fps[i] else None) for i in range(n)]
    wide_args = spec.wide
    if wide_args is not None:  # the column-sharded table at every grid, 1x1 too
        wide_args = (wide_args[0], wide_args[1].view(mon.n_model, -1))
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, items)
        wide_rows = MicroBatcher._stage_wide(scorer, slot, items) if wide_args else None
        return mon.fused_flush(
            scorer.to_device(hx), scorer.to_device(slot.valid), n, spec.score_args,
            spec.score_fn, dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
            explain_args=spec.explain_args if k else None, explain_k=k,
            wide_args=wide_args, wide_rows=wide_rows,
        )
    finally:
        scorer.staging.release(slot)


# -- builders ----------------------------------------------------------------

def _logistic_sgd(mesh):
    from fraud_detection_tpu_torch.ops.logistic import logistic_fit_sgd

    x, y = _rows()
    xt = torch.from_numpy(x).to(mesh.device)
    return (lambda: logistic_fit_sgd(xt, y, epochs=1, batch_size=BATCH, mesh=mesh),
            _steps(ROWS, mesh.global_data, BATCH))


def _split_level(mesh):
    from fraud_detection_tpu_torch.ops.gbt import _split_hist

    rng = np.random.default_rng(2)
    n, n_nodes, n_bins = 64 * mesh.size, 4, 16
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(n)))
    args = [torch.from_numpy(a).to(mesh.device) for a in (
        rng.integers(0, n_bins, (n, FEATURES)).astype(np.uint8),
        rng.integers(0, n_nodes, n).astype(np.int32),
        (p - (rng.random(n) < 0.5)).astype(np.float32), (p * (1.0 - p)).astype(np.float32))]
    return lambda: _split_hist(*args, n_nodes, n_bins, mesh=mesh, n_total=n), 1


def _linear(dev, wire: str):
    """A logistic scorer on ``wire`` over a scaler fitted on the rows, and
    its drift profile."""
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit
    from fraud_detection_tpu_torch.ops.scorer import BatchScorer

    x, _ = _rows()
    coef = np.random.default_rng(1).standard_normal(FEATURES).astype(np.float32) * 0.3
    scorer = BatchScorer(LogisticParams(torch.from_numpy(coef), torch.tensor(-1.0)),
                         scaler_fit(torch.from_numpy(x)), io_dtype=wire, device=dev)
    return scorer, build_baseline_profile(x, scorer.predict_proba(x), device=dev)


def _forest(dev, wire: str):
    """A 4-tree depth-3 forest with TreeSHAP on ``wire`` (int8 with a
    calibration derived from the rows' scaler), and its drift profile."""
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.ops.quant import derive_calibration
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit
    from fraud_detection_tpu_torch.ops.scorer import GBTBatchScorer
    from fraud_detection_tpu_torch.ops.tree_shap import build_tree_explainer

    x, y = _rows()
    model = gbt_fit(x, y, GBTConfig(n_trees=4, max_depth=3, n_bins=16), device=dev)
    cal = derive_calibration(scaler_fit(torch.from_numpy(x))) if wire == "int8" else None
    scorer = GBTBatchScorer(model, io_dtype=wire, calibration=cal,
                            explainer=build_tree_explainer(model, x[:32], seed=0))
    return scorer, build_baseline_profile(x, scorer.predict_proba(x), device=dev)


def _narrow_flush(wire: str, k: int, family=_linear):
    def build(mesh):
        from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor

        scorer, profile = family(mesh.device, wire)
        mon = MeshDriftMonitor(profile, mesh)
        rows = list(_rows()[0][:FLUSH_ROWS])
        return lambda: _flush(mon, scorer, rows, k), 1

    return build


def _ledger_flush(mesh):
    from fraud_detection_tpu_torch.ledger.placement import shard_placement
    from fraud_detection_tpu_torch.ledger.state import LEDGER_K, LedgerSpec
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear

    dev, d, n = mesh.device, FEATURES + LEDGER_K, 64
    spec = LedgerSpec(n_base=FEATURES, slots=256, halflife_s=500.0, amount_col=-1,
                      null_features=np.zeros(LEDGER_K, np.float32))
    rng = np.random.default_rng(3)
    mon = MeshDriftMonitor(build_baseline_profile(
        rng.standard_normal((512, d)).astype(np.float32), rng.random(512).astype(np.float32),
        device=dev), mesh)
    mon.bind_ledger(spec)
    x = rng.standard_normal((n, FEATURES)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1]) * 50.0
    keys = np.asarray([spec.row_keys(f"card-{i % 20}") for i in range(n)], np.int64)
    cols = (x, keys[:, 0], keys[:, 1], 1.0 + 0.5 * np.arange(n, dtype=np.float32),
            np.ones(n, np.float32), np.ones(n, np.float32))
    if mesh.size > 1:  # each entity's rows in the segment of the shard owning its slot
        bucket, pos = shard_placement(cols[1], cols[4], mesh.size, min_bucket=8)
        placed = []
        for c in cols:
            p = np.zeros((bucket,) + c.shape[1:], c.dtype)
            p[pos] = c
            placed.append(p)
        cols = tuple(placed)
    xt, slots, fps, ts, has, valid = (torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                                      for c in cols)
    score_args = (torch.from_numpy(rng.standard_normal(d).astype(np.float32) * 0.2).to(dev),
                  torch.tensor(0.1, device=dev))
    return (lambda: mon.fused_flush(xt, valid, n, score_args, _raw_score_linear,
                                    ledger_rows=(slots, fps, ts, has))), 1


def _wide_flush(mesh):
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.crosses import widen_scaler, widen_with_crosses
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit
    from fraud_detection_tpu_torch.ops.scorer import BatchScorer

    dev, spec = mesh.device, _cross_spec()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((ROWS, FEATURES)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) * 40_000  # Time
    x[:, -1] = np.abs(x[:, -1]) * 150  # Amount
    fps = _fingerprints(ROWS)
    table = (rng.standard_normal(spec.buckets) * 0.2).astype(np.float32)
    coef = np.concatenate([rng.standard_normal(FEATURES).astype(np.float32) * 0.3,
                           np.ones(spec.n_cross, np.float32)])
    scorer = BatchScorer(LogisticParams(torch.from_numpy(coef), torch.tensor(-1.0)),
                         widen_scaler(scaler_fit(torch.from_numpy(x)), spec.n_cross),
                         device=dev, wide_spec=spec, wide_table=table)
    xw = widen_with_crosses(x, fps, table, spec, device=dev)
    mon = MeshDriftMonitor(build_baseline_profile(xw, rng.random(ROWS).astype(np.float32),
                                                  device=dev), mesh)
    rows = list(x[:FLUSH_ROWS])
    return lambda: _flush(mon, scorer, rows, 3, fps[:FLUSH_ROWS]), 1


def _sharded_update(mesh):
    from fraud_detection_tpu_torch.mesh.retrain import mesh_sgd_fit

    x, y = _rows()
    xt = torch.from_numpy(x).to(mesh.device)
    return (lambda: mesh_sgd_fit(xt, y, epochs=1, batch_size=BATCH, mesh=mesh),
            _steps(ROWS, mesh.global_data, BATCH))


def _wide_update(mesh):
    from fraud_detection_tpu_torch.mesh.retrain import wide_sgd_fit
    from fraud_detection_tpu_torch.ops.crosses import cross_indices

    spec = _cross_spec()
    x, y = _rows()
    fps = _fingerprints(ROWS)
    idx = cross_indices(x, fps, spec, device=mesh.device)
    has = (fps != 0).astype(np.float32)
    return (lambda: wide_sgd_fit(x, idx, has, y, spec, epochs=1, batch_size=BATCH, mesh=mesh),
            _steps(ROWS, mesh.global_data, BATCH))


def _scaler(mesh):
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit_sharded

    x, _ = _rows()
    return lambda: scaler_fit_sharded(torch.from_numpy(x).to(mesh.device), mesh), 1


def _pool_stats(mesh):
    from fraud_detection_tpu_torch.mesh.retrain import mapreduce_pool_stats

    x, y = _rows()
    return lambda: mapreduce_pool_stats(x, y, y * 0.5 + 0.25, mesh=mesh), 1


def _host_tensors(dev):
    x, y = _rows()
    return [torch.from_numpy(a).to(dev) for a in (x, y, y * 0.5 + 0.25, np.ones(ROWS, np.float32))]


def _partial_pool(mesh):
    from fraud_detection_tpu_torch.longhaul.fleet import _host_partial_pool

    args = _host_tensors(mesh.device)
    return lambda: _host_partial_pool(*args), 1


def _fleet_grad(mesh):
    from fraud_detection_tpu_torch.longhaul.fleet import _host_grad

    x, y, _, sw = _host_tensors(mesh.device)
    coef = torch.full((FEATURES,), 0.1, device=mesh.device)
    return lambda: _host_grad(coef, torch.tensor(0.0, device=mesh.device), x, 2 * y - 1, sw), 1


def _pool_merge(mesh):
    from fraud_detection_tpu_torch.longhaul.fleet import MeshReducer, fleet_pool_stats

    x, y = _rows()
    red = MeshReducer(mesh.device)
    return lambda: fleet_pool_stats(x, y, y * 0.5 + 0.25, red, device=mesh.device), 1


def _grad_merge(mesh):
    from fraud_detection_tpu_torch.longhaul.fleet import MeshReducer, fleet_sgd_fit

    x, y = _rows()
    red = MeshReducer(mesh.device)
    return (lambda: fleet_sgd_fit(x, y, red, epochs=1, batch_size=BATCH, device=mesh.device),
            max(1, ROWS // (red.n_hosts * BATCH)))


_NO_DATA_AXIS = ("the rows are row-local (the score, the explain leg) and the drift fold "
                 "is one batched fold over the shard axis: no collective by construction")

BUDGETS: tuple[Budget, ...] = (
    Budget("logistic.sgd_epoch", "ops/logistic.logistic_fit_sgd (sharded step)", "a step",
           {PSUM: 3}, _logistic_sgd,
           note="the step's valid-row count, the coef gradient, the intercept gradient: "
                "JAX's count, its scan body counted once"),
    Budget("gbt.boost_step", "ops/gbt._split_hist", "a tree level",
           {PMAX: 1, PSUM: 1}, _split_level,
           note="JAX declares psum 4 (its segment histograms). The port's split phase "
                "takes the pmax of the shards' max bits, then one exact int64 psum "
                "of the fixed-point cells: the (g, h) channels ride one tensor"),
    Budget("mesh.sharded_flush", "mesh/shardflush._sharded_flush (f32 wire)", "a flush", {},
           _narrow_flush("float32", 0), note=_NO_DATA_AXIS),
    Budget("mesh.quickwire_flush", "mesh/shardflush._sharded_flush (int8 wire)", "a flush",
           {}, _narrow_flush("int8", 0), note=_NO_DATA_AXIS),
    Budget("mesh.lantern_flush", "mesh/shardflush._sharded_flush_explain (f32 wire)",
           "a flush", {}, _narrow_flush("float32", 3), note=_NO_DATA_AXIS),
    Budget("mesh.evergreen_flush",
           "mesh/shardflush._sharded_flush_explain (forest, int8 wire)", "a flush", {},
           _narrow_flush("int8", 3, family=_forest), note=_NO_DATA_AXIS),
    Budget("mesh.ledger_flush", "mesh/shardflush._sharded_flush_ledger", "a flush", {},
           _ledger_flush,
           note="rows placed on the host by slot before the flush; one read-update on the "
                "flattened sub-tables: no collective"),
    Budget("mesh.broadside_flush", "mesh/shardflush._sharded_flush_wide (column-sharded table)",
           "a flush", {PSUM_MODEL: 1}, _wide_flush, grid=True,
           note="JAX's one model-axis psum: ops/crosses._gather_contrib_model assembles the "
                "widened block once a flush, nothing on the data axis. Run with the table "
                "column-sharded (M, buckets/M) at every grid; at a model axis of 1 the "
                "app serves the whole table through the single-device gather instead, "
                "which spends none"),
    Budget("mesh.sharded_update", "mesh/retrain.mesh_sgd_fit (_sharded_update_epoch)",
           "a step", {ALL_GATHER: 1, PSUM: 2, PSUM_SCATTER: 1}, _sharded_update,
           setup={ALL_GATHER: 1},
           note="JAX's count; the fit's closing all_gather of the owned slices is its setup"),
    Budget("mesh.wide_update", "mesh/retrain.wide_sgd_fit (_wide_update_epoch)", "a step",
           {ALL_GATHER: 1, PSUM: 3, PSUM_SCATTER: 1, PSUM_MODEL: 1}, _wide_update, grid=True,
           setup={ALL_GATHER: 1},
           note="JAX declares psum 4 without an axis: three on the data axis (the valid "
                "rows, the base gradient, the intercept) and its fourth, the model-axis "
                "logit assembly, is the port's psum_model in _gather_contrib_model, once a "
                "step over every data shard's rows; the closing all_gather_blocks is the "
                "setup"),
    Budget("scaler.fit_transform", "ops/scaler.scaler_fit_sharded", "a fit", {PSUM: 2},
           _scaler,
           note="JAX's entry point is the single-device fit (none). The port's sharded "
                "scaler reduces the column sums and the centred squares: psum 2"),
    Budget("mesh.mapreduce_pool_stats", "mesh/retrain.mapreduce_pool_stats", "a call",
           {PSUM: 5}, _pool_stats,
           note="the conductor's pool (no JAX contract): n, positives, score sum, Σx, Σx²"),
    Budget("longhaul.partial_pool", "longhaul/fleet._host_partial_pool", "a call", {},
           _partial_pool, note="a host's map body: no collective"),
    Budget("longhaul.fleet_grad", "longhaul/fleet._host_grad", "a call", {}, _fleet_grad,
           note="a host's map body: no collective"),
    Budget("longhaul.pool_merge", "longhaul/fleet.fleet_pool_stats (MeshReducer)", "a call",
           {PSUM: 5}, _pool_merge,
           note="one psum a pool component; MeshReducer has one shard a process, so in one "
                "process the shard count does not reach it"),
    Budget("longhaul.grad_merge", "longhaul/fleet.fleet_sgd_fit (MeshReducer)", "a step",
           {PSUM: 3}, _grad_merge, setup={PSUM: 1},
           note="JAX declares psum 2 a dispatch (coef, intercept) and its step makes three "
                "dispatches of the grad-merge body (6 psums, 3 over zeros). The port takes "
                "one psum an array: coef, intercept, batch count; the geometry reduce "
                "(n_total) is the setup"),
)


def _per_unit(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else f"{v:g}"


def violations(budget: Budget, got: dict, units: int) -> list[str]:
    """``budget`` against one run's counts over ``units`` units."""
    out = []
    for key in sorted(set(budget.counts) | set(budget.setup) | set(got)):
        per = (got.get(key, 0) - budget.setup.get(key, 0)) / max(units, 1)
        want = budget.counts.get(key, 0)
        if per != want:
            out.append(f"{budget.entrypoint}:{key[0]}@{key[1]} expected {want} "
                       f"got {_per_unit(per)}")
    return out


def run_budget(budget: Budget, mesh: Mesh) -> tuple[dict, int]:
    """``budget``'s program once on ``mesh``: ``(counts, units)``, the counts
    zeroed just before the run."""
    run, units = budget.build(mesh)
    reset_collective_counts()
    run()
    return collective_counts(), units


def check_budgets(device=None, shard_counts=SHARD_COUNTS, budgets=BUDGETS) -> list[str]:
    """Every budget's program at each of ``shard_counts`` data shards (a 2-D
    program at each ``(data, model)`` of ``GRIDS``) on ``device`` (``cuda``
    unless the caller asks for the CPU), virtual shards in this process:
    the sorted violations, one stable string each (empty when every
    program holds its budget). Not thread-safe: the counts are the
    process's."""
    dev = resolve_device(device)
    found: set[str] = set()
    for budget in budgets:
        shapes = GRIDS if budget.grid else [(n, 1) for n in shard_counts]
        for data, model in shapes:
            mesh = create_mesh(MeshSpec(data=data, model=model), devices=[dev] * (data * model))
            found.update(violations(budget, *run_budget(budget, mesh)))
    return sorted(found)
