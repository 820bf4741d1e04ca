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
units, such as a fit's closing gather). Its ``build(mesh, shape=SMALL)``
lays the program out at ``shape`` (:class:`Shape`) on ``mesh`` and returns
``(run, units)``; the shape pass (:mod:`.meshcheck`) calls the same
builders at JAX's meshcheck shapes. :func:`check_budgets` runs every program at
each shard count (or, for a 2-D program, each ``data × model`` grid) of
virtual shards in one process and returns each violation as a stable
string, ``entrypoint:kind@axis expected N got M`` (``M`` the count a unit),
as JAX's ``violation_keys`` are.

Where the port's count differs from JAX's declaration, the budget's note
says why.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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


@dataclass(frozen=True)
class Shape:
    """The shapes a builder lays its program out at: ``rows`` × ``features``
    inputs, a flush's ``flush`` live rows and the ledger flush's ``ledger``
    rows. The budgets and the program contracts run at :data:`SMALL`, the
    shape pass (:mod:`.meshcheck`) at JAX's meshcheck shapes."""

    rows: int = 256
    features: int = 6
    flush: int = 37  # bucket 64
    ledger: int = 64


SMALL = Shape()
ROWS, FEATURES, FLUSH_ROWS = SMALL.rows, SMALL.features, SMALL.flush
BATCH = 16  # the sharded fits' batch
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

def _rows(shape: Shape = SMALL, seed: int = 0):
    rng = np.random.default_rng(seed)
    n, d = shape.rows, shape.features
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


def _cross_spec(d: int):
    from fraud_detection_tpu_torch.ops.crosses import CrossSpec

    return CrossSpec(n_base=d, log2_buckets=6, amount_col=d - 1, time_col=0)


def _fingerprints(n: int, seed: int = 4) -> np.ndarray:
    fps = np.random.default_rng(seed).integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    fps[::5] = 0  # entity-less rows
    return fps


class Run:
    """One run of a program, called with no arguments, and what the program
    contracts read beside its counts: ``state()``, the tensors the run
    must update in place (a window's and a table's leaves), and ``pool``,
    the staging pool it stages through (None for either when the program
    has none)."""

    def __init__(self, fn: Callable[[], object], state: Callable[[], list] | None = None,
                 pool=None):
        self.fn, self.state, self.pool = fn, state, pool

    def __call__(self):
        return self.fn()


#: the context a flush's device part runs in (:func:`check_programs` sets
#: the card's sync check here; the counts are the process's anyway)
_device_part: Callable = contextlib.nullcontext


def _monitor_state(mon) -> list:
    """The tensors a flush through ``mon`` updates in place: the live
    window, the per-shard windows on the mesh monitor, the ledger table."""
    leaves = {id(t): t for t in (*mon.window.tensors(), *mon._flush_window().tensors())}
    if mon.ledger is not None:
        leaves.update((id(t), t) for t in mon.ledger)
    return list(leaves.values())


def _flush(mon, scorer, rows, k: int = 0, fps=None, out_dtype=torch.float32):
    """One fused flush of ``rows`` through ``mon``, staged as the
    micro-batcher stages it (``fps``: the wide family's fingerprints), on
    the return wire ``out_dtype``."""
    from fraud_detection_tpu_torch.ops.scorer import _bucket
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    n = len(rows)
    spec = scorer.fused_spec()
    items = [(rows[i], None, None,
              (0, int(fps[i]), 0.0) if fps is not None and fps[i] else None) for i in range(n)]
    wide_args = spec.wide
    if wide_args is not None and hasattr(mon, "n_model"):  # column-sharded at every grid
        wide_args = (wide_args[0], wide_args[1].view(mon.n_model, -1))
    slot = scorer.staging.acquire(_bucket(n, scorer.min_bucket))
    try:
        hx = scorer.stage_items(slot, items)
        wide_rows = MicroBatcher._stage_wide(scorer, slot, items) if wide_args else None
        x, valid = scorer.to_device(hx), scorer.to_device(slot.valid)
        with _device_part():
            return mon.fused_flush(
                x, valid, n, spec.score_args, spec.score_fn,
                dequant_scale=spec.dequant_scale, score_codes=spec.score_codes,
                out_dtype=out_dtype, explain_args=spec.explain_args if k else None,
                explain_k=k, wide_args=wide_args, wide_rows=wide_rows,
            )
    finally:
        scorer.staging.release(slot)


# -- builders ----------------------------------------------------------------

def _logistic_sgd(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.logistic import logistic_fit_sgd

    x, y = _rows(shape)
    xt = torch.from_numpy(x).to(mesh.device)
    return (lambda: logistic_fit_sgd(xt, y, epochs=1, batch_size=BATCH, mesh=mesh),
            _steps(shape.rows, mesh.global_data, BATCH))


def _split_level(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.gbt import _split_hist

    rng = np.random.default_rng(2)
    n, n_nodes, n_bins = 64 * mesh.size, 4, 16
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(n)))
    args = [torch.from_numpy(a).to(mesh.device) for a in (
        rng.integers(0, n_bins, (n, shape.features)).astype(np.uint8),
        rng.integers(0, n_nodes, n).astype(np.int32),
        (p - (rng.random(n) < 0.5)).astype(np.float32), (p * (1.0 - p)).astype(np.float32))]
    return lambda: _split_hist(*args, n_nodes, n_bins, mesh=mesh, n_total=n), 1


def _linear(dev, wire: str, shape: Shape = SMALL):
    """A logistic scorer on ``wire`` over a scaler fitted on the rows, and
    its drift profile."""
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit
    from fraud_detection_tpu_torch.ops.scorer import BatchScorer

    x, _ = _rows(shape)
    coef = np.random.default_rng(1).standard_normal(shape.features).astype(np.float32) * 0.3
    scorer = BatchScorer(LogisticParams(torch.from_numpy(coef), torch.tensor(-1.0)),
                         scaler_fit(torch.from_numpy(x)), io_dtype=wire, device=dev)
    return scorer, build_baseline_profile(x, scorer.predict_proba(x), device=dev)


def _forest(dev, wire: str, shape: Shape = SMALL):
    """A 4-tree depth-3 forest with TreeSHAP on ``wire`` (int8 with a
    calibration derived from the rows' scaler), and its drift profile."""
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.ops.quant import derive_calibration
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit
    from fraud_detection_tpu_torch.ops.scorer import GBTBatchScorer
    from fraud_detection_tpu_torch.ops.tree_shap import build_tree_explainer

    x, y = _rows(shape)
    model = gbt_fit(x, y, GBTConfig(n_trees=4, max_depth=3, n_bins=16), device=dev)
    cal = derive_calibration(scaler_fit(torch.from_numpy(x))) if wire == "int8" else None
    scorer = GBTBatchScorer(model, io_dtype=wire, calibration=cal,
                            explainer=build_tree_explainer(model, x[:32], seed=0))
    return scorer, build_baseline_profile(x, scorer.predict_proba(x), device=dev)


def _monitor(profile, mesh, sharded: bool):
    """The serving mesh's monitor over ``mesh``, or the single-device one."""
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.monitor.drift import DriftMonitor

    return MeshDriftMonitor(profile, mesh) if sharded else DriftMonitor(profile,
                                                                        device=mesh.device)


def _narrow_flush(wire: str, k: int, family=_linear, out_dtype=torch.float32,
                  sharded: bool = True):
    def build(mesh, shape: Shape = SMALL):
        scorer, profile = family(mesh.device, wire, shape)
        mon = _monitor(profile, mesh, sharded)
        rows = list(_rows(shape)[0][:shape.flush])
        return Run(lambda: _flush(mon, scorer, rows, k, out_dtype=out_dtype),
                   state=lambda: _monitor_state(mon), pool=scorer.staging), 1

    return build


def _ledger_flush(mesh, shape: Shape = SMALL, sharded: bool = True):
    from fraud_detection_tpu_torch.ledger.placement import shard_placement
    from fraud_detection_tpu_torch.ledger.state import LEDGER_K, LedgerSpec
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear

    dev, d, n = mesh.device, shape.features + LEDGER_K, shape.ledger
    spec = LedgerSpec(n_base=shape.features, slots=256, halflife_s=500.0, amount_col=-1,
                      null_features=np.zeros(LEDGER_K, np.float32))
    rng = np.random.default_rng(3)
    mon = _monitor(build_baseline_profile(
        rng.standard_normal((512, d)).astype(np.float32), rng.random(512).astype(np.float32),
        device=dev), mesh, sharded)
    mon.bind_ledger(spec)
    x = rng.standard_normal((n, shape.features)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1]) * 50.0
    owners: dict = {}
    j = 0
    while len(owners) < 8:  # one entity a residue of its slot mod 8
        slot, fp = spec.row_keys(f"card-{j}")
        owners.setdefault(slot % 8, (slot, fp))
        j += 1
    # the even rows the 8 entities', the odd rows entity-less: every shard
    # count up to 8 places the rows evenly, so the bucket is the n rows
    has = (np.arange(n) % 2 == 0).astype(np.float32)
    keys = np.asarray([owners[(i // 2) % 8] if has[i] else (0, 0) for i in range(n)], np.int64)
    cols = (x, keys[:, 0], keys[:, 1], 1.0 + 0.5 * np.arange(n, dtype=np.float32),
            has, np.ones(n, np.float32))
    if sharded and mesh.size > 1:  # each entity's rows in the segment of the shard owning its slot
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
    def run():
        with _device_part():
            return mon.fused_flush(xt, valid, n, score_args, _raw_score_linear,
                                   ledger_rows=(slots, fps, ts, has))

    return Run(run, state=lambda: _monitor_state(mon)), 1


def _wide_flush(mesh, shape: Shape = SMALL, sharded: bool = True):
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
    from fraud_detection_tpu_torch.ops.crosses import widen_scaler, widen_with_crosses
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit
    from fraud_detection_tpu_torch.ops.scorer import BatchScorer

    dev, spec, n, d = mesh.device, _cross_spec(shape.features), shape.rows, shape.features
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) * 40_000  # Time
    x[:, -1] = np.abs(x[:, -1]) * 150  # Amount
    fps = _fingerprints(n)
    table = (rng.standard_normal(spec.buckets) * 0.2).astype(np.float32)
    coef = np.concatenate([rng.standard_normal(d).astype(np.float32) * 0.3,
                           np.ones(spec.n_cross, np.float32)])
    scorer = BatchScorer(LogisticParams(torch.from_numpy(coef), torch.tensor(-1.0)),
                         widen_scaler(scaler_fit(torch.from_numpy(x)), spec.n_cross),
                         device=dev, wide_spec=spec, wide_table=table)
    xw = widen_with_crosses(x, fps, table, spec, device=dev)
    mon = _monitor(build_baseline_profile(xw, rng.random(n).astype(np.float32), device=dev),
                   mesh, sharded)
    rows = list(x[:shape.flush])
    return Run(lambda: _flush(mon, scorer, rows, 3, fps[:shape.flush]),
               state=lambda: _monitor_state(mon), pool=scorer.staging), 1


def _sharded_update(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.mesh.retrain import mesh_sgd_fit

    x, y = _rows(shape)
    xt = torch.from_numpy(x).to(mesh.device)
    return (lambda: mesh_sgd_fit(xt, y, epochs=1, batch_size=BATCH, mesh=mesh),
            _steps(shape.rows, mesh.global_data, BATCH))


def _wide_update(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.mesh.retrain import wide_sgd_fit
    from fraud_detection_tpu_torch.ops.crosses import cross_indices

    spec = _cross_spec(shape.features)
    x, y = _rows(shape)
    fps = _fingerprints(shape.rows)
    idx = cross_indices(x, fps, spec, device=mesh.device)
    has = (fps != 0).astype(np.float32)
    return (lambda: wide_sgd_fit(x, idx, has, y, spec, epochs=1, batch_size=BATCH, mesh=mesh),
            _steps(shape.rows, mesh.global_data, BATCH))


def _scaler(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit_sharded

    x, _ = _rows(shape)
    return lambda: scaler_fit_sharded(torch.from_numpy(x).to(mesh.device), mesh), 1


def _pool_stats(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.mesh.retrain import mapreduce_pool_stats

    x, y = _rows(shape)
    return lambda: mapreduce_pool_stats(x, y, y * 0.5 + 0.25, mesh=mesh), 1


def _host_tensors(dev, shape: Shape):
    x, y = _rows(shape)
    return [torch.from_numpy(a).to(dev)
            for a in (x, y, y * 0.5 + 0.25, np.ones(shape.rows, np.float32))]


def _partial_pool(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.longhaul.fleet import _host_partial_pool

    args = _host_tensors(mesh.device, shape)
    return lambda: _host_partial_pool(*args), 1


def _fleet_grad(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.longhaul.fleet import _host_grad

    x, y, _, sw = _host_tensors(mesh.device, shape)
    coef = torch.full((shape.features,), 0.1, device=mesh.device)
    return lambda: _host_grad(coef, torch.tensor(0.0, device=mesh.device), x, 2 * y - 1, sw), 1


def _pool_merge(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.longhaul.fleet import MeshReducer, fleet_pool_stats

    x, y = _rows(shape)
    red = MeshReducer(mesh.device)
    return lambda: fleet_pool_stats(x, y, y * 0.5 + 0.25, red, device=mesh.device), 1


def _grad_merge(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.longhaul.fleet import MeshReducer, fleet_sgd_fit

    x, y = _rows(shape)
    red = MeshReducer(mesh.device)
    return (lambda: fleet_sgd_fit(x, y, red, epochs=1, batch_size=BATCH, device=mesh.device),
            max(1, shape.rows // (red.n_hosts * BATCH)))


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


# =============================================================================
# Program contracts: the other half of the JAX package's ``Contract``
# =============================================================================
#
# Each of the JAX package's 34 contract entry points (and the port's pool
# reduce) has a :class:`Program`: the port's program, built small by the
# builders above and below, and four properties it holds at every shard
# count (a 2-D program on every grid):
#
# - kernel calls a unit, by kernel (``ops/kernels.dispatch_counts``, on
#   either device; on the card the launches too, equal to them) — the
#   intent of JAX's ``pallas_calls``. Diagnostics ``kernel-count`` (a count
#   off the declaration) and ``missing-kernel`` (a declared kernel not
#   called: the program dropped to a plain body);
# - no host sync between the staged batch and the caller's fetch in a flush
#   — the intent of JAX's ``forbid``. On the card the flush's device part
#   runs under ``torch.cuda.set_sync_debug_mode("error")``; on either
#   device the static rule (:mod:`.hostsync`) reads the bodies the program
#   names. Diagnostic ``host-sync``;
# - the output dtypes — JAX's pinned tuple without its trailing window and
#   table leaves, which the port's flushes fold in place and do not return.
#   Diagnostic ``out-dtype``;
# - in place — the intent of ``donate``: across a run every window leaf
#   (and, for the ledger programs, every table leaf) keeps its storage, and
#   the staging pool allocates nothing over 8 flushes of one bucket after
#   the first. Diagnostic ``dropped-donation``.
#
# A JAX entry point with no port program is ``uncovered-entrypoint``.


def _on(mesh, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device) for a in arrays]


def _linear_args(mesh, shape: Shape):
    coef = np.random.default_rng(1).standard_normal(shape.features).astype(np.float32) * 0.3
    return tuple(_on(mesh, coef, np.float32(-1.0)))


def _score(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear

    (xt,) = _on(mesh, _rows(shape)[0])
    args = _linear_args(mesh, shape)
    return Run(lambda: _raw_score_linear(args, xt)), 1


def _instrumented_score(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear
    from fraud_detection_tpu_torch.telemetry.compile_sentinel import instrument

    wrapped = instrument("contracts.score", _raw_score_linear)
    (xt,) = _on(mesh, _rows(shape)[0])
    args = _linear_args(mesh, shape)
    return Run(lambda: wrapped(args, xt)), 1


def _lbfgs(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.logistic import logistic_fit_lbfgs

    x, y = _rows(shape)
    (xt,) = _on(mesh, x)
    return Run(lambda: logistic_fit_lbfgs(xt, y, max_iter=5, mesh=mesh, sharded=True)), 1


def _gbt_predict(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.gbt import gbt_predict_proba

    scorer, _ = _forest(mesh.device, "float32", shape)
    (xt,) = _on(mesh, _rows(shape)[0])
    return Run(lambda: gbt_predict_proba(scorer._model, xt)), 1


def _smote(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.smote import smote

    x, _ = _rows(shape)
    # a quarter of the rows the minority class (the top quarter of one
    # column): SMOTE adds half the rows, JAX's builder's n_synth at 1024
    y = np.zeros(shape.rows, np.int32)
    y[np.argsort(x[:, 0], kind="stable")[-(shape.rows // 4):]] = 1
    (xt,) = _on(mesh, x)
    return Run(lambda: smote(xt, y, seed=0)), 1


def _linear_shap(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.ops.linear_shap import linear_shap, make_explainer

    (xt,) = _on(mesh, _rows(shape)[0])
    coef, b = _linear_args(mesh, shape)
    explainer = make_explainer(coef, b, background_x=xt[:32])
    return Run(lambda: linear_shap(explainer, xt)), 1


def _tree_shap(raw: bool):
    def build(mesh, shape: Shape = SMALL):
        from fraud_detection_tpu_torch.ops.tree_shap import _raw_tree_shap, tree_shap

        e = _forest(mesh.device, "float32", shape)[0]._resolve_explainer()
        (xt,) = _on(mesh, _rows(shape)[0])
        if raw:  # the kernel body itself, with the explainer's tables
            return Run(lambda: _raw_tree_shap(e.model, e.bg_table, xt, tables=e.tables)), 1
        return Run(lambda: tree_shap(e, xt)), 1

    return build


def _gate_eval(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.lifecycle.gate import (
        N_GATE_CALIB_BINS,
        N_GATE_SCORE_BINS,
        _gate_stats,
    )

    rng = np.random.default_rng(6)
    edges = [np.linspace(0.0, 1.0, n + 1)[1:-1].astype(np.float32)
             for n in (N_GATE_SCORE_BINS, N_GATE_CALIB_BINS)]
    n = shape.rows
    args = _on(mesh, rng.random(n).astype(np.float32), rng.random(n).astype(np.float32),
               (rng.random(n) < 0.3).astype(np.float32), np.ones(n, np.float32), *edges)
    return Run(lambda: _gate_stats(*args)), 1


def _profile(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.monitor.baseline import feature_histogram, score_histogram

    _, profile = _linear(mesh.device, "float32", shape)
    x, y = _rows(shape)
    xt, st, fe, se = _on(mesh, x, y * 0.5 + 0.25, profile.feature_edges, profile.score_edges)
    return Run(lambda: (feature_histogram(xt, fe), score_histogram(st, se))), 1


def _window_update(mesh, shape: Shape = SMALL):
    from fraud_detection_tpu_torch.monitor.drift import DriftMonitor, _window_update

    _, profile = _linear(mesh.device, "float32", shape)
    mon = DriftMonitor(profile, device=mesh.device)
    x, y = _rows(shape)
    ones = np.ones(shape.rows, np.float32)
    rows = _on(mesh, x, y * 0.5 + 0.25, y, ones, ones)

    def run():
        with _device_part():
            return _window_update(mon.window, *rows, 0.5, 0.5, mon._feature_edges,
                                  mon._score_edges, mon._calib_edges)

    return Run(run, state=lambda: _monitor_state(mon)), 1


@dataclass(frozen=True)
class Program:
    """One program's contract: ``kernels`` (``ops/kernels.DISPATCH_KEYS``
    name → calls a ``unit``; those in ``per_shard`` once a shard of the
    mesh a unit), ``out_dtypes`` (None: unpinned), ``bodies`` (the
    functions the static host-sync rule reads, ``"path:function"`` under
    the package; a flush's), and whether the run must keep its state in
    place (``in_place``: a flush)."""

    entrypoint: str  # the JAX package's entry point (or the port's name)
    program: str  # the port's callable
    unit: str
    kernels: dict
    build: Callable[[Mesh], tuple[Callable[[], object], int]]
    out_dtypes: tuple[str, ...] | None = None
    bodies: tuple[str, ...] = ()
    in_place: bool = False
    per_shard: tuple[str, ...] = ()
    grid: bool = False
    note: str = ""


_DRIFT = "monitor/drift.py"
_SHARD = "mesh/shardflush.py"
#: what every serving flush runs around its score: the dispatcher, the
#: wire's inputs, the drift fold and the return wire
_FLUSH = (f"{_DRIFT}:DriftMonitor.fused_flush", f"{_DRIFT}:_fold_serving_batch")
_LINEAR = ("ops/scorer.py:_raw_score_linear",)
_FOREST = ("ops/scorer.py:_raw_score_gbt", "ops/gbt.py:gbt_predict_logits",
           "ops/gbt.py:_predict_logits_dense")
_EXPLAIN = (f"{_DRIFT}:_topk_attributions", "ops/tree_shap.py:_raw_tree_shap")
_PLAIN = _FLUSH + (f"{_DRIFT}:_fused_flush",) + _LINEAR
_LANTERN = _FLUSH + (f"{_DRIFT}:_fused_flush_explain",) + _EXPLAIN
_LEDGER = _FLUSH + (f"{_DRIFT}:_fused_flush_ledger", "ledger/features.py:_ledger_read_update") \
    + _LINEAR + _EXPLAIN
_WIDE = _FLUSH + (f"{_DRIFT}:_fused_flush_wide", "ops/crosses.py:_raw_cross_indices",
                  "ops/crosses.py:_gather_contrib_model") + _LINEAR + _EXPLAIN
_MESH = (f"{_SHARD}:MeshDriftMonitor._flush_window",
         f"{_SHARD}:MeshDriftMonitor._placed_wide_table")

FS, TS, KNN, HIST = {"fused_score": 1}, {"tree_shap": 1}, {"knn_topk": 1}, {"gbt_hist": 1}
_EXPLAIN3 = ("float32", "uint8", "float32")
_EVERGREEN = ("uint8", "uint8", "float16")
_NO_PALLAS = ("JAX declares no pallas_call (an XLA body); the port's score runs the "
              "fused_score kernel, once a flush")
_FOREST_NOTE = ("JAX declares no pallas_call (its XLA TreeSHAP); the port's forest explain "
                "runs the tree_shap kernel, once a flush at depth <= 5; the forest's score is "
                "plain PyTorch")
_NO_KERNEL = "no kernel, as JAX declares"
_FOLDED = ("the window folds in place and is not returned: JAX's six trailing float32 "
           "window leaves are checked in place instead")

PROGRAMS: tuple[Program, ...] = (
    # -- stateless numerics -------------------------------------------------
    Program("scorer.score", "ops/scorer._raw_score_linear", "a batch", FS, _score,
            ("float32",), note="JAX declares no pallas_call; the port's linear score is the "
            "fused_score kernel, once a batch"),
    Program("telemetry.instrumented_score",
            "telemetry/compile_sentinel.instrument(ops/scorer._raw_score_linear)", "a batch",
            FS, _instrumented_score, ("float32",),
            note="JAX declares no pallas_call; the sentinel's wrapper adds no kernel call to "
            "the fused_score launch it wraps"),
    Program("logistic.lbfgs_fit", "ops/logistic.logistic_fit_lbfgs (sharded, 5 iterations)",
            "a fit", {}, _lbfgs, ("float32", "float32"), note=_NO_KERNEL),
    Program("logistic.sgd_epoch", "ops/logistic.logistic_fit_sgd (sharded step)", "a step",
            {}, _logistic_sgd, ("float32", "float32"),
            note="no kernel. JAX pins the epoch program's four leaves (params and velocity); "
            "the port's program is the fit, which returns the params"),
    Program("gbt.boost_step", "ops/gbt._split_hist", "a tree level",
            {"gbt_hist_max": 1, "gbt_hist_accumulate": 1, "gbt_hist": 1, "gbt_hist_finish": 1},
            _split_level, ("float32",),
            per_shard=("gbt_hist_max", "gbt_hist_accumulate", "gbt_hist"),
            note="JAX declares no pallas_call (its segment histograms); the port's split phase "
            "runs gbt_hist's max and accumulate passes once a shard by design (gbt_hist counts "
            "the accumulates) and one finish a level; one shard in one process takes one "
            "whole gbt_hist launch a level instead (ops/gbt.gbt_fit). JAX pins the boost's "
            "trees (int32, int32, float32); the port's unit is a level, its histogram"),
    Program("gbt.predict_proba", "ops/gbt.gbt_predict_proba", "a batch", {}, _gbt_predict,
            ("float32",), note=_NO_KERNEL),
    Program("smote.oversample", "ops/smote.smote", "a call", KNN, _smote, ("float32", "int32"),
            note="JAX declares no pallas_call (its builder forces the XLA k-NN, "
            "use_pallas=False); the port's k-NN is the knn_topk kernel, once a call"),
    Program("linear_shap.batch", "ops/linear_shap.linear_shap", "a batch", {}, _linear_shap,
            ("float32",), note=_NO_KERNEL),
    Program("tree_shap.batch", "ops/tree_shap.tree_shap", "a batch (depth 3)", TS,
            _tree_shap(raw=False), ("float32",),
            note="JAX declares no pallas_call (its XLA body); the port's explainer runs the "
            "tree_shap kernel, once a batch at depth <= 5"),
    Program("scaler.fit_transform", "ops/scaler.scaler_fit_sharded", "a fit", {}, _scaler,
            ("float32",) * 4,
            note="no kernel. JAX pins the transformed rows; the port's program is the sharded "
            "fit, which returns the mean, scale, variance and row count"),
    Program("lifecycle.gate_eval", "lifecycle/gate._gate_stats", "a slice", {}, _gate_eval,
            ("float32",) * 4, note=_NO_KERNEL),
    # -- watchtower -----------------------------------------------------------
    Program("watchtower.baseline_profile",
            "monitor/baseline.feature_histogram + score_histogram", "a profile", {}, _profile,
            ("float32", "float32"), note=_NO_KERNEL),
    Program("watchtower.window_update", "monitor/drift._window_update", "a fold", {},
            _window_update, (), bodies=(f"{_DRIFT}:_window_update",), in_place=True,
            note=f"no kernel; {_FOLDED}"),
    # -- the single-device flushes --------------------------------------------
    Program("fastlane.flush", "monitor/drift._fused_flush (f32 wire)", "a flush", FS,
            _narrow_flush("float32", 0, sharded=False), ("float32",), _PLAIN, True,
            note=f"{_NO_PALLAS}; {_FOLDED}"),
    Program("quickwire.flush", "monitor/drift._fused_flush (int8 wire, uint8 return wire)",
            "a flush", FS, _narrow_flush("int8", 0, out_dtype=torch.uint8, sharded=False),
            ("uint8",), _PLAIN, True, note=f"{_NO_PALLAS}; {_FOLDED}"),
    Program("lantern.flush", "monitor/drift._fused_flush_explain (f32 wire, linear SHAP)",
            "a flush", FS, _narrow_flush("float32", 3, sharded=False), _EXPLAIN3, _LANTERN,
            True, note=f"{_NO_PALLAS}; {_FOLDED}"),
    Program("evergreen.flush",
            "monitor/drift._fused_flush_explain (forest, int8 wire, uint8 return wire)",
            "a flush", TS, _narrow_flush("int8", 3, _forest, torch.uint8, sharded=False),
            _EVERGREEN, _LANTERN + _FOREST, True, note=f"{_FOREST_NOTE}; {_FOLDED}"),
    Program("ledger.flush", "monitor/drift._fused_flush_ledger", "a flush", FS,
            functools.partial(_ledger_flush, sharded=False), ("float32",), _LEDGER, True,
            note=f"{_NO_PALLAS} at d_base + K; {_FOLDED}, and so does the table, whose five "
            "leaves JAX returns: checked in place. The port's table holds the fingerprint "
            "as int64 on the device (JAX declares uint32; the file keeps uint32)"),
    Program("broadside.flush", "monitor/drift._fused_flush_wide (whole table)", "a flush", FS,
            functools.partial(_wide_flush, sharded=False), _EXPLAIN3, _WIDE, True,
            note=f"{_NO_PALLAS} at n_base + n_cross; {_FOLDED}"),
    # -- the TreeSHAP kernel bodies (JAX's chisel entry points) ----------------
    Program("chisel.tree_shap", "ops/tree_shap._raw_tree_shap (the explainer's tables)",
            "a batch (depth 3)", TS, _tree_shap(raw=True), ("float32",),
            note="JAX's one pallas_call: the kernel body with no force flag, since the port's "
            "explainer takes the kernel whenever its depth allows"),
    Program("chisel.lantern_flush", "monitor/drift._fused_flush_explain (forest, f32 wire)",
            "a flush", TS, _narrow_flush("float32", 3, _forest, sharded=False), _EXPLAIN3,
            _LANTERN + _FOREST, True, note=f"JAX's one pallas_call; {_FOLDED}"),
    Program("chisel.evergreen_flush",
            "monitor/drift._fused_flush_explain (forest, int8 wire, uint8 return wire)",
            "a flush", TS, _narrow_flush("int8", 3, _forest, torch.uint8, sharded=False),
            _EVERGREEN, _LANTERN + _FOREST, True,
            note=f"JAX's one pallas_call; the same program as evergreen.flush; {_FOLDED}"),
    # -- the serving mesh's flushes: one call of the single-device body ------
    Program("mesh.sharded_flush", "mesh/shardflush._sharded_flush (f32 wire)", "a flush", FS,
            _narrow_flush("float32", 0), ("float32",),
            _PLAIN + _MESH + (f"{_SHARD}:_sharded_flush",), True,
            note=f"{_NO_PALLAS} at every shard count; {_FOLDED}"),
    Program("mesh.quickwire_flush",
            "mesh/shardflush._sharded_flush (int8 wire, uint8 return wire)", "a flush", FS,
            _narrow_flush("int8", 0, out_dtype=torch.uint8), ("uint8",),
            _PLAIN + _MESH + (f"{_SHARD}:_sharded_flush",), True,
            note=f"{_NO_PALLAS} at every shard count; {_FOLDED}"),
    Program("mesh.lantern_flush", "mesh/shardflush._sharded_flush_explain (f32 wire)",
            "a flush", FS, _narrow_flush("float32", 3), _EXPLAIN3,
            _LANTERN + _MESH + (f"{_SHARD}:_sharded_flush_explain",), True,
            note=f"{_NO_PALLAS} at every shard count; {_FOLDED}"),
    Program("mesh.evergreen_flush",
            "mesh/shardflush._sharded_flush_explain (forest, int8 wire, uint8 return wire)",
            "a flush", TS, _narrow_flush("int8", 3, _forest, torch.uint8), _EVERGREEN,
            _LANTERN + _FOREST + _MESH + (f"{_SHARD}:_sharded_flush_explain",), True,
            note=f"{_FOREST_NOTE}, at every shard count; {_FOLDED}"),
    Program("mesh.ledger_flush", "mesh/shardflush._sharded_flush_ledger", "a flush", FS,
            _ledger_flush, ("float32",), _LEDGER + _MESH + (f"{_SHARD}:_sharded_flush_ledger",),
            True, note=f"{_NO_PALLAS} at every shard count; {_FOLDED}, and so do the "
            "sub-tables (int64 fingerprints; JAX declares uint32): checked in place"),
    Program("mesh.broadside_flush", "mesh/shardflush._sharded_flush_wide (column-sharded table)",
            "a flush", FS, _wide_flush, _EXPLAIN3,
            _WIDE + _MESH + (f"{_SHARD}:_sharded_flush_wide",), True, grid=True,
            note=f"{_NO_PALLAS} on every grid; {_FOLDED}"),
    # -- the sharded fits -----------------------------------------------------
    Program("mesh.sharded_update", "mesh/retrain.mesh_sgd_fit", "a step", {}, _sharded_update,
            ("float32", "float32"),
            note="no kernel. JAX pins the epoch program's four leaves (coef and velocity "
            "slices, intercept and its velocity); the port's program is the fit, which "
            "returns the params"),
    Program("mesh.wide_update", "mesh/retrain.wide_sgd_fit", "a step", {}, _wide_update,
            ("float32",) * 3, grid=True,
            note="no kernel. JAX pins the epoch program's six leaves (with the velocities); "
            "the port's program is the fit, which returns the base coef, the intercept and "
            "the cross table"),
    Program("mesh.mapreduce_pool_stats", "mesh/retrain.mapreduce_pool_stats", "a call", {},
            _pool_stats, ("float64", "float64"),
            note="the conductor's pool (no JAX contract): no kernel; host statistics, the "
            "feature means and deviations in float64"),
    # -- the longhaul fleet's map and merge bodies ----------------------------
    Program("longhaul.partial_pool", "longhaul/fleet._host_partial_pool", "a call", {},
            _partial_pool, ("float32",) * 5, note=_NO_KERNEL),
    Program("longhaul.fleet_grad", "longhaul/fleet._host_grad", "a call", {}, _fleet_grad,
            ("float32", "float32"), note=_NO_KERNEL),
    Program("longhaul.pool_merge", "longhaul/fleet.fleet_pool_stats (MeshReducer)", "a call",
            {}, _pool_merge, ("float64", "float64"),
            note="no kernel. JAX pins the merge program's five float32 psums; the port's "
            "program returns the merged pool's host statistics, the feature means and "
            "deviations in float64"),
    Program("longhaul.grad_merge", "longhaul/fleet.fleet_sgd_fit (MeshReducer)", "a step", {},
            _grad_merge, ("float32", "float32"),
            note="no kernel; JAX pins the merge body's two float32 leaves, the port's fit "
            "returns the coef and the intercept"),
)


def leaves(out) -> tuple:
    """A result's tensor and array leaves, in order (tuples, lists, dicts
    and dataclasses walked; host scalars and strings skipped)."""
    if isinstance(out, (torch.Tensor, np.ndarray)):
        return (out,)
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return sum((leaves(getattr(out, f.name)) for f in dataclasses.fields(out)), ())
    if isinstance(out, (tuple, list)):
        return sum((leaves(o) for o in out), ())
    if isinstance(out, dict):
        return sum((leaves(o) for o in out.values()), ())
    return ()


def dtype_name(leaf) -> str:
    """A tensor's or an array's dtype as JAX names it (``float32``)."""
    return str(leaf.dtype).removeprefix("torch.")


def _dtypes(out) -> tuple[str, ...]:
    """The dtypes of a result's :func:`leaves`, in order."""
    return tuple(dtype_name(leaf) for leaf in leaves(out))


@contextlib.contextmanager
def _strict_sync():
    """A flush's device part on the card: any synchronising CUDA call
    raises; the prior mode is restored whatever happens."""
    prior = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prior)


@contextlib.contextmanager
def _sync_checked(device: torch.device):
    """Runs on ``device`` with every flush's device part under
    :func:`_strict_sync` on the card (nothing to check on the CPU)."""
    global _device_part
    if device.type == "cuda":
        _device_part = _strict_sync
    try:
        yield
    finally:
        _device_part = contextlib.nullcontext


def expected_kernels(program: Program, mesh: Mesh) -> dict:
    """The declared calls a unit on ``mesh``, by kernel."""
    return {k: v * (mesh.size if k in program.per_shard else 1)
            for k, v in program.kernels.items()}


def _kernel_violations(program: Program, calls: dict, units: int, mesh: Mesh) -> list[str]:
    want = expected_kernels(program, mesh)
    out = []
    for name in sorted(set(want) | {k for k, v in calls.items() if v}):
        w, per = want.get(name, 0), calls.get(name, 0) / max(units, 1)
        if per == w:
            continue
        diag = "missing-kernel" if w and not per else "kernel-count"
        out.append(f"{diag}: {name} expected {w} got {_per_unit(per)} a unit")
    return out


def run_program(program: Program, mesh: Mesh, flushes: int = 8) -> dict:
    """``program`` on ``mesh``: one run with the counts zeroed just before
    (``dispatches`` and, on the card, ``launches``, by kernel), then
    ``flushes`` more runs for the staging pool. Returns the counts, the
    units, and ``violations`` (``diagnostic: detail`` strings)."""
    from fraud_detection_tpu_torch.ops import kernels

    run, units = program.build(mesh)
    card = mesh.device.type == "cuda"
    state = getattr(run, "state", None)
    pool = getattr(run, "pool", None)
    before = [t.data_ptr() for t in state()] if program.in_place and state else None
    found: list[str] = []
    kernels.reset_dispatch_counts()
    kernels.reset_launch_counts()
    out = None
    with _sync_checked(mesh.device):
        try:
            out = run()
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            found.append(f"host-sync: {str(e).splitlines()[0]}")
    if card:
        torch.cuda.synchronize(mesh.device)  # the caller's fetch
    dispatches = kernels.dispatch_counts()
    launches = kernels.launches_by_entry() if card else None
    found += _kernel_violations(program, dispatches, units, mesh)
    if card and launches != dispatches:
        found.append(f"kernel-count: launches {launches} != dispatches {dispatches}")
    if program.out_dtypes is not None and out is not None:
        got = _dtypes(out)
        if got != tuple(program.out_dtypes):
            found.append(f"out-dtype: pinned {tuple(program.out_dtypes)}, returned {got}")
    if program.in_place:
        if before is None or before != [t.data_ptr() for t in state()]:
            found.append("dropped-donation: a window or table leaf was rebound")
        if pool is not None:
            allocations = pool.allocations
            for _ in range(flushes):
                run()
                if card:
                    torch.cuda.synchronize(mesh.device)
            if pool.allocations != allocations:
                found.append(f"dropped-donation: the staging pool allocated "
                             f"{pool.allocations - allocations} slots over {flushes} flushes")
    return {"entrypoint": program.entrypoint, "shards": (mesh.data, mesh.model),
            "units": units, "dispatches": dispatches, "launches": launches,
            "violations": found}


def jax_entrypoints() -> tuple[str, ...]:
    """The JAX package's 34 contract entry points, by name (its contract
    table, ``analysis/contracts.py``): each needs a port program."""
    return (
        "scorer.score", "telemetry.instrumented_score", "logistic.lbfgs_fit",
        "logistic.sgd_epoch", "gbt.boost_step", "gbt.predict_proba", "smote.oversample",
        "linear_shap.batch", "tree_shap.batch", "scaler.fit_transform", "lifecycle.gate_eval",
        "watchtower.baseline_profile", "watchtower.window_update", "fastlane.flush",
        "quickwire.flush", "lantern.flush", "evergreen.flush", "ledger.flush",
        "broadside.flush", "chisel.tree_shap", "chisel.lantern_flush",
        "chisel.evergreen_flush", "mesh.sharded_flush", "mesh.quickwire_flush",
        "mesh.lantern_flush", "mesh.evergreen_flush", "mesh.ledger_flush",
        "mesh.broadside_flush", "mesh.sharded_update", "mesh.wide_update",
        "longhaul.partial_pool", "longhaul.fleet_grad", "longhaul.pool_merge",
        "longhaul.grad_merge",
    )


def check_programs(device=None, shard_counts=SHARD_COUNTS, contracts=PROGRAMS,
                   report: list | None = None) -> list[str]:
    """Every program of ``contracts`` at each of ``shard_counts`` data shards
    (a 2-D program on each grid of ``GRIDS``) on ``device`` (``cuda`` unless
    the caller asks for the CPU), virtual shards in this process, and the
    static host-sync rule over each flush's bodies. Returns the sorted
    violations as stable strings ``entrypoint:diagnostic``, as JAX's
    ``violation_keys`` are; a JAX entry point (:func:`jax_entrypoints`)
    with no program is ``uncovered-entrypoint``. ``report``, when given,
    receives each run's :func:`run_program` result. Not thread-safe: the
    counts are the process's."""
    from fraud_detection_tpu_torch.analysis.hostsync import check_bodies

    dev = resolve_device(device)
    keys: set[str] = set()
    for program in contracts:
        if program.bodies and check_bodies(program.bodies):
            keys.add(f"{program.entrypoint}:host-sync")
        shapes = GRIDS if program.grid else [(n, 1) for n in shard_counts]
        for data, model in shapes:
            mesh = create_mesh(MeshSpec(data=data, model=model), devices=[dev] * (data * model))
            res = run_program(program, mesh)
            if report is not None:
                report.append(res)
            keys.update(f"{program.entrypoint}:{v.split(':', 1)[0]}" for v in res["violations"])
    covered = {p.entrypoint for p in contracts}
    keys.update(f"{name}:uncovered-entrypoint"
                for name in jax_entrypoints() if name not in covered)
    return sorted(keys)
