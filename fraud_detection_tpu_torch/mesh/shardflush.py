"""The fused flush over the serving mesh's shard axis (the JAX package's
``mesh/shardflush.py``).

JAX runs the flush as one ``shard_map`` program: the staged bucket's rows
split over the mesh, each device scores its rows and folds them into its
own drift window (and, for a ledger model, its own ledger sub-table), and
the windows merge only at scrape time. On the port every shard lives on
the serving device (``parallel/mesh``), so a flush is the single-device
body (``monitor/drift``) run once over the whole bucket with shard-axis
state:

- **the row-local legs run once over the whole bucket**: the score (the
  ``fused_score`` kernel on the card, the forest's batch-invariant margin)
  and the explain leg (``tree_shap`` on the card, linear SHAP). A row's
  bits do not depend on the other rows, so one launch gives exactly each
  shard's results, and a flush launches ``fused_score`` once at every N;
- **the drift fold is one batched fold over the shard axis**: every
  window leaf carries a leading ``(N,)`` axis, shard ``s`` owning rows
  ``[s·b/N, (s+1)·b/N)`` (``drift._fold_serving_batch``). The bin masses
  are sums of {0, 1} weights, so the batched fold is bitwise a fold a
  shard, and the merged window equals the single window's counts exactly
  while no decay is applied (a decayed merge reassociates f32 sums);
- **the ledger read-update is one call on the flattened sub-tables**
  (``ledger/features._ledger_read_update``, index ``s·slots + slot``, the
  batcher having placed each entity's rows in the segment of the shard
  that owns its slot, ``ledger/placement``). A slot's rows keep their
  order, so this is bitwise one call a shard, and the merged table is
  bitwise a single-device replay of the same flushes;
- **the wide family** on a model axis of 1 gathers from the whole cross
  table, which needs no collective. On a ``data × model`` grid
  (``MESH_MODEL_DEVICES > 1``, JAX's broadside flush) the rows split over
  the data axis only and are replicated over the model axis; the table is
  column-sharded, model shard ``m`` owning ``buckets/M`` contiguous
  columns (laid out once a table, :meth:`MeshDriftMonitor.
  _placed_wide_table`); every model shard's partial gather and the one
  sum over the model axis assemble the widened block
  (``ops/crosses._gather_contrib_model``), bitwise the single-device
  gather; the score and the explain leg run once over the bucket; each
  data shard's rows fold into its model-rank-0 window only, so the other
  windows stay zero. The narrow and ledger families split their rows over
  the flattened grid (shard ``d·M + m``), the ledger's slots by ``slot mod
  (D·M)``.

:class:`ShardLoopMonitor` is the oracle: the single-device body called
once a shard on that shard's segment, window and sub-table (the wide
family on a 2-D grid: once a data shard, on its segment and its model
group's windows). The shard-axis flush is held bitwise to it on the CPU
and on the card.

The four flush entry points (``_sharded_flush``, ``_sharded_flush_explain``,
``_sharded_flush_ledger``, ``_sharded_flush_wide``) are what the compile
sentinel wraps as ``mesh.sharded_flush`` (``mesh.quickwire_flush`` on the
int8 wire), ``mesh.lantern_flush``, ``mesh.ledger_flush`` and
``mesh.broadside_flush``; each calls the single-device body itself, not the
sentinel's wrapper of it, so a flush counts once, under its mesh name.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from fraud_detection_tpu_torch.ledger.state import LedgerState, host_state, init_state
from fraud_detection_tpu_torch.monitor import drift as _drift
from fraud_detection_tpu_torch.monitor.baseline import BaselineProfile
from fraud_detection_tpu_torch.monitor.drift import N_CALIB_BINS, DriftMonitor, DriftWindow
from fraud_detection_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from fraud_detection_tpu_torch.parallel.sharding import split_segments

log = logging.getLogger("fraud_detection_tpu_torch.lifeboat")


def init_sharded_window(
    n_shards: int,
    n_features: int,
    n_feature_bins: int,
    n_score_bins: int,
    mesh: Mesh | None = None,
    n_calib_bins: int = N_CALIB_BINS,
    device: str | torch.device | None = None,
) -> DriftWindow:
    """Per-shard drift windows: every :class:`DriftWindow` leaf with a
    leading ``(n_shards,)`` axis, on the mesh's device (or ``device``)."""
    dev = mesh.device if mesh is not None else device

    def z(*shape):
        return torch.zeros((n_shards, *shape), dtype=torch.float32, device=dev)

    return DriftWindow(
        feature_counts=z(n_features, n_feature_bins),
        score_counts=z(n_score_bins),
        calib_count=z(n_calib_bins),
        calib_conf=z(n_calib_bins),
        calib_label=z(n_calib_bins),
        n_rows=z(),
    )


def merge_window(shard_window: DriftWindow) -> DriftWindow:
    """Scrape-time reduce: the per-shard windows summed over the shard
    axis."""
    return DriftWindow(*(t.sum(dim=0) for t in shard_window.tensors()))


def _merge_total(shard_window: DriftWindow, base_window: DriftWindow) -> DriftWindow:
    """The merged shard evidence plus the monitor's own window (where the
    calibration state of labeled feedback replays lives): what ``stats()``
    reads."""
    merged = merge_window(shard_window)
    return DriftWindow(*(a + b for a, b in zip(merged.tensors(), base_window.tensors())))


def init_sharded_ledger(
    n_shards: int, state, slots: int, mesh: Mesh | None = None,
    device: str | torch.device | None = None,
) -> LedgerState:
    """Per-shard ledger sub-tables: every :class:`LedgerState` leaf with a
    leading ``(n_shards,)`` axis, on the mesh's device. Shard ``s`` only
    ever touches the slots with ``slot mod n_shards == s`` (the batcher's
    placement), so a host snapshot (or None: a fresh table) seeds shard
    ``slot mod n_shards``'s sub-table with its own slots and zeros
    elsewhere, the collision and eviction totals on shard 0 — the merge
    (:func:`_merge_ledger`) gives the snapshot back bitwise."""
    dev = mesh.device if mesh is not None else device
    base = host_state(state if state is not None else init_state(slots))
    owner = np.arange(slots) % n_shards

    def split(leaf: np.ndarray, by_slot: bool, dtype) -> torch.Tensor:
        out = np.zeros((n_shards, *leaf.shape), leaf.dtype)
        if by_slot:
            for s in range(n_shards):
                out[s][owner == s] = leaf[owner == s]
        else:
            out[0] = leaf
        return torch.tensor(out.astype(dtype), device=dev)

    return LedgerState(
        acc=split(base.acc, True, np.float32),
        last_ts=split(base.last_ts, True, np.float32),
        fingerprint=split(base.fingerprint, True, np.int64),
        collisions=split(base.collisions, False, np.float32),
        evictions=split(base.evictions, False, np.float32),
    )


def _merge_ledger(shard_ledger: LedgerState) -> LedgerState:
    """Scrape-time reduce of the sub-tables: their slot supports are
    disjoint, so the accumulators and the totals sum exactly and the anchor
    and fingerprint merge by max."""
    return LedgerState(
        acc=shard_ledger.acc.sum(dim=0),
        last_ts=shard_ledger.last_ts.amax(dim=0),
        fingerprint=shard_ledger.fingerprint.amax(dim=0),
        collisions=shard_ledger.collisions.sum(dim=0),
        evictions=shard_ledger.evictions.sum(dim=0),
    )


def _raw(fn):
    """A single-device flush body itself, not the compile sentinel's
    wrapper of it (``functools.wraps`` keeps the original on
    ``__wrapped__``)."""
    return getattr(fn, "__wrapped__", fn)


# -- the shard-axis flushes: one call of the single-device body -------------

def _sharded_flush(shard_window, x, valid, decay, feature_edges, score_edges,
                   score_args, **kw):
    """The plain (f32, bf16 or int8 wire) flush over the shard axis:
    ``drift._fused_flush`` on the whole bucket with the per-shard windows."""
    # lockcheck: hot-path — the sharded flush, once a flush
    return _raw(_drift._fused_flush)(
        shard_window, x, valid, decay, feature_edges, score_edges, score_args, **kw
    )


def _sharded_flush_explain(shard_window, x, valid, decay, feature_edges,
                           score_edges, score_args, explain_args, **kw):
    """The flush with reason codes over the shard axis
    (``drift._fused_flush_explain``): the explain leg is per row, so each
    shard's rows get their codes from the one call."""
    return _raw(_drift._fused_flush_explain)(
        shard_window, x, valid, decay, feature_edges, score_edges, score_args,
        explain_args, **kw,
    )


def _sharded_flush_ledger(shard_window, shard_ledger, x, valid, *rest, **kw):
    """The ledger flush over the shard axis (``drift._fused_flush_ledger``
    with the per-shard windows and sub-tables): the rows must be placed
    (``ledger/placement``) so a shard's segment only holds the entities
    whose slots it owns."""
    # lockcheck: hot-path — the sharded ledger flush, once a flush
    return _raw(_drift._fused_flush_ledger)(
        shard_window, shard_ledger, x, valid, *rest, **kw
    )


def _sharded_flush_wide(shard_window, x, valid, *rest, **kw):
    """The wide flush over the grid (``drift._fused_flush_wide``): on a
    model axis of 1 every shard gathers from the whole table and only the
    fold is per shard; with the table column-sharded ``(M, buckets/M)`` the
    model shards' partials meet in one model-axis sum and each data
    shard's rows fold into its model-rank-0 window."""
    # lockcheck: hot-path — the sharded wide flush, once a flush
    return _raw(_drift._fused_flush_wide)(shard_window, x, valid, *rest, **kw)


# -- the oracle: the single-device body once a shard -------------------------

def _per_shard(body, window, x, valid, rest, kw, ledger=None, rows_at=None, group=1):
    """``body`` on each shard's segment of ``x``/``valid`` (and of the row
    columns at ``rest[rows_at]``) with that shard's window and sub-table:
    views of the shard-axis state, so each call updates it in place.
    ``group`` > 1 takes a segment a data shard and hands the body that
    shard's ``group`` windows (its model group's, leading axis kept).
    Outputs concatenated in row order."""
    n = window.n_rows.shape[0] // group
    xs, vs = split_segments(x, n), split_segments(valid, n)
    cols = tuple(split_segments(c, n) for c in rest[rows_at]) if rows_at is not None else ()
    outs = []
    for s in range(n):
        args = list(rest)
        if rows_at is not None:
            args[rows_at] = tuple(c[s] for c in cols)
        own = s if group == 1 else slice(s * group, (s + 1) * group)
        lead = [DriftWindow(*(t[own] for t in window.tensors()))]
        if ledger is not None:
            lead.append(LedgerState(*(t[s] for t in ledger)))
        outs.append(body(*lead, xs[s], vs[s], *args, **kw))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _loop_flush(window, x, valid, *rest, **kw):
    return _per_shard(_raw(_drift._fused_flush), window, x, valid, rest, kw)


def _loop_flush_explain(window, x, valid, *rest, **kw):
    return _per_shard(_raw(_drift._fused_flush_explain), window, x, valid, rest, kw)


def _loop_flush_ledger(window, ledger, x, valid, *rest, **kw):
    # rest: decay, edges, score edges, score args, ledger_rows, null, halflife
    return _per_shard(_raw(_drift._fused_flush_ledger), window, x, valid, rest, kw,
                      ledger=ledger, rows_at=4)


def _loop_flush_wide(window, x, valid, *rest, **kw):
    # rest: decay, edges, score edges, score args, wide_table, wide_rows; a
    # column-sharded (M, buckets/M) table: once a data shard, its M windows
    group = rest[4].shape[0] if rest[4].dim() == 2 else 1
    return _per_shard(_raw(_drift._fused_flush_wide), window, x, valid, rest, kw,
                      rows_at=5, group=group)


class MeshDriftMonitor(DriftMonitor):
    """Drift monitoring for the serving mesh: a drop-in for
    :class:`~fraud_detection_tpu_torch.monitor.drift.DriftMonitor` behind
    the micro-batcher's fused target. ``fused_flush`` runs the shard-axis
    flushes over ``shard_window`` (and, with a ledger bound, the per-shard
    sub-tables in ``ledger``); labeled feedback replays keep folding into
    the inherited ``window``; ``stats()``, ``ledger_stats()`` and the
    ledger snapshot read the merge."""

    def __init__(
        self,
        profile: BaselineProfile,
        mesh: Mesh,
        halflife_rows: float | None = None,
        min_bucket: int = 8,
    ):
        n_data = int(mesh.shape[DATA_AXIS])
        n_model = int(mesh.shape.get(MODEL_AXIS, 1))
        n_shards = n_data * n_model
        if n_shards & (n_shards - 1):
            raise ValueError(f"mesh grid must be a power of two, got {n_data}×{n_model}")
        if n_shards > min_bucket:
            # the batcher buckets and warms by the scorer's min_bucket: more
            # shards than its smallest bucket would fail every lone-request
            # flush, so refuse at construction
            raise ValueError(
                f"{n_data}×{n_model} = {n_shards} flush shards exceed the "
                f"smallest flush bucket ({min_bucket}) — every bucket must "
                "hand each shard at least one row (see topology.MAX_FLUSH_SHARDS)"
            )
        super().__init__(
            profile, halflife_rows=halflife_rows, min_bucket=min_bucket,
            device=mesh.device,
        )
        self.mesh = mesh
        self.n_data = n_data
        self.n_model = n_model
        self.n_shards = n_shards
        # the cross table column-sharded over the model axis, laid out once
        # a table (see _placed_wide_table)
        self._wide_src = self._wide_placed = None
        self.shard_window = init_sharded_window(
            n_shards, profile.n_features, profile.feature_counts.shape[1],
            profile.score_counts.shape[0], device=self.device,
        )

    def _flush_bodies(self) -> tuple:
        return _sharded_flush, _sharded_flush_explain, _sharded_flush_ledger, _sharded_flush_wide

    def _flush_window(self) -> DriftWindow:
        return self.shard_window

    def _placed_wide_table(self, cross_spec, wide_table: torch.Tensor) -> torch.Tensor:
        """The cross table column-sharded over the model axis: ``(M,
        buckets/M)``, model shard ``m``'s contiguous columns in row ``m``,
        laid out once a table identity (a hot swap brings a new one) — the
        whole table on a model axis of 1. A table the axis does not divide
        raises before any layout."""
        if self.n_model == 1:
            return wide_table
        if cross_spec.buckets % self.n_model:
            raise ValueError(
                f"wide table of {cross_spec.buckets} buckets does not column-shard "
                f"over {self.n_model} model shards: dimension 0 of shape "
                f"({cross_spec.buckets},) not divisible by {self.n_model} model shards"
            )
        if self._wide_src is not wide_table:
            self._wide_placed = wide_table.view(self.n_model, -1)
            self._wide_src = wide_table
        return self._wide_placed

    def _window_for_stats(self) -> DriftWindow:
        return _merge_total(self.shard_window, self.window)

    # -- the lifeboat: the per-shard windows are durable state too ---------
    def shard_window_snapshot(self) -> DriftWindow:
        """A copy of the per-shard windows (leading shard axis), enqueued
        under the lock like :meth:`window_snapshot`'s: a warm restart
        restores per-shard drift evidence exactly, not a merge."""
        with self._lock:
            return DriftWindow(*(t.clone() for t in self.shard_window.tensors()))

    def _restore_windows_locked(self, window, shard_window) -> bool:
        ok = super()._restore_windows_locked(window, shard_window)
        if shard_window is None:
            # a snapshot of a single-window run: the base window restored,
            # the per-shard evidence starts cold
            return ok
        leaves = _drift._window_leaves(shard_window)
        shapes = tuple(tuple(np.shape(leaf)) for leaf in leaves)
        cur = self.shard_window.tensors()
        want = tuple(tuple(t.shape) for t in cur)
        if shapes != want:
            log.warning(
                "per-shard window restore skipped: snapshot shard shapes %s != "
                "live %s (mesh geometry changed since the snapshot)",
                shapes, want,
            )
            return ok
        for t, leaf in zip(cur, leaves):
            t.copy_(torch.as_tensor(leaf, dtype=torch.float32))
        return ok

    # -- the ledger: per-shard sub-tables ----------------------------------
    def bind_ledger(self, spec, state=None) -> None:
        """Split the entity table over the shard axis: shard ``s`` owns the
        slots with ``slot mod n_shards == s`` (the batcher's placement),
        updated in place by every sharded flush and merged at scrape and
        snapshot time."""
        with self._lock:
            self.ledger_spec = spec
            self.ledger = init_sharded_ledger(
                self.n_shards, state, spec.slots, device=self.device
            )
            self._ledger_null = torch.tensor(
                spec.null_features, dtype=torch.float32, device=self.device
            )
            self._ledger_halflife = torch.tensor(
                spec.halflife_s, dtype=torch.float32, device=self.device
            )

    def _ledger_for_stats(self) -> LedgerState:
        return _merge_ledger(self.ledger)


class ShardLoopMonitor(MeshDriftMonitor):
    """The oracle of :class:`MeshDriftMonitor`: the same state, flushed by
    calling the single-device body once a shard on its segment, window and
    sub-table. Its outputs and state are what the shard-axis flush must
    equal bit for bit; it is never served (on the card it launches
    ``fused_score`` once a shard)."""

    def _flush_bodies(self) -> tuple:
        return _loop_flush, _loop_flush_explain, _loop_flush_ledger, _loop_flush_wide
