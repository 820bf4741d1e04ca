"""Sharded fits from the command line, in one process or in each rank of a
process group.

    python -m fraud_detection_tpu_torch.shardfit --fit gbt --shards 8 \\
        [--data data/creditcard.csv | --rows 31684 --seed 5] --out DIR
    torchrun --nproc-per-node 2 -m fraud_detection_tpu_torch.shardfit \\
        --fit gbt --fit mesh_sgd --shards 4 --rows 31684 --out DIR
    MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \\
        python -m fraud_detection_tpu_torch.shardfit ...   # and RANK=1

Each rank calls ``parallel.initialize_distributed()`` (a no-op without
``MASTER_ADDR``), lays ``--shards`` data shards on the serving device
(``DEVICE``, default ``cuda``) — ``WORLD_SIZE × --shards`` global shards —
and runs each ``--fit`` over them, every rank on the same host rows (its
own shards' segments kept, as JAX's ``shard_batch`` over a global mesh):

- ``psum``: the collectives' probe — every local shard contributes
  ``rank + 1``, and the ``psum`` over the data axis is printed (a 2 × 4
  group gives 12.0); under a group, of any size, the backend's own
  ``all_reduce`` is probed too;
- ``scaler``: ``ops/scaler.scaler_fit_sharded``;
- ``lbfgs`` / ``sgd``: ``ops/logistic`` on the scaled rows (``sharded=True``
  / ``mesh=``; class weight ``balanced``);
- ``gbt``: ``ops/gbt.gbt_fit(sharded=True)`` on the raw rows
  (``--trees``, ``--depth``, ``--bins``; the recipe's by default);
- ``mesh_sgd``: ``mesh/retrain.mesh_sgd_fit`` on the scaled rows;
- ``wide_sgd``: ``mesh/retrain.wide_sgd_fit`` on the scaled rows and the
  hashed crosses of the raw rows (1,024 buckets, seeded fingerprints, every seventh row without an entity) over a ``--shards ×
  --model`` grid: the table column-sharded over ``--model`` model shards
  in each process.

The fleet fits (``longhaul/fleet``) take the host fleet as their data
axis: each rank takes its contiguous slice of the rows (:func:`fleet_slice`)
and merges through ``--reducer``:

- ``fleet_pool``: ``fleet_pool_stats`` over the slice's raw rows and
  labels, scored through the port's ``BatchScorer`` of ``--model-dir``
  (the ``fused_score`` kernel on the card);
- ``fleet_sgd``: ``fleet_sgd_fit`` at the JAX package's defaults (c 1.0,
  5 epochs, batch 4096, lr 0.3, momentum 0.9, seed 0) over the slice
  scaled by ``--model-dir``'s scaler (the raw rows without one).

``--reducer mesh`` merges through ``MeshReducer`` under the launcher
variables above; ``--reducer socket`` through ``SocketReducer`` with
``--rank`` and ``--hosts`` (default ``RANK`` and ``WORLD_SIZE``) and rank
0 coordinating at ``--coordinator host:port`` (port 0 picks one): rank 0
prints ``FLEET_LISTENING <addr>`` once it listens, and a rank > 0 connects
once, so a launcher starts rank 0 first and hands its address to the rest.

    python -m fraud_detection_tpu_torch.shardfit --fit fleet_sgd \
        --reducer socket --rank 0 --hosts 2 --coordinator 127.0.0.1:0 \
        --data data/creditcard.csv --model-dir models --out DIR   # then rank 1

The rows are the CSV's (``--data``) or ``--rows`` Gaussian rows × 30 from
``np.random.default_rng(--seed)`` with labels from a seeded linear model.
Each rank writes ``DIR/rank<r>.npz`` (every fit's arrays, as
``<fit>_<field>``) and prints one JSON line: rank, world, backend, device,
shards, each fit's wall seconds (host clock, the device synchronised), the
kernel launches and the collective calls (``parallel.collectives``' counts,
``kind@axis``); a fleet fit adds its mean host time a merge and, for
``fleet_sgd``, a step.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez
from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.parallel import collectives
from fraud_detection_tpu_torch.parallel.mesh import (
    MeshSpec,
    backend,
    create_mesh,
    initialize_distributed,
    process_index,
    shutdown_distributed,
)

FITS = ("psum", "scaler", "lbfgs", "sgd", "gbt", "mesh_sgd", "wide_sgd", "fleet_pool",
        "fleet_sgd")
FLEET_FITS = ("fleet_pool", "fleet_sgd")


def synthetic_rows(rows: int, seed: int, d: int = 30) -> tuple[np.ndarray, np.ndarray]:
    """``rows`` Gaussian rows × ``d`` and labels ``x·w > 1`` for a seeded
    Gaussian ``w`` (the chip smoke's forest-fit shape)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d), dtype=np.float32)
    y = (x @ rng.standard_normal(d).astype(np.float32) > 1.0).astype(np.float32)
    return x, y


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fleet_slice(n: int, rank: int, hosts: int) -> slice:
    """Rank ``rank``'s contiguous share of ``n`` rows over ``hosts``."""
    return slice(rank * n // hosts, (rank + 1) * n // hosts)


def fleet_inputs(x: np.ndarray, model) -> np.ndarray:
    """The fleet fit's rows: ``x`` scaled by ``model``'s scaler in float32
    numpy (``x`` itself without a model or a scaler), the same bits on any
    device."""
    if model is None or getattr(model, "scaler", None) is None:
        return np.asarray(x, np.float32)
    mean, scale = (t.detach().cpu().numpy().astype(np.float32)
                   for t in (model.scaler.mean, model.scaler.scale))
    return ((np.asarray(x, np.float32) - mean) / scale).astype(np.float32)


class TimedReducer:
    """A fleet transport with the host time of each merge kept
    (``seconds``, in call order)."""

    def __init__(self, reducer):
        self.reducer = reducer
        self.n_hosts, self.rank = reducer.n_hosts, reducer.rank
        self.seconds: list[float] = []

    def allreduce(self, arrays):
        t = time.perf_counter()
        try:
            return self.reducer.allreduce(arrays)
        finally:
            self.seconds.append(time.perf_counter() - t)


def make_fleet_reducer(args, device):
    """``--reducer``'s transport: ``MeshReducer`` over the process group,
    or ``SocketReducer`` as ``--rank`` of ``--hosts`` at ``--coordinator``
    (rank 0 prints ``FLEET_LISTENING <addr>`` once it listens)."""
    from fraud_detection_tpu_torch.longhaul.fleet import MeshReducer, SocketReducer

    if args.reducer == "mesh":
        return MeshReducer(device)
    red = SocketReducer(args.rank, args.hosts, args.coordinator)
    if red.rank == 0:
        print(f"FLEET_LISTENING {red.addr}", flush=True)
    return red


def run_fleet_fit(fit: str, x: np.ndarray, y: np.ndarray, reducer, model,
                  device) -> dict[str, np.ndarray]:
    """One fleet ``--fit`` over this rank's slice through ``reducer``."""
    from fraud_detection_tpu_torch.longhaul.fleet import fleet_pool_stats, fleet_sgd_fit

    if fit == "fleet_pool":
        if model is None:
            raise SystemExit("--fit fleet_pool scores the pool: it needs --model-dir")
        scores = model.scorer.predict_proba(x)
        st = fleet_pool_stats(x, y, scores, reducer, device=device)
        return {k: np.asarray(st[k]) for k in ("rows", "positives", "label_rate",
                                               "score_mean", "feature_mean", "feature_std")}
    p = fleet_sgd_fit(fleet_inputs(x, model), y, reducer, device=device)
    return {"coef": p.coef.cpu().numpy(), "intercept": p.intercept.cpu().numpy()}


def run_fit(fit: str, x: np.ndarray, y: np.ndarray, mesh, args) -> dict[str, np.ndarray]:
    """One ``--fit`` over ``mesh``: its parameters as host arrays."""
    from fraud_detection_tpu_torch.mesh.retrain import mesh_sgd_fit
    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu_torch.ops.logistic import logistic_fit_lbfgs, logistic_fit_sgd
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit_sharded, scaler_transform

    def host(t) -> np.ndarray:
        return torch.as_tensor(t).detach().cpu().numpy()

    if fit == "psum":
        parts = torch.full((mesh.size,), float(process_index() + 1), device=mesh.device)
        out = {"psum": host(collectives.psum(parts, mesh)),
               "all_gather": host(collectives.all_gather(parts, mesh))}
        if backend() is not None:  # the backend's own all_reduce, as a probe
            import torch.distributed as dist

            probe = torch.ones(1, device=mesh.device if backend() == "nccl" else "cpu")
            dist.all_reduce(probe)
            out["all_reduce"] = host(probe)
        return out
    if fit == "gbt":
        cfg = GBTConfig(n_trees=args.trees, max_depth=args.depth, n_bins=args.bins)
        m = gbt_fit(x, y, cfg, mesh=mesh, sharded=True)
        return {k: host(getattr(m, k)) for k in ("split_feature", "split_bin", "leaf_value")}
    scaler = scaler_fit_sharded(x, mesh)
    if fit == "scaler":
        return {k: host(getattr(scaler, k)) for k in ("mean", "scale", "var")}
    xs = scaler_transform(scaler, torch.from_numpy(x).to(mesh.device))
    if fit == "wide_sgd":
        from fraud_detection_tpu_torch.mesh.retrain import wide_sgd_fit
        from fraud_detection_tpu_torch.ops.crosses import CrossSpec, cross_indices

        fps = np.random.default_rng(args.seed + 1).integers(1, 400, x.shape[0]).astype(np.uint32)
        fps[::7] = 0
        spec = CrossSpec(n_base=x.shape[1], log2_buckets=10, amount_col=x.shape[1] - 1,
                         time_col=0)
        grid = create_mesh(MeshSpec(data=args.shards, model=args.model))
        p, table = wide_sgd_fit(
            xs, cross_indices(x, fps, spec, device=mesh.device), (fps != 0).astype(np.float32),
            y, spec, epochs=4, batch_size=256, lr=0.5, class_weight="balanced", mesh=grid,
        )
        return {"coef": host(p.coef), "intercept": host(p.intercept), "table": host(table)}
    if fit == "lbfgs":
        p = logistic_fit_lbfgs(xs, y, max_iter=200, class_weight="balanced",
                               mesh=mesh, sharded=True)
    elif fit == "sgd":
        p = logistic_fit_sgd(xs, y, epochs=8, batch_size=4096, lr=1.0,
                             class_weight="balanced", mesh=mesh)
    else:
        p = mesh_sgd_fit(xs, y, epochs=8, batch_size=1024, lr=0.5,
                         class_weight="balanced", mesh=mesh)
    return {"coef": host(p.coef), "intercept": host(p.intercept)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fit", action="append", choices=FITS, required=True)
    ap.add_argument("--shards", type=int, default=1, help="data shards in this process")
    ap.add_argument("--data", default=None, help="a creditcard-format CSV")
    ap.add_argument("--rows", type=int, default=31684, help="synthetic rows without --data")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--trees", type=int, default=100)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--bins", type=int, default=256)
    ap.add_argument("--model", type=int, default=1, help="model shards of --fit wide_sgd")
    ap.add_argument("--out", required=True, help="directory for rank<r>.npz")
    ap.add_argument("--reducer", choices=("socket", "mesh"), default="mesh",
                    help="the fleet fits' transport")
    ap.add_argument("--coordinator", default="127.0.0.1:0",
                    help="rank 0's host:port under --reducer socket")
    ap.add_argument("--rank", type=int, default=int(os.environ.get("RANK", 0)),
                    help="this rank under --reducer socket (default RANK)")
    ap.add_argument("--hosts", type=int, default=int(os.environ.get("WORLD_SIZE", 1)),
                    help="ranks under --reducer socket (default WORLD_SIZE)")
    ap.add_argument("--model-dir", default=None,
                    help="the fleet fits' model: scores the pool, scales the SGD rows")
    args = ap.parse_args(argv)
    if args.shards < 1 or args.model < 1:
        ap.error(f"--shards and --model must be at least 1, got {args.shards}, {args.model}")

    initialize_distributed()
    reducer = None
    try:
        mesh = create_mesh(MeshSpec(data=args.shards))
        if args.data:
            from fraud_detection_tpu_torch.data.loader import load_creditcard_csv

            x, y, _ = load_creditcard_csv(args.data)
            x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        else:
            x, y = synthetic_rows(args.rows, args.seed)
        model = None
        if args.model_dir:
            from fraud_detection_tpu_torch.models import load_any_model

            model = load_any_model(args.model_dir, device=mesh.device)
        if any(fit in FLEET_FITS for fit in args.fit):
            reducer = TimedReducer(make_fleet_reducer(args, mesh.device))
            own = fleet_slice(x.shape[0], reducer.rank, reducer.n_hosts)
        arrays, seconds, fleet = {}, {}, {}
        kernels.reset_launch_counts()
        collectives.reset_collective_counts()
        for fit in args.fit:
            _sync(mesh.device)
            t0 = time.perf_counter()
            if fit in FLEET_FITS:
                c0 = len(reducer.seconds)
                out = run_fleet_fit(fit, x[own], y[own], reducer, model, mesh.device)
                merges = reducer.seconds[c0:]
            else:
                out = run_fit(fit, x, y, mesh, args)
            for k, v in out.items():
                arrays[f"{fit}_{k}"] = v
            _sync(mesh.device)
            seconds[fit] = time.perf_counter() - t0
            if fit in FLEET_FITS:
                # a rank's first merge waits for its peers to start
                fleet[fit] = {"merges": len(merges), "first_merge_s": merges[0],
                              "merge_s": float(np.median(merges[1:] or merges))}
            if fit == "fleet_sgd":  # the geometry reduce, then one merge a step
                fleet[fit]["step_s"] = (seconds[fit] - merges[0]) / max(len(merges) - 1, 1)
        rank = reducer.rank if reducer is not None else mesh.process
        os.makedirs(args.out, exist_ok=True)
        atomic_savez(os.path.join(args.out, f"rank{rank}.npz"), **arrays)
        print(json.dumps({
            "rank": rank, "world": reducer.n_hosts if reducer is not None else mesh.processes,
            "backend": backend(), "device": str(mesh.device), "shards": mesh.size,
            "global_shards": mesh.global_data, "seconds": seconds,
            "launches": kernels.launch_counts(),
            "gbt_hist_split": kernels.gbt_hist_split_counts(),
            "collectives": {f"{k}@{a}": n for (k, a), n in
                            sorted(collectives.collective_counts().items())},
            "fleet": fleet,
            "psum": arrays.get("psum_psum", np.zeros(())).tolist(),
        }), flush=True)
    finally:
        if reducer is not None:
            reducer.reducer.close()
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
