#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``fraud_detection_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py

Run from anywhere with the repository beside this file; it needs one CUDA
card, ``nvcc`` (``NVCC``/``CUDA_HOME``/``PATH``) and no network. It imports
nothing of JAX or of the JAX package. Phases, each fatal on failure:

1. **build** — compile every kernel under ``fraud_detection_tpu_torch/
   csrc/`` (one ``nvcc`` per source, started together) and load it.
2. **kernels against their plain versions** — each kernel's wrapper on
   CUDA tensors at the serving path's shapes (and a width that is not a
   multiple of 32) against its plain PyTorch version on the same inputs,
   max |kernel − plain| ≤ 1e-6; then times the kernel, the plain version
   and one library call computing the same function (CUDA events over 200
   calls replayed from one CUDA graph, so the host's launch cost is out of
   the number; eager per-call times are printed beside), against the least
   time the card could take (bytes over 3.35 TB/s, operations over the
   f32 peak).
2b. **knn_topk against its plain version** — rows from
   ``np.random.default_rng(seed)`` at (m, d, k) = (2, 30, 1), (6, 30, 5),
   (126, 30, 5), (158, 30, 5), (1000, 37, 5), (4096, 30, 5),
   (20000, 30, 5) and (100000, 30, 5), a duplicated-rows fixture and a
   lattice fixture (integer points closed under x → −x: every distance
   exact). Exact index equality everywhere below m = 20,000; from there
   the plain version runs on 4,096 sampled query rows against all keys,
   and a mismatched row must be a near-tie (the float64 distances of the
   two selections agree within 1e-5 relative). Times the kernel at
   m = 158 (the default training run's) and m = 100,000 (the 10M-row
   configuration's minority set), the plain version, the operations bound,
   and — as orientation only, since no single PyTorch call has this tie
   rule — ``torch.topk(torch.cdist(xc, xc), k + 1, largest=False)``.
2c. **gbt_hist against its plain version** — the histogram kernel on CUDA
   tensors at the GBT recipe's shapes (31,684 rows × 30 features × 256
   bins, 1 to 16 nodes: every level of the final fit), an odd row count,
   a 16-bin model, the leaf sums (d = 1, 32 bins), a leaf whose rows all
   carry the fit's floor h = 1e-16, and all-zero weight rows, with
   zero-weight rows and rows outside the level mixed in: two launches
   bitwise equal, bitwise equal to the kernel's fixed-point model
   (``gbt_hist_fixed_point_reference``, the same quanta), every cell of
   the kernel and of the plain version within 1e-6·Σ|value| of its float64
   sum (the floored leaf's H: > 0 and within rows · quantum). Times the
   kernel at the five levels and the leaf sums, the plain version, one
   ``index_put_(..., accumulate=True)`` over precomputed cell ids (the
   library column; the port never calls it) and the byte bound, and the
   launch-weighted mean per call over a tree.
2d. **tree_shap against its plain version** — seeded synthetic forests
   (100 trees of depth 5 over d = 30 at n ∈ {1, 9, 1024}; depths 2 and 3;
   every node on feature 0): within rtol 1e-4 / atol 2e-5, equal top-3
   indices, additivity Σφ + E[f] = f(x); ``bin_features`` on the card
   equals the host's numpy binning on a NaN/±inf fixture. Times the kernel
   at n = 1024, the plain version, the bound of the compact form (the
   tables' bytes this run's rows touch, or its operations), and, as
   orientation beside a null library column, the TPU kernel's dense
   three-product form as ``torch.matmul`` (TF32 off).
3. **the served path** — copies ``models/``, builds the drift baseline
   from the first 20,000 rows of ``data/creditcard.csv`` with the port's
   ``build_baseline_profile``, serves the port's app over HTTP on
   localhost with ``SCORER_EXPLAIN=topk`` and the default
   ``SCORER_MAX_BATCH``, sends 256 ``/predict`` requests with real rows
   from 64 threads of a separate client process, then 64 one at a time,
   and checks every score against a float64 numpy computation
   from ``model.npz`` (atol 1e-5), every reason-code list against a numpy
   ranking with the same tie rule, that the fused flush (not the split
   one) served them, that ``/monitor/status`` counted the rows, and that
   every kernel of the path launched during the run (its launch count is
   zeroed just before the requests and read just after).
4. **the trained path** — the port's trainer (``train()``, what
   ``python -m fraud_detection_tpu_torch.train`` runs) on the card over
   the committed CSV with its defaults (5 folds, SMOTE, L-BFGS), its
   models and tracking store in a temporary directory; the launch counts
   are zeroed just before and read just after, and ``knn_topk`` must have
   launched exactly 6 times (5 folds + the final fit). The same trainer
   with ``device="cpu"`` must agree on test AUC and CV mean within 2e-3,
   both runs must pass the 0.95 gate and register version 1 in their own
   registries, ``models:/fraud@prod`` must resolve to the card run's
   artifact, and that artifact, loaded on the card, must score 1024 CSV
   rows within 1e-5 of a float64 numpy computation from its ``model.npz``.
   Prints the wall time of each stage (host clock, the device synchronised
   at stage boundaries) and the L-BFGS iterations of each fit.
5. **the GBT trained path** — ``train(model_family="gbt")`` with its
   defaults (100 trees, depth 5, 256 bins, 5 folds with SMOTE) on the card
   and on the CPU over the committed CSV: ``gbt_hist`` launches exactly
   3,600 times (6 fits × 100 trees × 6) and ``knn_topk`` 6 times; card −
   CPU test AUC and CV mean within 5e-3 (a near-tie split may go the other
   way), the same gate verdict; stage times.
6. **the GBT served path** — the card-trained registered artifact served
   over HTTP with ``SCORER_EXPLAIN=topk`` (256 concurrent and 64 sequential
   ``/predict``): scores within 1e-5 of a float64 numpy walk of the forest
   in ``model.npz``; reason codes equal the port's plain TreeSHAP on the
   CPU except across a k-th/(k+1)-th tie within 2e-5 (counted); every
   flush fused; ``tree_shap`` launched at least once per flush; one 1024-row
   flush profiled and timed.

Output: the card's ``nvidia-smi`` name and power limit, per-phase lines,
one ``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi`` line again
(as the tool prints it), and as the last line ``{"ok": true, "device":
{...}}``. Without a card, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_TOL = 1e-6
SCORE_ATOL = 1e-5
N_REQUESTS = 256  # concurrent /predict requests
CLIENTS = 64  # client threads sending them
N_SEQUENTIAL = 64  # then one client, one request at a time
PROFILE_ROWS = 20_000
TIMED_LAUNCHES = 200
KNN_SAMPLE_ROWS = 4096  # plain-version queries at m >= KNN_SAMPLED_FROM
KNN_SAMPLED_FROM = 20_000
KNN_NEAR_TIE_RTOL = 1e-5
TRAIN_AUC_TOL = 2e-3  # card vs CPU training run
TRAIN_SCORED_ROWS = 1024
KNN_LAUNCHES_PER_RUN = 6  # 5 folds + the final fit
HIST_REL_TOL = 1e-6  # |cell − float64 sum| ≤ this · Σ_rows |value|
SHAP_RTOL, SHAP_ATOL = 1e-4, 2e-5  # tree_shap against its plain version
SHAP_TIE = 2e-5  # a reason-code row may differ only across a tie this close
# card vs CPU GBT training run: the card's histograms sum in another order
# than the CPU's, so a split whose two best gains lie within float32
# rounding of each other may go the other way and change the trees after it
GBT_TRAIN_AUC_TOL = 5e-3
#: 6 fits (5 folds + the final fit) x 100 trees x (5 levels + 1 leaf sum)
GBT_HIST_LAUNCHES_PER_RUN = 6 * 100 * 6

#: the kernels each path must launch (its counts zeroed just before it)
SERVED_KERNELS = ("fused_score",)
TRAINED_KERNELS = ("knn_topk",)
GBT_TRAINED_KERNELS = ("gbt_hist", "knn_topk")
GBT_SERVED_KERNELS = ("tree_shap",)

#: every ported kernel: name → (route, source, the TPU kernel it replaces)
KERNELS = {
    "fused_score": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/fused_score.cu",
        "fraud_detection_tpu/ops/pallas_kernels.py:113",
    ),
    "knn_topk": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/knn_topk.cu",
        "fraud_detection_tpu/ops/pallas_kernels.py:179",
    ),
    "gbt_hist": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/gbt_hist.cu",
        "fraud_detection_tpu/ops/gbt.py:275",
    ),
    "tree_shap": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/tree_shap.cu",
        "fraud_detection_tpu/ops/pallas_kernels.py:544",
    ),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = TIMED_LAUNCHES, warm: int = 20) -> float:
    """Per-call time from CUDA events around ``iters`` back-to-back eager
    calls, after ``warm`` untimed ones. For a kernel shorter than its
    launch this reads the host's enqueue rate, not the device."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = TIMED_LAUNCHES, replays: int = 5) -> float:
    """Per-call device time: ``iters`` calls captured into one CUDA graph,
    each replay timed with CUDA events (host launch overhead is out of the
    measurement); the median over ``replays`` replays after one warm one."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[replays // 2]


def profiled_kernels(fn) -> list[tuple[str, float]]:
    """(name, device µs) of every device activity ``fn`` ran, from
    ``torch.profiler``; empty when the profiler saw no device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "device_time", None)
            if us is None:
                us = getattr(evt, "cuda_time", 0.0)
            out.append((evt.name, float(us)))
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_fused_score(seed: int) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    worst = 0.0
    shapes = [(1, 30), (8, 30), (256, 30), (1000, 30), (1024, 30), (20000, 30),
              (1024, 37), (33, 37)]
    inputs = {}
    for n, d in shapes:
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        w = torch.from_numpy(
            (rng.standard_normal(d) / math.sqrt(d)).astype(np.float32)
        ).to(dev)
        b = torch.tensor(-0.5, dtype=torch.float32, device=dev)
        got = kernels.fused_score(w, b, x)
        want = kernels.fused_score_reference(w, b, x)
        torch.cuda.synchronize()
        if got.shape != (n,) or not torch.isfinite(got).all():
            raise AssertionError(f"fused_score ({n}, {d}): bad output {got.shape}")
        err = float((got - want).abs().max())
        print(f"phase2: fused_score n={n} d={d} max_abs_err={err:.3e}")
        if err > KERNEL_TOL:
            raise AssertionError(
                f"fused_score ({n}, {d}) differs from its plain version by "
                f"{err:.3e} > {KERNEL_TOL}"
            )
        worst = max(worst, err)
        inputs[(n, d)] = (x, w, b)

    rows = {}
    for n in (1024, 20000):
        x, w, b = inputs[(n, 30)]
        d = 30
        kernel_fn = lambda: kernels.fused_score(w, b, x)  # noqa: E731
        plain_fn = lambda: kernels.fused_score_reference(w, b, x)  # noqa: E731
        library_fn = lambda: torch.sigmoid(torch.addmv(b, x, w))  # noqa: E731
        ms, plain, library = (graph_ms(f) for f in (kernel_fn, plain_fn, library_fn))
        eager = [eager_ms(f) for f in (kernel_fn, plain_fn, library_fn)]
        n_bytes = 4 * (n * d + d + 1 + n)  # x, w, b read once; scores written
        n_ops = 2 * n * d + 4 * n  # multiply-adds + bias, exp, add, divide
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_FLOPS_PER_S * 1e3
        prof = [
            us for name, us in profiled_kernels(
                lambda: [kernels.fused_score(w, b, x) for _ in range(20)]
            ) if "fused_score" in name
        ]
        dev_us = f"{sum(prof) / len(prof):.3f}" if prof else "not measured"
        rows[n] = {
            "ms": ms, "plain_ms": plain, "library_ms": library,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(
            f"phase2: fused_score timing n={n} d={d} (CUDA events over "
            f"{TIMED_LAUNCHES} launches replayed from a CUDA graph): kernel "
            f"{ms:.6f} ms, plain {plain:.6f} ms, library sigmoid(addmv) "
            f"{library:.6f} ms, bound {rows[n]['bound_ms']:.6f} ms "
            f"({rows[n]['bound_by']}: {n_bytes} B, {n_ops} ops); kernel "
            f"device time {dev_us} us (profiler); eager calls (CUDA events, "
            f"host-bound): kernel {eager[0]:.6f} ms, plain {eager[1]:.6f} ms, "
            f"library {eager[2]:.6f} ms"
        )
    return {"max_abs_err": worst, "timing": rows}


# ---------------------------------------------------------------------------
# phase 2b: knn_topk against its plain version
# ---------------------------------------------------------------------------


def knn_fixtures(seed: int) -> list[tuple[str, object, int]]:
    """(label, rows (m, d) float32, k) for phase 2b, all from one seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for m, d, k in [(2, 30, 1), (6, 30, 5), (126, 30, 5), (158, 30, 5),
                    (1000, 37, 5), (4096, 30, 5), (20000, 30, 5),
                    (100000, 30, 5)]:
        out.append((f"m={m} d={d} k={k}", rng.standard_normal((m, d), dtype=np.float32), k))
    base = rng.standard_normal((40, 30), dtype=np.float32)
    out.append(("duplicated rows (109 = 40 x 2 + 29)",
                np.concatenate([base, base, base[:29]]), 5))
    half = rng.integers(-3, 4, (150, 30))
    out.append(("lattice (300 integer points, closed under x -> -x)",
                np.concatenate([half, -half]).astype(np.float32), 5))
    return out


def knn_inputs(x):
    """Centred rows and their |x|^2 on the card, as ops/smote.py makes them."""
    import torch

    xt = torch.from_numpy(x).cuda()
    xc = (xt - xt.mean(dim=0)).contiguous()
    return xc, (xc * xc).sum(dim=1)


def knn_selection_gap(xc, queries, got, want) -> tuple[int, float, float]:
    """(mismatched rows, max |d64(kernel pick) − d64(plain pick)| over all
    rows and slots, max relative gap over the mismatched rows), the
    distances recomputed in float64 from the centred rows."""
    import torch

    x64 = xc.double()
    q = x64[queries]
    dg = ((x64[got.long()] - q[:, None, :]) ** 2).sum(-1)
    dw = ((x64[want.long()] - q[:, None, :]) ** 2).sum(-1)
    gap = (dg - dw).abs()
    bad = (got != want).any(dim=1)
    rel = (gap / dw.abs().clamp_min(1e-30))[bad]
    return int(bad.sum()), float(gap.max()), float(rel.max()) if rel.numel() else 0.0


def knn_bound(m: int, d: int, k: int) -> tuple[float, str, int, int]:
    n_ops = 2 * m * m * d + 3 * m * m  # FMAs of the dots + combine/compare
    n_bytes = 4 * (m * d + m + m * k)  # xc, sq read once; indices written
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), n_ops, n_bytes


def check_knn_topk(seed: int) -> dict:
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    worst = 0.0
    inputs = {}
    for label, x, k in knn_fixtures(seed):
        m = x.shape[0]
        xc, sq = knn_inputs(x)
        got = kernels.knn_topk(xc, sq, k)
        torch.cuda.synchronize()
        if got.shape != (m, k) or got.dtype != torch.int32:
            raise AssertionError(f"knn_topk {label}: bad output {got.shape} {got.dtype}")
        if m >= KNN_SAMPLED_FROM:
            g = torch.Generator().manual_seed(seed)
            rows = torch.randperm(m, generator=g)[:KNN_SAMPLE_ROWS].sort().values.to(xc.device)
        else:
            rows = torch.arange(m, device=xc.device)
        want = kernels.knn_topk_reference(xc, sq, k, rows=rows)
        mism, gap, rel = knn_selection_gap(xc, rows, got[rows], want)
        print(
            f"phase2b: knn_topk {label}: {mism} of {rows.numel()} checked rows "
            f"mismatched (max |d64 kernel pick - d64 plain pick| {gap:.3e}, "
            f"max relative gap of a mismatched row {rel:.3e})"
        )
        if m < KNN_SAMPLED_FROM and mism:
            raise AssertionError(f"knn_topk {label}: {mism} rows differ from the plain version")
        if rel > KNN_NEAR_TIE_RTOL:
            raise AssertionError(
                f"knn_topk {label}: a mismatched row is no near-tie "
                f"(relative gap {rel:.3e} > {KNN_NEAR_TIE_RTOL})"
            )
        worst = max(worst, gap)
        if m in (158, 100000):
            inputs[m] = (xc, sq, k)
        else:
            del xc, sq, got, want

    rows = {}
    for m in (158, 100000):
        xc, sq, k = inputs[m]
        d = xc.shape[1]
        kernel_fn = lambda: kernels.knn_topk(xc, sq, k)  # noqa: E731
        plain_fn = lambda: kernels.knn_topk_reference(xc, sq, k)  # noqa: E731
        big = m > KNN_SAMPLED_FROM
        ms = graph_ms(kernel_fn, iters=3 if big else TIMED_LAUNCHES,
                      replays=3 if big else 5)
        eager = eager_ms(kernel_fn, iters=3 if big else TIMED_LAUNCHES,
                         warm=1 if big else 20)
        plain = eager_ms(plain_fn, iters=1 if big else 50, warm=1 if big else 5)
        torch.cuda.empty_cache()
        orient_fn = lambda: torch.topk(  # noqa: E731
            torch.cdist(xc, xc), k + 1, largest=False
        )
        orient = eager_ms(orient_fn, iters=2 if big else 50, warm=1 if big else 5)
        torch.cuda.empty_cache()
        bound, by, n_ops, n_bytes = knn_bound(m, d, k)
        rows[m] = {"ms": ms, "plain_ms": plain, "orientation_ms": orient,
                   "bound_ms": bound, "bound_by": by, "eager_ms": eager}
        print(
            f"phase2b: knn_topk timing m={m} d={d} k={k}: kernel {ms:.6f} ms "
            f"(CUDA events over launches replayed from a CUDA graph; eager "
            f"through the wrapper {eager:.6f} ms), plain {plain:.6f} ms "
            f"(eager, CUDA events), bound {bound:.6f} ms ({by}: {n_ops} ops, "
            f"{n_bytes} B); orientation only, two calls "
            f"topk(cdist(xc, xc), k+1): {orient:.6f} ms"
        )
    del inputs
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "timing": rows}


# ---------------------------------------------------------------------------
# phase 2c: gbt_hist against its plain version
# ---------------------------------------------------------------------------


def hist_inputs(rng, n: int, d: int, n_nodes: int, n_bins: int, dev, zero_every: int = 5):
    """Bins, node, g and h on the card as a level of the fit sees them:
    g = p − y, h = p(1 − p) from random margins; every ``zero_every``-th row
    has zero weight and every 11th lies outside the level (inert)."""
    import numpy as np
    import torch

    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(n)))
    yv = (rng.random(n) < 0.5).astype(np.float64)
    g = (p - yv).astype(np.float32)
    h = (p * (1.0 - p)).astype(np.float32)
    g[::zero_every] = 0.0
    h[::zero_every] = 0.0
    local = rng.integers(0, n_nodes, n).astype(np.int32)
    local[::11] = -1
    bins = rng.integers(0, n_bins, (n, d)).astype(np.uint8)
    return tuple(torch.from_numpy(a).to(dev) for a in (bins, local, g, h))


def hist_float64(bins, local, g, h, n_nodes: int, n_bins: int):
    """(float64 sum, float64 Σ|value|) per cell, (d, n_nodes, n_bins, 2)."""
    import torch

    n, d = bins.shape
    keep = (local >= 0)
    seg = ((local.long()[:, None] * n_bins + bins.long())
           + torch.arange(d, device=bins.device)[None, :] * (n_nodes * n_bins))[keep].reshape(-1)
    gh = torch.stack([g, h], 1).double()[keep][:, None, :].expand(-1, d, 2).reshape(-1, 2)
    out = torch.zeros((d * n_nodes * n_bins, 2), dtype=torch.float64, device=bins.device)
    absum = torch.zeros_like(out)
    out.index_add_(0, seg, gh)
    absum.index_add_(0, seg, gh.abs())
    shape = (d, n_nodes, n_bins, 2)
    return out.reshape(shape), absum.reshape(shape)


def hist_bound(n: int, d: int, n_nodes: int, n_bins: int) -> tuple[float, str, int, int]:
    n_bytes = n * d + 12 * n + 8 * d * n_nodes * n_bins  # bins, node/g/h; out
    n_ops = 2 * n * d  # one add of g and one of h per (row, feature)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, n_ops


def check_gbt_hist(seed: int) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    # (label, n, d, n_nodes, n_bins): the final fit's 31,684 rows at every
    # level of the recipe, a fold's odd row count, a 16-bin model, and the
    # leaf sums (one uint8 column of leaf ids, one node, 32 bins) at the
    # final fit's and a fold's row count
    cases = [(f"n=31684 d=30 nodes={nn} bins=256", 31684, 30, nn, 256)
             for nn in (1, 2, 4, 8, 16)]
    cases += [("odd n=25351 d=30 nodes=16 bins=256", 25351, 30, 16, 256),
              ("16 bins n=4099 d=30 nodes=1", 4099, 30, 1, 16),
              ("leaf sums n=31684 d=1 nodes=1 bins=32", 31684, 1, 1, 32),
              ("leaf sums n=25351 d=1 nodes=1 bins=32", 25351, 1, 1, 32)]
    # and the leaf sums with one leaf whose rows all carry the fit's floor
    # h = 1e-16 (its H must come out > 0)
    cases.append(("floored-h leaf sums n=31684 d=1 nodes=1 bins=32", 31684, 1, 1, 32))
    worst = 0.0
    timed = {}
    for label, n, d, nn, nb in cases:
        args = hist_inputs(rng, n, d, nn, nb, dev)
        floored = label.startswith("floored")
        if floored:
            args[3][args[0][:, 0] == 0] = 1e-16
        a, quanta = kernels.gbt_hist_and_quanta(*args, nn, nb)
        b = kernels.gbt_hist(*args, nn, nb)
        plain = kernels.gbt_hist_reference(*args, nn, nb)
        model, model_q = kernels.gbt_hist_fixed_point_reference(*args, nn, nb)
        want, absum = hist_float64(*args, nn, nb)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"gbt_hist {label}: two launches differ")
        if a.shape != (d, nn, nb, 2) or not torch.isfinite(a).all():
            raise AssertionError(f"gbt_hist {label}: bad output {tuple(a.shape)}")
        quanta = tuple(quanta.cpu().tolist())
        if quanta != model_q or not torch.equal(a, model):
            raise AssertionError(f"gbt_hist {label}: not bitwise its fixed-point model "
                                 f"(quanta {quanta} vs {model_q})")
        rel = (a.double() - want).abs() / absum.clamp_min(1e-300)
        rel_p = (plain.double() - want).abs() / absum.clamp_min(1e-300)
        empty = absum == 0
        if bool((a[empty] != 0).any()):
            raise AssertionError(f"gbt_hist {label}: an empty cell is not 0")
        err = float((a - plain).abs().max())
        cpu_plain = kernels.gbt_hist_reference(*(t.cpu() for t in args), nn, nb)
        extra = f"; plain on the card bitwise the CPU's: {torch.equal(plain.cpu(), cpu_plain)}"
        if floored:
            # a floored row rounds up to one quantum (q > 1e-16 here): the
            # floored leaf's H is held to its fixed-point bound, rows · q
            rows_0 = int((args[0][:, 0] == 0).sum())
            h0 = float(a[0, 0, 0, 1])
            if not (h0 > 0.0 and abs(h0 - float(want[0, 0, 0, 1])) <= rows_0 * quanta[1]):
                raise AssertionError(f"gbt_hist {label}: floored leaf H {h0} "
                                     f"({rows_0} rows, q {quanta[1]})")
            extra += f"; floored leaf H {h0:.6e} > 0 ({rows_0} rows at h=1e-16)"
            rel, rel_p = rel[0, 0, 1:], rel_p[0, 0, 1:]
        rel_k, rel_p = float(rel.max()), float(rel_p.max())
        print(f"phase2c: gbt_hist {label}: bitwise equal over two launches and to "
              f"its fixed-point model (quanta g {quanta[0]:.6e}, h {quanta[1]:.6e}); "
              f"max |cell - f64|/sum|v| kernel {rel_k:.3e}, plain {rel_p:.3e}; "
              f"max |kernel - plain| {err:.3e}{extra}")
        # the floored case gates the kernel; the plain version's float32
        # row-order sums are gated on every other case
        if rel_k > HIST_REL_TOL or (rel_p > HIST_REL_TOL and not floored):
            raise AssertionError(
                f"gbt_hist {label}: off its float64 sum by more than "
                f"{HIST_REL_TOL} of sum|v| (kernel {rel_k:.3e}, plain {rel_p:.3e})"
            )
        worst = max(worst, err)
        if n == 31684 and not floored:
            timed[nn if d == 30 else "leaf"] = args
    zero = hist_inputs(rng, 1000, 30, 4, 256, dev, zero_every=1)
    if bool(kernels.gbt_hist(*zero, 4, 256).any()):
        raise AssertionError("gbt_hist: all-zero weight rows gave a nonzero cell")
    print("phase2c: gbt_hist all-zero weight rows (n=1000): every cell 0")

    rows = {}
    for key, args in timed.items():
        bins, local, g, h = args
        n, d = bins.shape
        nn, nb = (1, 32) if key == "leaf" else (key, 256)
        flat = ((local.long()[:, None] * nb + bins.long())
                + torch.arange(d, device=dev)[None, :] * (nn * nb))
        keep = (local >= 0)[:, None].expand(-1, d)
        idx = torch.stack([flat * 2, flat * 2 + 1], -1)[keep].reshape(-1)
        vals = torch.stack([g, h], 1)[:, None, :].expand(-1, d, 2)[keep].reshape(-1)
        kernel_fn = lambda: kernels.gbt_hist(bins, local, g, h, nn, nb)  # noqa: E731
        plain_fn = lambda: kernels.gbt_hist_reference(bins, local, g, h, nn, nb)  # noqa: E731
        library_fn = lambda: torch.zeros(  # noqa: E731
            d * nn * nb * 2, device=dev).index_put_((idx,), vals, accumulate=True)
        ms = graph_ms(kernel_fn)
        eager = eager_ms(kernel_fn)
        plain = eager_ms(plain_fn, iters=50, warm=5)
        library = eager_ms(library_fn, iters=50, warm=5)
        bound, by, n_bytes, n_ops = hist_bound(n, d, nn, nb)
        rows[key] = {"ms": ms, "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound, "bound_by": by, "eager_ms": eager}
        print(f"phase2c: gbt_hist timing n={n} d={d} nodes={nn} bins={nb}: kernel "
              f"{ms:.6f} ms (CUDA events over launches replayed from a CUDA graph; "
              f"eager through the wrapper {eager:.6f} ms), plain {plain:.6f} ms "
              f"(eager), library index_put_(accumulate=True) on precomputed cell "
              f"ids {library:.6f} ms (eager), bound {bound:.6f} ms ({by}: "
              f"{n_bytes} B, {n_ops} ops)")
    # a tree launches each of the six shapes once (5 levels + the leaf sums),
    # so over 100 trees the launch-weighted mean is the plain mean of six
    mean = {k: sum(r[k] for r in rows.values()) / len(rows)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    print(f"phase2c: gbt_hist launch-weighted mean per call over one tree of the "
          f"final fit (100 trees x {len(rows)} shapes): kernel {mean['ms']:.6f} ms, "
          f"plain {mean['plain_ms']:.6f} ms, library {mean['library_ms']:.6f} ms, "
          f"bound {mean['bound_ms']:.6f} ms")
    return {"max_abs_err": worst, "timing": rows, "mean": mean}


# ---------------------------------------------------------------------------
# phase 2d: tree_shap against its plain version
# ---------------------------------------------------------------------------


def synthetic_forest(rng, trees: int, depth: int, d: int, n_bins: int, dev,
                     one_feature: bool = False):
    """A forest at the recipe's shapes with random splits (or every node on
    feature 0), leaf values and sorted edges, on the card."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops.gbt import GBTModel

    nodes = 2**depth - 1
    sf = (np.zeros((trees, nodes)) if one_feature
          else rng.integers(0, d, (trees, nodes))).astype(np.int32)
    return GBTModel(
        split_feature=torch.from_numpy(sf),
        split_bin=torch.from_numpy(rng.integers(0, n_bins - 1, (trees, nodes)).astype(np.int32)),
        leaf_value=torch.from_numpy((0.1 * rng.standard_normal((trees, 2**depth))).astype(np.float32)),
        bin_edges=torch.from_numpy(np.sort(rng.standard_normal((d, n_bins - 1)), axis=1).astype(np.float32)),
        base_logit=torch.tensor(-1.0),
    ).to(dev)


def shap_work(tables, binned) -> tuple[int, int]:
    """(operations, bytes) this run's data needs in compact form: per (row,
    tree) L·D compares and L·D adds (each leaf's level values summed to
    its nodes, the nodes to their features); the tables read once, of
    ``leaf_sums`` only the (tree, leaf, pattern) rows this run's rows hit,
    the bins read and φ written once."""
    import torch

    n, d = binned.shape
    T, L, D = tables.path_feat.shape
    dev = binned.device
    want = (torch.arange(L, device=dev)[:, None] >> (D - 1 - torch.arange(D, device=dev))[None, :]) & 1
    touched = 0
    for t in range(T):
        right = (binned.long()[:, tables.path_feat[t].long()] > tables.path_thr[t]).long()
        viol = ((right != want).long() << torch.arange(D, device=dev)).sum(-1)  # (n, L)
        touched += int(torch.unique(viol * L + torch.arange(L, device=dev)).numel())
    n_ops = 2 * n * T * L * D
    n_bytes = 4 * (touched * D + sum(int(getattr(tables, k).numel()) for k in (
        "path_feat", "path_thr", "node_order", "node_start", "node_count"))) + 4 * n * d * 2
    return n_ops, n_bytes


def dense_shap_form(tables, mask_bits, coef, d: int):
    """The TPU kernel's dense three-product form as matrices: the signed
    one-hot gather (T, d, L·D) with its bias, the block-diagonal subset
    matrix (T, L·D, M·L), and the dense coefficients (T, M·L, d), from the
    Shapley coefficients ``mask_bits`` (T, M, L) and ``coef`` (T, M, D, L).
    Used only to time torch.matmul beside the kernel."""
    import torch

    T, L, D = tables.path_feat.shape
    M = L
    dev = coef.device
    sgn = (2.0 * ((torch.arange(L, device=dev)[:, None]
                   >> (D - 1 - torch.arange(D, device=dev))[None, :]) & 1) - 1.0).reshape(-1)
    onehot = (tables.path_feat.reshape(T, -1, 1).long()
              == torch.arange(d, device=dev)[None, None, :]).float()  # (T, LD, d)
    gmat = (onehot * sgn[None, :, None]).transpose(1, 2).contiguous()  # (T, d, LD)
    bias = sgn[None, :] * (tables.path_thr.reshape(T, -1).float() + 0.5)  # (T, LD)
    bits = ((mask_bits[:, :, :, None] >> torch.arange(D, device=dev)) & 1).float()
    bfull = torch.zeros((T, L * D, M * L), device=dev)
    for l in range(L):
        bfull[:, l * D:(l + 1) * D, l::L] = bits[:, :, l, :].transpose(1, 2)
    cmat = torch.einsum("tmkl,tlkj->tmlj", coef, onehot.reshape(T, L, D, d))
    return gmat, bias, bfull, cmat.reshape(T, M * L, d).contiguous()


def check_tree_shap(seed: int) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.ops.gbt import bin_features, bin_features_host, gbt_predict_logits
    from fraud_detection_tpu_torch.ops.linear_shap import topk_reasons
    from fraud_detection_tpu_torch.ops.tree_shap import _shapley_coefficients, build_tree_explainer

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    d = 30
    cases = [("recipe (100 trees, depth 5)", 100, 5, False, (1, 9, 1024)),
             ("depth 2, 16 trees", 16, 2, False, (33,)),
             ("depth 3, 16 trees", 16, 3, False, (33,)),
             ("duplicate feature (every node on feature 0), depth 3", 4, 3, True, (9,))]
    worst = 0.0
    timed = None
    for label, trees, depth, one, sizes in cases:
        model = synthetic_forest(rng, trees, depth, d, 256, dev, one_feature=one)
        e = build_tree_explainer(model, rng.standard_normal((128, d)).astype(np.float32))
        for n in sizes:
            x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
            binned = bin_features(x, model.bin_edges)
            got = kernels.tree_shap(binned, e.tables)
            want = kernels.tree_shap_reference(binned, model.split_feature, model.split_bin,
                                               model.leaf_value, e.bg_table)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            over = float(((got - want).abs() - SHAP_RTOL * want.abs()).max())
            k = 3
            same_topk = torch.equal(topk_reasons(got, k)[0], topk_reasons(want, k)[0])
            add = float((got.sum(1) + e.expected_value - gbt_predict_logits(model, x)).abs().max())
            print(f"phase2d: tree_shap {label} n={n}: max |kernel - plain| {err:.3e}, "
                  f"top-{k} indices equal {same_topk}, additivity max |sum phi + E[f] "
                  f"- f(x)| {add:.3e}")
            if over > SHAP_ATOL or not same_topk or not torch.isfinite(got).all():
                raise AssertionError(f"tree_shap {label} n={n}: off its plain version")
            if add > 1e-4 + 1e-3 * float(want.abs().sum(1).max()):
                raise AssertionError(f"tree_shap {label} n={n}: not additive ({add:.3e})")
            if one and bool((got[:, 1:] != 0).any()):
                raise AssertionError("tree_shap: attribution off feature 0")
            worst = max(worst, err)
            if n == 1024:
                timed = (model, e, binned)

    # NaN/±inf binning on the card against the host's numpy binning
    edges = np.sort(rng.standard_normal((d, 255)), axis=1).astype(np.float32)
    xb = rng.standard_normal((64, d)).astype(np.float32)
    xb[::3, 0], xb[1::3, 1], xb[2::3, 2] = np.nan, np.inf, -np.inf
    xb[5, 7] = edges[7, 100]
    on_card = bin_features(torch.from_numpy(xb).to(dev), torch.from_numpy(edges).to(dev))
    host = bin_features_host(xb, edges, 256).astype(np.int32)
    if not np.array_equal(on_card.cpu().numpy(), host) or int(host[0, 0]) != 255:
        raise AssertionError("bin_features on the card differs from the host on NaN/inf")
    print("phase2d: bin_features on the card equals the host's numpy binning on a "
          "NaN/+inf/-inf fixture (NaN -> bin 255)")

    model, e, binned = timed
    n = binned.shape[0]
    kernel_fn = lambda: kernels.tree_shap(binned, e.tables)  # noqa: E731
    plain_fn = lambda: kernels.tree_shap_reference(  # noqa: E731
        binned, model.split_feature, model.split_bin, model.leaf_value, e.bg_table)
    ms = graph_ms(kernel_fn, iters=50)
    eager = eager_ms(kernel_fn, iters=50)
    plain = eager_ms(plain_fn, iters=3, warm=1)
    gmat, bias, bfull, cmat = dense_shap_form(
        e.tables, *_shapley_coefficients(model, e.bg_table), binned.shape[1])
    bf = binned.float()

    def dense_fn():
        notc = (torch.matmul(bf, gmat) <= bias[:, None, :]).float()  # (T, n, LD)
        ind = (torch.matmul(notc, bfull) == 0).float()  # (T, n, ML)
        return torch.matmul(ind, cmat).sum(dim=0)

    orient = eager_ms(dense_fn, iters=5, warm=2)
    dense_err = float((dense_fn() - kernel_fn()).abs().max())
    del gmat, bfull, cmat
    torch.cuda.empty_cache()
    n_ops, n_bytes = shap_work(e.tables, binned)
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    row = {"ms": ms, "plain_ms": plain, "orientation_ms": orient, "eager_ms": eager,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    print(f"phase2d: tree_shap timing n={n} (100 trees, depth 5, d=30): kernel "
          f"{ms:.6f} ms (CUDA events over launches replayed from a CUDA graph; "
          f"eager through the wrapper {eager:.6f} ms), plain {plain:.6f} ms (eager), "
          f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}: {n_ops} ops in compact "
          f"form, {n_bytes} B of tables this run's rows touch); orientation only, the "
          f"dense three-product form as torch.matmul (TF32 off) {orient:.6f} ms "
          f"(max |dense - kernel| {dense_err:.3e})")
    return {"max_abs_err": worst, "timing": row}


# ---------------------------------------------------------------------------
# phase 3: the served path
# ---------------------------------------------------------------------------


class ServerThread(threading.Thread):
    """The port's app on its stdlib HTTP server, in its own event loop."""

    def __init__(self, app, port: int):
        super().__init__(name="chip-smoke-server", daemon=True)
        self.app = app
        self.port = port
        self.ready = threading.Event()
        self.error: BaseException | None = None
        self.loop: asyncio.AbstractEventLoop | None = None

    def run(self) -> None:
        from fraud_detection_tpu_torch.service.http import start_server

        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)
        try:
            server = self.loop.run_until_complete(
                start_server(self.app, "127.0.0.1", self.port)
            )
        except BaseException as e:  # reported to the main thread
            self.error = e
            self.ready.set()
            return
        self.ready.set()
        try:
            self.loop.run_forever()
        finally:
            server.close()
            self.loop.run_until_complete(server.wait_closed())
            self.loop.run_until_complete(self.app.shutdown())
            self.loop.close()

    def stop(self) -> None:
        if self.loop is not None and self.is_alive():
            self.loop.call_soon_threadsafe(self.loop.stop)
        self.join(timeout=60)
        if self.is_alive():
            raise RuntimeError("server thread did not stop")


#: the HTTP client, run as its own process so that its threads do not share
#: the server's interpreter: POSTs ``rows`` (a .npy file) to /predict from
#: ``clients`` threads; prints one JSON object of (status, body, seconds)
#: per row in row order, and the wall time
CLIENT = r"""
import http.client, json, sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np

port, rows, clients = int(sys.argv[1]), np.load(sys.argv[2]), int(sys.argv[3])

def one(i):
    t = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/predict", body=json.dumps({"features": rows[i].tolist()}),
                     headers={"content-type": "application/json", "connection": "close"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode(), time.perf_counter() - t
    finally:
        conn.close()

t0 = time.perf_counter()
with ThreadPoolExecutor(max_workers=clients) as pool:
    results = list(pool.map(one, range(len(rows))))
print(json.dumps({"wall": time.perf_counter() - t0, "results": results}))
"""


def drive_clients(port: int, rows, clients: int, work: Path) -> tuple[list, float]:
    """Send ``rows`` to /predict from a client process; returns the
    per-row (status, body, seconds) and the wall time."""
    import numpy as np

    path = work / f"rows_{clients}.npy"
    np.save(path, rows)
    out = subprocess.run(
        [sys.executable, "-c", CLIENT, str(port), str(path), str(clients)],
        capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        raise RuntimeError(f"client process failed: {out.stderr[-2000:]}")
    res = json.loads(out.stdout)
    return res["results"], res["wall"]


def latency_line(lat: list[float]) -> str:
    lat = sorted(lat)
    return (
        f"p50 {lat[len(lat) // 2] * 1e3:.3f} ms, "
        f"p90 {lat[int(len(lat) * 0.9)] * 1e3:.3f} ms, "
        f"max {lat[-1] * 1e3:.3f} ms"
    )


def http_call(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        payload = None if body is None else json.dumps(body)
        headers = {"content-type": "application/json", "connection": "close"}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def topk_total_order(phi, k: int):
    """Top-k indices by IEEE total order, ties to the lower index — the
    rule of the port's topk_reasons, in numpy."""
    import numpy as np

    bits = np.ascontiguousarray(phi, np.float32).view(np.int32)
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).astype(np.int64)
    return np.argsort(-key, axis=1, kind="stable")[:, :k]


def metric_value(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    raise AssertionError(f"{series} missing from /metrics")


def served_path(work: Path) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.monitor.baseline import (
        build_baseline_profile,
        save_profile,
    )
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.service.app import create_app

    model_dir = work / "models"
    shutil.copytree(ROOT / "models", model_dir)
    data = np.loadtxt(
        ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
        max_rows=PROFILE_ROWS, dtype=np.float64,
    )
    if data.shape != (PROFILE_ROWS, 31):
        raise AssertionError(f"creditcard.csv rows have shape {data.shape}")
    x64 = data[:, :30]
    x = x64.astype(np.float32)
    t0 = time.perf_counter()
    model = load_any_model(str(model_dir), device="cuda")
    scores = model.scorer.predict_proba(x)
    profile = build_baseline_profile(
        x, scores, feature_names=model.feature_names, device="cuda"
    )
    save_profile(str(model_dir), profile)
    print(
        f"phase3: baseline profile over {profile.n_rows} rows built in "
        f"{time.perf_counter() - t0:.3f} s"
    )

    os.environ.update(
        DEVICE="cuda", SCORER_EXPLAIN="topk",
        MODEL_PATH=str(model_dir / "model.npz"),
    )
    for knob in ("SCORER_MAX_BATCH", "SCORER_FUSED_FLUSH", "SCORER_EXPLAIN_K",
                 "SCORER_RETURN_WIRE"):
        os.environ.pop(knob, None)
    app = create_app()
    port = free_port()
    server = ServerThread(app, port)
    t0 = time.perf_counter()
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"server did not start: {server.error!r}")
    try:
        batcher = app.state["batcher"]
        if batcher is None or app.state["watchtower"] is None:
            raise AssertionError("app started degraded (no batcher/watchtower)")
        print(
            f"phase3: app started (bucket ladder warmed, max_batch "
            f"{batcher.max_batch}) in {time.perf_counter() - t0:.3f} s"
        )
        n_total = N_REQUESTS + N_SEQUENTIAL
        rows = x[:n_total]

        kernels.reset_launch_counts()
        concurrent, wall = drive_clients(port, rows[:N_REQUESTS], CLIENTS, work)
        sequential, wall_seq = drive_clients(port, rows[N_REQUESTS:], 1, work)
        launches = kernels.launch_counts()
        results = concurrent + sequential

        # --- correctness of what came back ---
        z = np.load(model_dir / "model.npz")
        mean, scale = z["scaler_mean"], z["scaler_scale"]
        logit = ((x64[:n_total] - mean) / scale) @ z["coef"] + z["intercept"]
        want = 1.0 / (1.0 + np.exp(-logit))
        w32 = z["coef"].astype(np.float32) / scale.astype(np.float32)
        phi = w32 * (rows - mean.astype(np.float32))
        k = batcher.explain_k
        want_idx = topk_total_order(phi, k)
        names = model.feature_names
        worst = 0.0
        for i, (status, body, _) in enumerate(results):
            if status != 200:
                raise AssertionError(f"/predict {i}: HTTP {status} {body[:200]!r}")
            out = json.loads(body)
            err = abs(out["score"] - want[i])
            worst = max(worst, err)
            if not (err <= SCORE_ATOL):
                raise AssertionError(
                    f"/predict {i}: score {out['score']} vs {want[i]} (f64)"
                )
            got = [rc["feature"] for rc in out["reason_codes"] or []]
            if got != [names[j] for j in want_idx[i]]:
                raise AssertionError(f"/predict {i}: reason codes {got}")
            vals = [rc["attribution"] for rc in out["reason_codes"]]
            if not np.allclose(vals, phi[i, want_idx[i]], rtol=0, atol=1e-6):
                raise AssertionError(f"/predict {i}: attributions {vals}")
        print(
            f"phase3: {N_REQUESTS} /predict from {CLIENTS} client threads (own "
            f"process) in {wall:.3f} s ({N_REQUESTS / wall:.1f} req/s); latency "
            + latency_line([r[2] for r in concurrent]) + " (client clock)"
        )
        print(
            f"phase3: {N_SEQUENTIAL} /predict one at a time in {wall_seq:.3f} s; "
            "latency " + latency_line([r[2] for r in sequential])
            + f" (client clock); max |score - f64| over all {n_total} "
            f"{worst:.3e}"
        )

        status, body = http_call(port, "GET", "/metrics")
        text = body.decode()
        fused = metric_value(text, 'scorer_flushes_total{path="fused",shard="0"}')
        split = metric_value(text, 'scorer_flushes_total{path="split",shard="0"}')
        flush_count = metric_value(text, "scorer_microbatch_size_count")
        flush_rows = metric_value(text, "scorer_microbatch_size_sum")
        if fused < 1 or split != 0:
            raise AssertionError(f"flush paths: fused {fused}, split {split}")
        if flush_count >= flush_rows:
            raise AssertionError("no flush carried more than one row")
        print(
            f"phase3: flushes fused={fused:g} split={split:g}; {flush_rows:g} "
            f"rows in {flush_count:g} flushes ({flush_rows / flush_count:.2f} "
            "rows/flush)"
        )
        status, body = http_call(port, "GET", "/monitor/status")
        mon = json.loads(body)
        if mon["drift"]["rows_seen"] != n_total:
            raise AssertionError(f"/monitor/status rows_seen {mon['drift']}")
        print(
            f"phase3: /monitor/status rows_seen={mon['drift']['rows_seen']} "
            f"window_rows={mon['drift']['window_rows']:.3f} "
            f"status={mon['status']}"
        )
        for name in SERVED_KERNELS:
            if launches.get(name, 0) < 1:
                raise AssertionError(f"kernel {name} never launched on the path")
        print(f"phase3: kernel launches on the served path {launches}")

        # one full 1024-row fused flush (stage → kernels → fetch): its
        # device activities and its host-clock time
        scorer = batcher.scorer
        target = batcher._fused_target(scorer)
        batch = [(x[i], None) for i in range(1024)]  # (row, future) items
        acts = profiled_kernels(lambda: batcher._flush_device(scorer, target, batch))
        copies = sum(1 for name, _ in acts if "Memcpy" in name or "Memset" in name)
        busy_us = sum(us for _, us in acts)
        by_name: dict[str, list[float]] = {}
        for name, us in acts:
            by_name.setdefault(name[:48], []).append(us)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
        print(
            f"phase3: one 1024-row fused flush with explain: {len(acts) - copies} "
            f"kernel launches + {copies} copies/memsets on the device, "
            f"{busy_us:.3f} us of device activity (profiler); by name: "
            + "; ".join(f"{n} x{len(v)} {sum(v):.3f} us" for n, v in top)
        )
        times = []
        for _ in range(50):
            t = time.perf_counter()
            res = batcher._flush_device(scorer, target, batch)
            times.append(time.perf_counter() - t)
            scorer.staging.release(res[-1])
        times.sort()
        print(
            f"phase3: 1024-row fused flush host time p50 {times[25] * 1e3:.3f} "
            f"ms, min {times[0] * 1e3:.3f} ms over 50 flushes"
        )
    finally:
        server.stop()
    return launches


# ---------------------------------------------------------------------------
# phase 4: the trained path
# ---------------------------------------------------------------------------


def trained_path(work: Path) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.tracking import TrackingClient
    from fraud_detection_tpu_torch.train import train

    csv = str(ROOT / "data" / "creditcard.csv")
    runs = {}
    launches = None
    for dev in ("cuda", "cpu"):
        uri = f"file:{work / dev / 'mlruns'}"
        os.environ["MLFLOW_TRACKING_URI"] = uri
        for knob in ("MLFLOW_AUC_THRESHOLD", "MLFLOW_MODEL_NAME",
                     "MLFLOW_MODEL_STAGE", "MLFLOW_EXPERIMENT"):
            os.environ.pop(knob, None)
        out = str(work / dev / "models")
        t0 = time.perf_counter()
        if dev == "cuda":
            kernels.reset_launch_counts()
        metrics = train(data_csv=csv, out_dir=out, device=dev)
        if dev == "cuda":
            launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        runs[dev] = (metrics, out, uri)
        print(
            f"phase4: train on {dev}: test AUC {metrics['test_auc']:.6f}, CV mean "
            f"{metrics['cv_auc_mean']:.6f}, registered version "
            f"{metrics['registered_version']}, {wall:.3f} s wall; L-BFGS "
            f"iterations per fit {metrics['lbfgs_iters']}"
        )
        print(f"phase4: stages on {dev} (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in metrics["stages"].items()))
    for name in TRAINED_KERNELS:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} never launched on the path")
    if launches["knn_topk"] != KNN_LAUNCHES_PER_RUN:
        raise AssertionError(
            f"knn_topk launched {launches['knn_topk']} times in the card's "
            f"training run, not {KNN_LAUNCHES_PER_RUN}"
        )
    print(f"phase4: kernel launches on the trained path {launches}")
    (card, card_out, card_uri), (cpu, _, cpu_uri) = runs["cuda"], runs["cpu"]
    for key in ("test_auc", "cv_auc_mean"):
        if not abs(card[key] - cpu[key]) <= TRAIN_AUC_TOL:
            raise AssertionError(f"{key}: card {card[key]} vs cpu {cpu[key]}")
    for dev, (m, _, uri) in runs.items():
        if not m["test_auc"] >= 0.95 or m["registered_version"] != 1:
            raise AssertionError(
                f"{dev} run: test AUC {m['test_auc']}, version {m['registered_version']}"
            )
        reg = TrackingClient(uri).registry
        if reg.get_version_by_alias("fraud", "prod") != 1:
            raise AssertionError(f"{dev} registry: @prod is not version 1")
    reg = TrackingClient(card_uri).registry
    art = reg.resolve("models:/fraud@prod")
    if art != reg.artifact_dir("fraud", 1) or not Path(art, "meta.json").exists():
        raise AssertionError(f"models:/fraud@prod resolved to {art}")
    run_id = json.loads(Path(art, "meta.json").read_text())["run_id"]
    with np.load(Path(art) / "model.npz") as z, \
            np.load(Path(card_out) / "model.npz") as o:
        if any(not np.array_equal(z[f], o[f]) for f in z.files):
            raise AssertionError("registered artifact differs from --out-dir's")
    for sidecar in ("quant_calibration.npz", "monitor_profile.npz", "feature_names.json"):
        if not Path(art, sidecar).exists():
            raise AssertionError(f"registered artifact lacks {sidecar}")
    print(
        f"phase4: both runs pass the 0.95 gate as version 1; card - cpu: test "
        f"AUC {card['test_auc'] - cpu['test_auc']:+.3e}, CV mean "
        f"{card['cv_auc_mean'] - cpu['cv_auc_mean']:+.3e}; models:/fraud@prod "
        f"-> {Path(art).relative_to(work)} (run {run_id})"
    )

    model = load_any_model(art, device="cuda")
    data = np.loadtxt(ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
                      max_rows=TRAIN_SCORED_ROWS, dtype=np.float64)
    x64 = data[:, :30]
    got = model.scorer.predict_proba(x64.astype(np.float32))
    with np.load(Path(art) / "model.npz") as z:
        logit = ((x64 - z["scaler_mean"]) / z["scaler_scale"]) @ z["coef"] + z["intercept"]
    want = 1.0 / (1.0 + np.exp(-logit))
    err = float(np.abs(got - want).max())
    if got.shape != (TRAIN_SCORED_ROWS,) or not np.isfinite(got).all() or not err <= SCORE_ATOL:
        raise AssertionError(f"trained artifact scores off by {err:.3e}")
    print(
        f"phase4: the registered artifact on the card scores {TRAIN_SCORED_ROWS} "
        f"CSV rows within {err:.3e} of float64 numpy; on {torch.cuda.get_device_name(0)}"
    )
    return launches


# ---------------------------------------------------------------------------
# phase 5: the GBT trained path
# ---------------------------------------------------------------------------


def gbt_trained_path(work: Path) -> tuple[dict, str]:
    """``train(model_family="gbt")`` with its defaults on the card and on
    the CPU; returns the card run's launch counts and its registered
    artifact directory."""
    import numpy as np

    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.tracking import TrackingClient
    from fraud_detection_tpu_torch.train import train

    csv = str(ROOT / "data" / "creditcard.csv")
    runs = {}
    launches = None
    for dev in ("cuda", "cpu"):
        base = work / f"gbt_{dev}"
        os.environ["MLFLOW_TRACKING_URI"] = f"file:{base / 'mlruns'}"
        t0 = time.perf_counter()
        if dev == "cuda":
            kernels.reset_launch_counts()
        metrics = train(data_csv=csv, out_dir=str(base / "models"), device=dev,
                        model_family="gbt")
        if dev == "cuda":
            launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        runs[dev] = (metrics, base)
        print(f"phase5: train --model gbt on {dev}: test AUC {metrics['test_auc']:.6f}, "
              f"CV mean {metrics['cv_auc_mean']:.6f}, registered version "
              f"{metrics['registered_version']}, {wall:.3f} s wall")
        print(f"phase5: stages on {dev} (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in metrics["stages"].items()))
    for name in GBT_TRAINED_KERNELS:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} never launched on the GBT trained path")
    if launches["gbt_hist"] != GBT_HIST_LAUNCHES_PER_RUN or launches["knn_topk"] != KNN_LAUNCHES_PER_RUN:
        raise AssertionError(f"GBT trained path launched {launches}, not gbt_hist "
                             f"{GBT_HIST_LAUNCHES_PER_RUN} and knn_topk {KNN_LAUNCHES_PER_RUN}")
    print(f"phase5: kernel launches on the GBT trained path {launches}")
    (card, card_base), (cpu, _) = runs["cuda"], runs["cpu"]
    gaps = {k: card[k] - cpu[k] for k in ("test_auc", "cv_auc_mean")}
    for key, gap in gaps.items():
        if not abs(gap) <= GBT_TRAIN_AUC_TOL:
            raise AssertionError(f"GBT {key}: card {card[key]} vs cpu {cpu[key]}")
    verdicts = {dev: m["registered_version"] for dev, (m, _) in runs.items()}
    if verdicts["cuda"] != verdicts["cpu"]:
        raise AssertionError(f"the AUC gate differs: {verdicts}")
    print(f"phase5: card - cpu: test AUC {gaps['test_auc']:+.3e}, CV mean "
          f"{gaps['cv_auc_mean']:+.3e} (tolerance {GBT_TRAIN_AUC_TOL}); the same gate "
          f"verdict on both (registered version {verdicts['cuda']})")
    out = card_base / "models"
    if verdicts["cuda"] is not None:
        reg = TrackingClient(f"file:{card_base / 'mlruns'}").registry
        art = Path(reg.resolve("models:/fraud@prod"))
        with np.load(art / "model.npz") as z, np.load(out / "model.npz") as o:
            if any(not np.array_equal(z[f], o[f]) for f in z.files):
                raise AssertionError("registered forest differs from --out-dir's")
        out = art
    forest_agreement(card_base / "models", runs["cpu"][1] / "models")
    profile_gbt_fit()
    return launches, str(out)


def forest_agreement(card_models: Path, cpu_models: Path) -> None:
    """Whether the card's forests equal the CPU's: the final fit's, from
    the two runs' ``model.npz``, then each fold's, refit on both devices
    from the card's SMOTE'd rows (the trainer's own split, scaler and
    seeds). The card's histograms are int64 fixed-point sums, the CPU's
    float32 row-order sums, so a split whose two best candidates lie within
    float32 rounding may go the other way. For the first such node of a
    fold: both candidates' gains in float64, from the CPU forest's g and h
    at that tree. Prints; gates nothing (phase 5's AUC gaps do)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.data.loader import (
        load_creditcard_csv,
        stratified_kfold_indices,
        stratified_split,
    )
    from fraud_detection_tpu_torch.ops.gbt import (
        GBTConfig,
        bin_features_host,
        compute_bin_edges,
        gbt_fit,
    )
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform
    from fraud_detection_tpu_torch.ops.smote import smote

    with np.load(card_models / "model.npz") as a, np.load(cpu_models / "model.npz") as b:
        same = all(np.array_equal(a[k], b[k]) for k in ("gbt_split_feature", "gbt_split_bin"))
        leaf_gap = float(np.abs(a["gbt_leaf_value"] - b["gbt_leaf_value"]).max())
    print(f"phase5: final forest card vs cpu: splits equal {same}, max |leaf value "
          f"gap| {leaf_gap:.3e}")
    cfg = GBTConfig()
    seed = 42  # train()'s default
    x, y, _ = load_creditcard_csv(str(ROOT / "data" / "creditcard.csv"))
    tr_idx, _ = stratified_split(y, 0.2, seed)
    x_train, y_train = x[tr_idx], y[tr_idx]
    xs = scaler_transform(scaler_fit(torch.as_tensor(x_train, device="cuda")),
                          torch.as_tensor(x_train, device="cuda"))
    for fold, (tr, _) in enumerate(stratified_kfold_indices(y_train, 5, seed)):
        x_tr, y_tr = smote(xs[torch.as_tensor(tr, device="cuda")], y_train[tr], seed + fold)
        card = gbt_fit(x_tr, y_tr, cfg)
        cpu = gbt_fit(x_tr.cpu(), y_tr, cfg)
        sf_k, sb_k = card.split_feature.cpu().numpy(), card.split_bin.cpu().numpy()
        sf_c, sb_c = cpu.split_feature.numpy(), cpu.split_bin.numpy()
        diff = np.argwhere((sf_k != sf_c) | (sb_k != sb_c))
        if diff.size == 0:
            print(f"phase5: fold {fold} forest card vs cpu: every split equal")
            continue
        t, i = (int(v) for v in diff[0])
        x_np = x_tr.cpu().numpy()
        binned = torch.from_numpy(bin_features_host(
            x_np, compute_bin_edges(x_np, cfg.n_bins), cfg.n_bins)).long()
        yv = torch.as_tensor(np.asarray(y_tr), dtype=torch.float32)
        n_internal, depth = sf_c.shape[1], cfg.max_depth
        logits = cpu.base_logit.expand(len(yv)).clone()
        rows = torch.arange(len(yv))
        for tree in range(t):  # the CPU's boosting up to tree t, in its f32 order
            node = torch.zeros(len(yv), dtype=torch.long)
            for _ in range(depth):
                go = binned[rows, cpu.split_feature[tree].long()[node]] > cpu.split_bin[tree][node]
                node = 2 * node + 1 + go.long()
            logits = logits + cpu.leaf_value[tree][node - n_internal]
        p = torch.sigmoid(logits)
        g = (p - yv).double()
        h = torch.clamp_min(p * (1.0 - p), 1e-16).double()
        node = torch.zeros(len(yv), dtype=torch.long)
        for _ in range((i + 1).bit_length() - 1):  # rows down to node i's level
            go = binned[rows, cpu.split_feature[t].long()[node]] > cpu.split_bin[t][node]
            node = 2 * node + 1 + go.long()
        m = node == i
        gl = torch.stack([torch.bincount(binned[m, f], g[m], cfg.n_bins)
                          for f in range(binned.shape[1])]).cumsum(1)
        hl = torch.stack([torch.bincount(binned[m, f], h[m], cfg.n_bins)
                          for f in range(binned.shape[1])]).cumsum(1)
        gt, ht = gl[:, -1:], hl[:, -1:]
        lam = cfg.reg_lambda
        gain = 0.5 * (gl**2 / (hl + lam) + (gt - gl)**2 / (ht - hl + lam)
                      - gt**2 / (ht + lam)) - cfg.gamma
        valid = (hl >= cfg.min_child_weight) & (ht - hl >= cfg.min_child_weight)
        valid[:, -1] = False
        gain = torch.where(valid, gain, -torch.inf)

        def cand(f, b):
            return f"({f}, {b}) gain " + (f"{float(gain[f, b]):.9e}" if b < cfg.n_bins - 1
                                          else "none (no split)")

        g_k, g_c = float(gain[sf_k[t, i], sb_k[t, i]]), float(gain[sf_c[t, i], sb_c[t, i]])
        rel = abs(g_k - g_c) / max(abs(g_k), abs(g_c), 1e-300)
        best = divmod(int(torch.argmax(gain)), cfg.n_bins)
        print(f"phase5: fold {fold} forest card vs cpu: first split difference at tree {t} "
              f"node {i} ({int(m.sum())} rows); float64 from the CPU's g, h: card "
              f"{cand(sf_k[t, i], sb_k[t, i])}, cpu {cand(sf_c[t, i], sb_c[t, i])}, relative "
              f"gap {rel:.3e} (float32 eps 5.96e-08); float64 best {best}; "
              f"{len(diff)} of {sf_c.size} splits differ")


def profile_gbt_fit() -> None:
    """One forest fit with the recipe at the final fit's shape (31,684 × 30
    Gaussian rows from a seed, labels from a seeded linear model) on the
    card: its wall time, then the same fit under ``torch.profiler`` for the
    device's busy time by kernel. Busy share = device busy / unprofiled
    wall. Its launches come after phase 5's counts were read."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((31684, 30), dtype=np.float32)).cuda()
    y = (x.cpu().numpy() @ rng.standard_normal(30).astype(np.float32) > 1.0).astype(np.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    gbt_fit(x, y, GBTConfig())
    wall = time.perf_counter() - t
    acts = profiled_kernels(lambda: gbt_fit(x, y, GBTConfig()))
    busy_us = sum(us for _, us in acts)
    hist_us = [us for name, us in acts if "gbt_hist" in name]
    by_name: dict[str, list[float]] = {}
    for name, us in acts:
        by_name.setdefault(name[:48], []).append(us)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    print(f"phase5: one recipe fit at 31684 x 30 on the card: {wall:.3f} s wall; under "
          f"the profiler {len(acts)} device activities, {busy_us / 1e3:.3f} ms busy "
          f"({100 * busy_us / 1e6 / wall:.1f}% of the unprofiled wall); gbt_hist's "
          f"kernels x{len(hist_us)} {sum(hist_us) / 1e3:.3f} ms; top by name: "
          + "; ".join(f"{n} x{len(v)} {sum(v) / 1e3:.3f} ms" for n, v in top))


# ---------------------------------------------------------------------------
# phase 6: the GBT served path
# ---------------------------------------------------------------------------


def forest_logits_f64(directory: Path, x32):
    """A float64 numpy walk of the forest in ``model.npz``: bins by the
    float32 comparisons the model makes (NaN to the last bin), leaf values
    summed in float64."""
    import numpy as np

    with np.load(directory / "model.npz") as z:
        sf, sb = z["gbt_split_feature"], z["gbt_split_bin"]
        leaf, edges = z["gbt_leaf_value"].astype(np.float64), z["gbt_bin_edges"]
        base = float(z["gbt_base_logit"])
    n, d = x32.shape
    bins = np.stack([np.searchsorted(edges[f], x32[:, f], side="left") for f in range(d)], 1)
    bins[np.isnan(x32)] = edges.shape[1]
    n_internal = sf.shape[1]
    logit = np.full(n, base)
    rows = np.arange(n)
    for t in range(sf.shape[0]):
        node = np.zeros(n, np.int64)
        while True:
            internal = node < n_internal
            if not internal.any():
                break
            go = bins[rows, sf[t, np.minimum(node, n_internal - 1)]] > sb[t, np.minimum(node, n_internal - 1)]
            node = np.where(internal, 2 * node + 1 + go, node)
        logit += leaf[t, node - n_internal]
    return logit


def gbt_served_path(work: Path, art_dir: str) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.ops.tree_shap import tree_shap
    from fraud_detection_tpu_torch.service.app import create_app

    model_dir = work / "gbt_served"
    shutil.copytree(art_dir, model_dir)
    for f in ("model.npz", "monitor_profile.npz", "feature_names.json"):
        if not (model_dir / f).exists():
            raise AssertionError(f"the trained GBT artifact lacks {f}")
    data = np.loadtxt(ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
                      max_rows=N_REQUESTS + N_SEQUENTIAL, dtype=np.float64)
    x = data[:, :30].astype(np.float32)
    os.environ.update(DEVICE="cuda", SCORER_EXPLAIN="topk",
                      MODEL_PATH=str(model_dir / "model.npz"))
    for knob in ("SCORER_MAX_BATCH", "SCORER_FUSED_FLUSH", "SCORER_EXPLAIN_K",
                 "SCORER_RETURN_WIRE"):
        os.environ.pop(knob, None)
    app = create_app()
    port = free_port()
    server = ServerThread(app, port)
    t0 = time.perf_counter()
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"server did not start: {server.error!r}")
    try:
        batcher = app.state["batcher"]
        if batcher is None or app.state["watchtower"] is None:
            raise AssertionError("GBT app started degraded (no batcher/watchtower)")
        print(f"phase6: GBT app started (bucket ladder warmed, explainer and its "
              f"kernel tables built) in {time.perf_counter() - t0:.3f} s")
        _, body = http_call(port, "GET", "/metrics")
        before = {key: metric_value(body.decode(), key) for key in (
            'scorer_flushes_total{path="fused",shard="0"}',
            'scorer_flushes_total{path="split",shard="0"}',
            "scorer_microbatch_size_count")}
        kernels.reset_launch_counts()
        concurrent, wall = drive_clients(port, x[:N_REQUESTS], CLIENTS, work)
        sequential, wall_seq = drive_clients(port, x[N_REQUESTS:], 1, work)
        launches = kernels.launch_counts()
        results = concurrent + sequential
        _, body = http_call(port, "GET", "/metrics")
        text = body.decode()
        delta = {key: metric_value(text, key) - v for key, v in before.items()}
        flushes = delta["scorer_microbatch_size_count"]

        want = 1.0 / (1.0 + np.exp(-forest_logits_f64(model_dir, x)))
        ref = load_any_model(str(model_dir), device="cpu")
        phi = tree_shap(ref.raw_explainer(), torch.from_numpy(x)).numpy()
        k = batcher.explain_k
        want_idx = topk_total_order(phi, k)
        srt = -np.sort(-phi, axis=1)
        names = ref.feature_names
        worst, tie_rows = 0.0, 0
        for i, (status, body, _) in enumerate(results):
            if status != 200:
                raise AssertionError(f"/predict {i}: HTTP {status} {body[:200]!r}")
            out = json.loads(body)
            err = abs(out["score"] - want[i])
            worst = max(worst, err)
            if not err <= SCORE_ATOL:
                raise AssertionError(f"/predict {i}: score {out['score']} vs {want[i]} (f64)")
            got = [rc["feature"] for rc in out["reason_codes"] or []]
            if got != [names[j] for j in want_idx[i]]:
                if not abs(srt[i, k - 1] - srt[i, k]) <= SHAP_TIE:
                    raise AssertionError(f"/predict {i}: reason codes {got}")
                tie_rows += 1
            vals = np.array([rc["attribution"] for rc in out["reason_codes"]])
            jidx = [names.index(f) for f in got]
            if not np.allclose(vals, phi[i, jidx], rtol=SHAP_RTOL, atol=SHAP_ATOL):
                raise AssertionError(f"/predict {i}: attributions {vals}")
        n_total = len(results)
        print(f"phase6: {N_REQUESTS} /predict from {CLIENTS} client threads (own "
              f"process) in {wall:.3f} s ({N_REQUESTS / wall:.1f} req/s); latency "
              + latency_line([r[2] for r in concurrent]) + " (client clock)")
        print(f"phase6: {N_SEQUENTIAL} /predict one at a time in {wall_seq:.3f} s; latency "
              + latency_line([r[2] for r in sequential]) + f" (client clock); max "
              f"|score - f64 forest walk| over all {n_total} {worst:.3e}; reason codes "
              f"equal the CPU plain TreeSHAP's on {n_total - tie_rows} rows, {tie_rows} "
              f"rows differ across a k-th/(k+1)-th tie within {SHAP_TIE}")
        if delta['scorer_flushes_total{path="fused",shard="0"}'] != flushes or \
                delta['scorer_flushes_total{path="split",shard="0"}'] != 0 or flushes < 1:
            raise AssertionError(f"GBT flush paths: {delta}")
        for name in GBT_SERVED_KERNELS:
            if launches.get(name, 0) < flushes:
                raise AssertionError(f"{name} launched {launches.get(name)} times in "
                                     f"{flushes:g} explained flushes")
        print(f"phase6: {flushes:g} flushes, all fused; kernel launches on the GBT "
              f"served path {launches}")
        status, body = http_call(port, "GET", "/monitor/status")
        rows_seen = json.loads(body)["drift"]["rows_seen"]
        if rows_seen != n_total or 'scorer_served_family{family="gbt"} 1.0' not in text:
            raise AssertionError(f"GBT monitor rows_seen {rows_seen} / served family")

        scorer = batcher.scorer
        target = batcher._fused_target(scorer)
        rows1024 = np.concatenate([x] * 4)[:1024]
        batch = [(rows1024[i], None) for i in range(1024)]
        acts = profiled_kernels(lambda: batcher._flush_device(scorer, target, batch))
        copies = sum(1 for name, _ in acts if "Memcpy" in name or "Memset" in name)
        busy_us = sum(us for _, us in acts)
        by_name: dict[str, list[float]] = {}
        for name, us in acts:
            by_name.setdefault(name[:48], []).append(us)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
        print(f"phase6: one 1024-row GBT fused flush with explain: {len(acts) - copies} "
              f"kernel launches + {copies} copies/memsets on the device, {busy_us:.3f} us "
              f"of device activity (profiler); top by name: "
              + "; ".join(f"{n} x{len(v)} {sum(v):.3f} us" for n, v in top))
        times = []
        for _ in range(30):
            t = time.perf_counter()
            res = batcher._flush_device(scorer, target, batch)
            times.append(time.perf_counter() - t)
            scorer.staging.release(res[-1])
        times.sort()
        print(f"phase6: 1024-row GBT fused flush host time p50 {times[15] * 1e3:.3f} ms, "
              f"min {times[0] * 1e3:.3f} ms over 30 flushes")
    finally:
        server.stop()
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA "
              "card", file=sys.stderr)
        return 2
    for part in ("fraud_detection_tpu_torch", "models", "data"):
        if not (ROOT / part).exists():
            print(f"chip_smoke: {part}/ missing beside {__file__}",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, str(ROOT))
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.ops import kernels

    resolve_device("cuda")  # precision policy: no TF32
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = kernels.build_kernels()
    print(f"phase1: built {sorted(built)} in {time.perf_counter() - t0:.3f} s "
          f"(per kernel: {', '.join(f'{k} {v:.3f} s' for k, v in built.items())})")
    if sorted(built) != sorted(KERNELS):
        raise AssertionError(f"csrc kernels {sorted(built)} != {sorted(KERNELS)}")
    print(f"kernels: {json.dumps(sorted(KERNELS))}")

    fs = check_fused_score(seed=0)
    knn = check_knn_topk(seed=0)
    hist = check_gbt_hist(seed=0)
    shap = check_tree_shap(seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        served = served_path(Path(work))
        trained = trained_path(Path(work))
        gbt_trained, gbt_dir = gbt_trained_path(Path(work))
        gbt_served = gbt_served_path(Path(work), gbt_dir)

    def row(name: str, launches: int, check: dict, t: dict, library_ms, **extra):
        route, source, replaces = KERNELS[name]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": check["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": library_ms, **extra,
        }

    t = fs["timing"][1024]
    k_small, k_big = knn["timing"][158], knn["timing"][100000]
    line = {"kernels": [
        row("fused_score", served["fused_score"], fs, t, t["library_ms"]),
        # no single PyTorch call computes k-NN with this tie rule: the
        # library column is null, the two-call orientation stands beside it;
        # max_abs_err is the largest float64 distance gap between the
        # kernel's and the plain version's picks (0 when the indices agree)
        row("knn_topk", trained["knn_topk"], knn, k_small, None,
            m=158, orientation_ms=k_small["orientation_ms"],
            at_m_100000={key: k_big[key] for key in
                         ("ms", "plain_ms", "bound_ms", "orientation_ms")}),
        # at the final fit's last level (16 nodes); max_abs_err is the
        # largest |kernel − plain| cell over every phase-2c case
        row("gbt_hist", gbt_trained["gbt_hist"], hist, hist["timing"][16],
            hist["timing"][16]["library_ms"], n=31684, nodes=16,
            at_level_0={key: hist["timing"][1][key] for key in
                        ("ms", "plain_ms", "bound_ms", "library_ms")},
            at_leaf_sums={key: hist["timing"]["leaf"][key] for key in
                          ("ms", "plain_ms", "bound_ms", "library_ms")},
            mean_per_launch_ms=hist["mean"]["ms"]),
        # no single PyTorch call computes TreeSHAP: the library column is
        # null, the TPU kernel's dense three-product form (torch.matmul)
        # stands beside it as orientation
        row("tree_shap", gbt_served["tree_shap"], shap, shap["timing"], None,
            n=1024, trees=100, depth=5, orientation_ms=shap["timing"]["orientation_ms"]),
    ]}
    print(json.dumps(line))
    print(card)  # exactly as nvidia-smi gives it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,  # the cards this run used: every phase runs on one
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
