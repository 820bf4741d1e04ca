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

#: the kernels each path must launch (its counts zeroed just before it)
SERVED_KERNELS = ("fused_score",)
TRAINED_KERNELS = ("knn_topk",)

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        served = served_path(Path(work))
        trained = trained_path(Path(work))

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
