"""The port's hand-written CUDA kernels: build, binding, wrappers and their
plain PyTorch versions.

Build (route (b) of the port's kernel rule): every ``csrc/*.cu`` compiles
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into its own shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, from the sources in the checkout
only, into ``fraud_detection_tpu_torch/build/`` (git-ignored); each library
name carries a hash of its source and flags, so an edited source never
loads a stale binary. :func:`build_kernels` starts one ``nvcc`` per source,
all at once, and is what ``chip_smoke.py`` calls to build before it drives
the path. Nothing is compiled or imported from the CUDA toolkit when this
module is imported.

Wrappers check device, dtype, shape and contiguity. A tensor on the CPU
takes the plain PyTorch version; a CUDA tensor launches the kernel or
raises — there is no fallback. Each wrapper counts its launches in a
module-level integer (``FUSED_SCORE_LAUNCHES``, ``KNN_TOPK_LAUNCHES``,
``GBT_HIST_LAUNCHES``, ``TREE_SHAP_LAUNCHES``), so a run can show that the
served and the trained paths went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel name → its C functions' argtypes (every pointer and the stream
#: are c_void_p: a bare int would be cut to 32 bits)
_SIGNATURES = {
    "fused_score": {
        "fused_score_launch": (
            [ctypes.c_void_p] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "fused_score_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "knn_topk": {
        "knn_topk_launch": (
            [ctypes.c_void_p] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p],
            ctypes.c_int,
        ),
        "knn_topk_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "gbt_hist": {
        "gbt_hist_scratch_bytes": (
            [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
            ctypes.c_longlong,
        ),
        "gbt_hist_launch": (
            [ctypes.c_void_p] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "gbt_hist_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "tree_shap": {
        "tree_shap_launch": (
            [ctypes.c_void_p] * 8
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int,
        ),
        "tree_shap_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}

#: launches of each kernel (CUDA tensors only; the CPU path and the plain
#: versions never count)
FUSED_SCORE_LAUNCHES = 0
KNN_TOPK_LAUNCHES = 0
GBT_HIST_LAUNCHES = 0
TREE_SHAP_LAUNCHES = 0

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel with a source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def reset_launch_counts() -> None:
    global FUSED_SCORE_LAUNCHES, KNN_TOPK_LAUNCHES, GBT_HIST_LAUNCHES
    global TREE_SHAP_LAUNCHES
    with _lock:
        FUSED_SCORE_LAUNCHES = 0
        KNN_TOPK_LAUNCHES = 0
        GBT_HIST_LAUNCHES = 0
        TREE_SHAP_LAUNCHES = 0


def launch_counts() -> dict[str, int]:
    return {
        "fused_score": FUSED_SCORE_LAUNCHES,
        "knn_topk": KNN_TOPK_LAUNCHES,
        "gbt_hist": GBT_HIST_LAUNCHES,
        "tree_shap": TREE_SHAP_LAUNCHES,
    }


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the port's CUDA kernels "
        "build from csrc/ at first use on the machine with the card"
    )


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_kernels(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named kernel (default: all of ``csrc/``) that has no
    up-to-date library yet — one ``nvcc`` per source, started together —
    and load them. Returns name → build seconds (0.0 when already built).
    Raises with nvcc's output when a build fails."""
    names = kernel_names() if names is None else names
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = _lib_path(name)
            if name in _libs or out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp, out, time.perf_counter(),
            )
        times = dict.fromkeys(names, 0.0)
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            times[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return times


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_kernels([name])
        lib = _libs[name]
    return lib


# ---------------------------------------------------------------------------
# fused_score — replaces fraud_detection_tpu/ops/pallas_kernels.py::_score_kernel
# ---------------------------------------------------------------------------
# Bound on the H100: bytes, 4·n·(d+1) (x read once, one f32 score written).
# At the 1024-row serving bucket and d = 30 that is ~127 KB — under 0.04 µs
# at 3.35 TB/s, far under the few µs a launch costs, so at serving sizes
# the launch dominates. The design does the whole row in one pass (one warp
# per row, coalesced loads, shuffle reduction, sigmoid in the epilogue):
# one launch, x read once, no scratch. See csrc/fused_score.cu.


def fused_score_reference(
    coef: torch.Tensor, intercept: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``sigmoid(x @ coef + b)``. The
    CPU path and the tests use it; the card never does."""
    return torch.sigmoid(x.float() @ coef + intercept)


def fused_score(
    coef: torch.Tensor, intercept: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """``sigmoid(x @ coef + intercept)`` per row: x (n, d) contiguous f32,
    coef (d,) f32, intercept () f32, all on one device → (n,) f32. CUDA
    tensors launch the hand-written kernel on the current stream; CPU
    tensors take :func:`fused_score_reference`."""
    global FUSED_SCORE_LAUNCHES
    if x.dim() != 2 or coef.dim() != 1 or intercept.numel() != 1:
        raise ValueError(
            f"fused_score wants x (n, d), coef (d,), intercept (); got "
            f"{tuple(x.shape)}, {tuple(coef.shape)}, {tuple(intercept.shape)}"
        )
    n, d = x.shape
    if coef.shape[0] != d:
        raise ValueError(f"coef has {coef.shape[0]} features, x has {d}")
    for t, what in ((x, "x"), (coef, "coef"), (intercept, "intercept")):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_score wants float32 {what}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what} on {t.device}, x on {x.device}")
    if x.device.type == "cpu":
        return fused_score_reference(coef, intercept.reshape(()), x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_score runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and coef.is_contiguous()):
        raise ValueError("fused_score wants contiguous x and coef")
    if n < 1 or d < 1:
        raise ValueError(f"fused_score wants n >= 1 and d >= 1, got ({n}, {d})")
    lib = _lib("fused_score")
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = lib.fused_score_launch(
        x.data_ptr(), coef.data_ptr(), intercept.data_ptr(), out.data_ptr(),
        n, d, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "fused_score launch failed: "
            + lib.fused_score_error_string(rc).decode()
        )
    with _lock:
        FUSED_SCORE_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# knn_topk — replaces fraud_detection_tpu/ops/pallas_kernels.py::_knn_kernel
# ---------------------------------------------------------------------------
# Bound on the H100: operations, ~2·m²·d + 3·m² flops in float32 outside the
# tensor cores (67 TFLOP/s): ~9.4 ms at m = 100,000, d = 30; at the default
# training run's m ≈ 158 the launch dominates. The design gives each query
# row one thread (query in registers, key tiles broadcast from shared
# memory, a sorted (d2, index) list in registers), so no (m, m) matrix
# exists and the ragged edge is masked. See csrc/knn_topk.cu.

#: the kernel's compile-time bounds (csrc/knn_topk.cu: kMaxK, kMaxD)
KNN_MAX_K = 32
KNN_MAX_D = 128


def knn_topk_reference(
    xc: torch.Tensor,
    sq: torch.Tensor,
    k: int,
    block: int = 1024,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, after ``ops/smote._knn_indices``
    of the JAX package: blockwise over query rows, ``d2 = (|q|² − 2 q·x) +
    |x|²`` against every row, self set to +inf, then a *stable* ascending
    sort so that equal distances keep the lowest index first (the rule of
    ``lax.top_k``; ``torch.topk`` does not keep it). ``rows`` restricts the
    queries to those row ids (all rows by default). Returns (len(rows), k)
    int32. The CPU path and the tests use it; the card's path never does."""
    m = xc.shape[0]
    q_ids = torch.arange(m, device=xc.device) if rows is None else rows.to(xc.device)
    out = []
    for lo in range(0, q_ids.shape[0], block):
        ids = q_ids[lo:lo + block]
        d2 = sq[ids][:, None] - 2.0 * (xc[ids] @ xc.T) + sq[None, :]
        d2[torch.arange(ids.shape[0], device=xc.device), ids] = float("inf")
        order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        out.append(order.to(torch.int32))
    if not out:
        return torch.empty((0, k), dtype=torch.int32, device=xc.device)
    return torch.cat(out)


def knn_topk(xc: torch.Tensor, sq: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (m, k) int32 of each row's k nearest other rows, ascending by
    (squared distance, index). ``xc`` (m, d) contiguous float32, already
    centred; ``sq`` (m,) float32, ``|x|²`` of those rows. CUDA tensors
    launch the hand-written kernel on the current stream (k ≤
    ``KNN_MAX_K``, d ≤ ``KNN_MAX_D``); CPU tensors take
    :func:`knn_topk_reference`."""
    global KNN_TOPK_LAUNCHES
    if xc.dim() != 2 or sq.dim() != 1 or sq.shape[0] != xc.shape[0]:
        raise ValueError(
            f"knn_topk wants xc (m, d) and sq (m,); got {tuple(xc.shape)}, "
            f"{tuple(sq.shape)}"
        )
    for t, what in ((xc, "xc"), (sq, "sq")):
        if t.dtype != torch.float32:
            raise TypeError(f"knn_topk wants float32 {what}, got {t.dtype}")
    if sq.device != xc.device:
        raise ValueError(f"sq on {sq.device}, xc on {xc.device}")
    m, d = xc.shape
    k = int(k)
    if m < 2 or d < 1:
        raise ValueError(f"knn_topk wants m >= 2 rows and d >= 1, got ({m}, {d})")
    if not 1 <= k < m:
        raise ValueError(f"knn_topk wants 1 <= k < m, got k={k}, m={m}")
    if xc.device.type == "cpu":
        return knn_topk_reference(xc, sq, k)
    if xc.device.type != "cuda":
        raise ValueError(f"knn_topk runs on cuda or cpu, not {xc.device}")
    if k > KNN_MAX_K:
        raise ValueError(f"knn_topk's kernel takes k <= {KNN_MAX_K}, got {k}")
    if d > KNN_MAX_D:
        raise ValueError(f"knn_topk's kernel takes d <= {KNN_MAX_D}, got {d}")
    if m > 2**31 - 1:
        raise ValueError(f"knn_topk indexes rows in int32, got m={m}")
    if not (xc.is_contiguous() and sq.is_contiguous()):
        raise ValueError("knn_topk wants contiguous xc and sq")
    lib = _lib("knn_topk")
    out = torch.empty((m, k), dtype=torch.int32, device=xc.device)
    rc = lib.knn_topk_launch(
        xc.data_ptr(), sq.data_ptr(), out.data_ptr(), m, d, k,
        xc.device.index, torch.cuda.current_stream(xc.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "knn_topk launch failed: " + lib.knn_topk_error_string(rc).decode()
        )
    with _lock:
        KNN_TOPK_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# gbt_hist — replaces fraud_detection_tpu/ops/gbt.py::_hist_pallas_kernel
# ---------------------------------------------------------------------------
# Bound on the H100: bytes, n·d (uint8 bins) + 12·n (node, g, h) read once
# and 8·d·n_nodes·n_bins written once: ~2.3 MB, ~0.7 µs at 3.35 TB/s at the
# GBT recipe's last level (n = 31,684, d = 30, 16 nodes, 256 bins), below
# one launch. The design is deterministic by integer arithmetic: g and h
# become int64 multiples of a power-of-two quantum per channel (set on the
# device from max|g|, max|h| and n, never read back), rounded away from
# zero, and every thread adds its own (row, feature) with integer atomics,
# so the bits do not depend on the order of the adds. See csrc/gbt_hist.cu;
# :func:`gbt_hist_fixed_point_reference` is its arithmetic in PyTorch.

#: the kernel's bounds (csrc/gbt_hist.cu: kMaxBins, kMaxNodes)
GBT_HIST_MAX_BINS = 256
GBT_HIST_MAX_NODES = 65536


def gbt_hist_reference(
    bins: torch.Tensor,
    local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, after ``_hist_segment`` of the
    JAX package (its exact-f32 reference): every (row, feature)'s ``(g,
    h)`` added into the cell ``(feature, local, bin)``. Rows whose node
    lies outside ``[0, n_nodes)`` and bins ``>= n_bins`` are inert, as in
    the kernel. Returns (d, n_nodes, n_bins, 2) float32. On the CPU one
    ``index_add_``: the rows of each cell add in ascending order, the order
    of the JAX package's ``segment_sum`` there. On the card an accumulating
    ``index_put_``, which sorts the cell ids and adds each cell's rows in
    turn, so that its bits do not change from run to run as a float-atomic
    ``index_add_``'s do (on the CPU it is the one that is not serial)."""
    n, d = bins.shape
    b = bins.long()
    loc = local.long()
    seg = (loc[:, None] * n_bins + b
           + torch.arange(d, device=b.device)[None, :] * (n_nodes * n_bins))
    src = torch.stack([g, h], dim=1).float()[:, None, :].expand(n, d, 2)
    keep = ((loc >= 0) & (loc < n_nodes))[:, None] & (b < n_bins)
    if bool(keep.all()):
        seg, src = seg.reshape(-1), src.reshape(-1, 2)
    else:
        seg, src = seg[keep], src[keep]
    out = torch.zeros((d * n_nodes * n_bins, 2), dtype=torch.float32, device=b.device)
    if out.device.type == "cpu":
        out.index_add_(0, seg, src)
    else:
        out.index_put_((seg,), src, accumulate=True)
    return out.reshape(d, n_nodes, n_bins, 2)


def gbt_hist_quanta(n: int, max_abs: tuple[float, float]) -> tuple[float, float]:
    """The kernel's quantum per channel for ``n`` rows whose live values
    are at most ``max_abs`` (g, h) in magnitude: ``q = 2^(e − 62)`` with
    ``frexp(n · max) = (m, e)``, so that ``n · max / q < 2^62`` and no
    int64 cell overflows; NaN for a non-finite max."""
    out = []
    for m in max_abs:
        if not math.isfinite(m):
            out.append(math.nan)
            continue
        _, e = math.frexp(float(n) * float(m))
        out.append(math.ldexp(1.0, e - 62))
    return out[0], out[1]


def gbt_hist_fixed_point_reference(
    bins: torch.Tensor,
    local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    n_nodes: int,
    n_bins: int,
) -> tuple[torch.Tensor, tuple[float, float]]:
    """The kernel's arithmetic in plain PyTorch, for the tests and the
    card's bitwise check (the CPU path keeps :func:`gbt_hist_reference`):
    the quanta of :func:`gbt_hist_quanta` from max|g| and max|h| over the
    rows whose node lies in ``[0, n_nodes)``, each row's g and h as int64
    multiples of them rounded away from zero, int64 sums per cell (in any
    order: integers), and ``float32(float64(cell) · q)``. A non-finite
    channel comes out NaN in every cell. Returns the (d, n_nodes, n_bins,
    2) histogram and the quanta (g, h)."""
    n, d = bins.shape
    b = bins.long()
    loc = local.long()
    live = (loc >= 0) & (loc < n_nodes)
    quanta = gbt_hist_quanta(n, tuple(
        float(v.abs().max()) if bool(live.any()) else 0.0 for v in (g[live], h[live])
    ))
    fixed = []
    for v, q in zip((g, h), quanta):
        if math.isnan(q):
            fixed.append(torch.zeros(n, dtype=torch.int64, device=b.device))
            continue
        v = torch.where(live, v.double(), 0.0)  # rows outside the level add nothing
        k = torch.ceil(v.abs() * (1.0 / q)).to(torch.int64)
        fixed.append(torch.where(v < 0, -k, k))
    seg = (loc[:, None] * n_bins + b
           + torch.arange(d, device=b.device)[None, :] * (n_nodes * n_bins))
    keep = live[:, None] & (b < n_bins)
    src = torch.stack(fixed, dim=1)[:, None, :].expand(n, d, 2)[keep]
    acc = torch.zeros((d * n_nodes * n_bins, 2), dtype=torch.int64, device=b.device)
    acc.index_add_(0, seg[keep], src)
    q = torch.tensor(quanta, dtype=torch.float64, device=b.device)
    return (acc.double() * q).float().reshape(d, n_nodes, n_bins, 2), quanta


def gbt_hist(
    bins: torch.Tensor,
    local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """Gradient/hessian histograms (d, n_nodes, n_bins, 2) float32 of one
    tree level: ``bins`` (n, d) bin ids, ``local`` (n,) int32 node of each
    row within the level, ``g``/``h`` (n,) float32. CUDA tensors launch the
    hand-written kernel (uint8 bins, n_bins ≤ ``GBT_HIST_MAX_BINS``,
    n_nodes ≤ ``GBT_HIST_MAX_NODES``, contiguous); CPU tensors take
    :func:`gbt_hist_reference`."""
    return _gbt_hist(bins, local, g, h, n_nodes, n_bins)[0]


def gbt_hist_and_quanta(
    bins: torch.Tensor,
    local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    n_nodes: int,
    n_bins: int,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`gbt_hist`, and the two quanta (g, h) the kernel chose as a
    float64 (2,) tensor on the card (never read back here); ``None`` for
    CPU tensors, whose plain version has no quanta."""
    out, scratch = _gbt_hist(bins, local, g, h, n_nodes, n_bins)
    if scratch is None:
        return out, None
    cells = out.numel()
    return out, scratch[cells:cells + 2].view(torch.float64)


def _gbt_hist(
    bins: torch.Tensor,
    local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    n_nodes: int,
    n_bins: int,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`gbt_hist` and the kernel's scratch (``None`` on the CPU)."""
    global GBT_HIST_LAUNCHES
    if bins.dim() != 2 or local.dim() != 1 or g.dim() != 1 or h.dim() != 1:
        raise ValueError(
            f"gbt_hist wants bins (n, d), local/g/h (n,); got {tuple(bins.shape)}, "
            f"{tuple(local.shape)}, {tuple(g.shape)}, {tuple(h.shape)}"
        )
    n, d = bins.shape
    if not (local.shape[0] == g.shape[0] == h.shape[0] == n):
        raise ValueError("gbt_hist: bins, local, g and h disagree on the row count")
    n_nodes, n_bins = int(n_nodes), int(n_bins)
    if n < 1 or d < 1 or n_nodes < 1 or n_bins < 1:
        raise ValueError(f"gbt_hist wants n, d, n_nodes, n_bins >= 1, got "
                         f"({n}, {d}, {n_nodes}, {n_bins})")
    if local.dtype != torch.int32:
        raise TypeError(f"gbt_hist wants int32 local, got {local.dtype}")
    for t, what in ((g, "g"), (h, "h")):
        if t.dtype != torch.float32:
            raise TypeError(f"gbt_hist wants float32 {what}, got {t.dtype}")
    for t, what in ((local, "local"), (g, "g"), (h, "h")):
        if t.device != bins.device:
            raise ValueError(f"{what} on {t.device}, bins on {bins.device}")
    if bins.device.type == "cpu":
        return gbt_hist_reference(bins, local, g, h, n_nodes, n_bins), None
    if bins.device.type != "cuda":
        raise ValueError(f"gbt_hist runs on cuda or cpu, not {bins.device}")
    if bins.dtype != torch.uint8:
        raise TypeError(f"gbt_hist's kernel reads uint8 bins, got {bins.dtype}")
    if n_bins > GBT_HIST_MAX_BINS:
        raise ValueError(f"gbt_hist's kernel takes n_bins <= {GBT_HIST_MAX_BINS}, got {n_bins}")
    if n_nodes > GBT_HIST_MAX_NODES:
        raise ValueError(
            f"gbt_hist's kernel takes n_nodes <= {GBT_HIST_MAX_NODES}, got {n_nodes}"
        )
    if not all(t.is_contiguous() for t in (bins, local, g, h)):
        raise ValueError("gbt_hist wants contiguous bins, local, g and h")
    lib = _lib("gbt_hist")
    scratch_bytes = lib.gbt_hist_scratch_bytes(n, d, n_nodes, n_bins)
    if scratch_bytes < 0:
        raise ValueError(f"gbt_hist's kernel refuses shape ({n}, {d}, {n_nodes}, {n_bins})")
    # int64 accumulator (d, n_nodes, n_bins, 2), the two float64 quanta, the
    # max pass's partials: the kernel zeroes what it reads
    scratch = torch.empty(scratch_bytes // 8, dtype=torch.int64, device=bins.device)
    out = torch.empty((d, n_nodes, n_bins, 2), dtype=torch.float32, device=bins.device)
    rc = lib.gbt_hist_launch(
        bins.data_ptr(), local.data_ptr(), g.data_ptr(), h.data_ptr(),
        scratch.data_ptr(), out.data_ptr(),
        n, d, n_nodes, n_bins, bins.device.index,
        torch.cuda.current_stream(bins.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "gbt_hist launch failed: " + lib.gbt_hist_error_string(rc).decode()
        )
    with _lock:
        GBT_HIST_LAUNCHES += 1
    return out, scratch


# ---------------------------------------------------------------------------
# tree_shap — replaces fraud_detection_tpu/ops/pallas_kernels.py::_chisel_kernel
# ---------------------------------------------------------------------------
# Bound on the H100: bytes. The subset loop depends on the row only through
# each leaf's D-bit pattern of failed path conditions, so it is folded into
# a (T, L, 2^D, D) table when the explainer is built; a (row, tree) then
# needs L·D compares, L·D table reads and the sums to the 2^D − 1 nodes:
# ~36 M operations for 1,024 rows × 100 trees at depth 5 (~0.5 µs at the
# f32 rate) against ~2.5 MB of tables (~0.75 µs at 3.35 TB/s). The TPU
# kernel's dense three-matmul form would be ~0.4 MFLOP per (row, tree); the
# port does not carry it over. The design gives each row a block, each
# eighth of the trees a warp and each leaf a lane (depth ≤ 5), and adds in
# an order fixed by the forest's shape. See csrc/tree_shap.cu.

#: the kernel's bounds (csrc/tree_shap.cu: kMaxDepth, kMaxD)
TREE_SHAP_MAX_DEPTH = 5
TREE_SHAP_MAX_D = 128


class TreeShapTables(NamedTuple):
    """A forest and its background table, with the compact per-tree tables
    the kernel reads (built once per explainer by
    ``ops/tree_shap.build_tables``). The plain version reads the first
    four fields, the kernel the rest."""

    split_feature: torch.Tensor  # (T, 2^D − 1) int
    split_bin: torch.Tensor  # (T, 2^D − 1) int
    leaf_value: torch.Tensor  # (T, L) float32
    bg_table: torch.Tensor  # (T, L, M) float32
    path_feat: torch.Tensor  # (T, L, D) int32
    path_thr: torch.Tensor  # (T, L, D) int32
    leaf_sums: torch.Tensor  # (T, L, 2^D, D) float32, by failed-level pattern
    node_order: torch.Tensor  # (T, 2^D − 1) int32, nodes grouped by feature
    node_start: torch.Tensor  # (T, d) int32
    node_count: torch.Tensor  # (T, d) int32


def tree_shap_reference(
    binned: torch.Tensor,
    split_feature: torch.Tensor,
    split_bin: torch.Tensor,
    leaf_value: torch.Tensor,
    bg_table: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the port of the JAX package's
    XLA body of ``_raw_tree_shap`` (``ops/tree_shap.py``), one tree at a
    time over all rows — the level-subset indicators times the background
    factors, the Shapley-weighted differences over each canonical level,
    and the scatter to features as a one-hot matmul (full f32). ``binned``
    (n, d) bin ids → φ (n, d) float32 in margin space. The CPU path, the
    depth above the kernel's cap and the tests use it."""
    from fraud_detection_tpu_torch.ops.tree_shap import (
        _dup_structure,
        _path_conditions,
        _shapley_weights,
        _tree_static,
    )

    dev = binned.device
    n, d = binned.shape
    depth = (int(split_feature.shape[1]) + 1).bit_length() - 1
    anc, direc, bits_np, pair_np = _tree_static(depth)
    anc = torch.as_tensor(anc, device=dev).long()
    direc = torch.as_tensor(direc, device=dev)
    bits = torch.as_tensor(bits_np, device=dev)  # (masks, depth) bool
    # the full mask (size = depth) includes no level: clamp its size into
    # the weight table, as JAX's indexing does
    size = bits.sum(dim=1).clamp_max(depth - 1)  # (masks,)
    wtab = torch.as_tensor(_shapley_weights(depth), dtype=torch.float32, device=dev)
    pair_flat = torch.as_tensor(pair_np.reshape(-1), device=dev).long()
    masks = bits.shape[0]
    feat_ids = torch.arange(d, device=dev)
    binned = binned.long()
    phi = torch.zeros((n, d), dtype=torch.float32, device=dev)
    for t in range(split_feature.shape[0]):
        feat = split_feature[t].long()[anc]  # (leaves, depth)
        thr = split_bin[t].long()[anc]
        dup, canonical, u = _dup_structure(feat)
        cx = _path_conditions(binned, feat, thr, direc)  # (n, leaves, depth)
        bitdup = bits[:, dup]  # (masks, leaves, depth)
        cxsel = torch.where(bitdup[None], cx[:, None], True).all(dim=3)
        v = cxsel.float() * bg_table[t].T[None]  # (n, masks, leaves)
        # a mask is a feature subset iff every non-canonical bit is 0
        valid = (canonical[None, :, :] | ~bits[:, None, :]).all(dim=2)
        v_pair = v[:, pair_flat].reshape(n, masks, depth, v.shape[2])
        delta = v_pair - v[:, :, None, :]  # (n, masks, depth, leaves)
        w = wtab[u[None, None, :], size[:, None, None]]  # (masks, 1, leaves)
        include = valid[:, None, :] & ~bits[:, :, None] & canonical.T[None, :, :]
        contrib = torch.where(include[None], w[None] * delta, 0.0).sum(dim=1)
        scaled = contrib.transpose(1, 2) * leaf_value[t][None, :, None]
        onehot = (feat.reshape(-1)[:, None] == feat_ids[None, :]).float()
        phi = phi + scaled.reshape(n, -1) @ onehot
    return phi


def tree_shap(binned: torch.Tensor, tables: TreeShapTables) -> torch.Tensor:
    """Exact interventional TreeSHAP φ (n, d) float32 in margin space of
    the forest in ``tables`` for rows of bin ids ``binned`` (n, d). CUDA
    tensors launch the hand-written kernel (depth ≤ ``TREE_SHAP_MAX_DEPTH``,
    d ≤ ``TREE_SHAP_MAX_D``, int32 bins); CPU tensors take
    :func:`tree_shap_reference`."""
    global TREE_SHAP_LAUNCHES
    if binned.dim() != 2:
        raise ValueError(f"tree_shap wants binned (n, d), got {tuple(binned.shape)}")
    n, d = binned.shape
    if tables.node_start.shape[1] != d:
        raise ValueError(f"tables for {tables.node_start.shape[1]} features, rows have {d}")
    if binned.device.type == "cpu":
        return tree_shap_reference(
            binned, tables.split_feature, tables.split_bin, tables.leaf_value,
            tables.bg_table,
        )
    if binned.device.type != "cuda":
        raise ValueError(f"tree_shap runs on cuda or cpu, not {binned.device}")
    n_trees, leaves, depth = tables.path_feat.shape
    if depth > TREE_SHAP_MAX_DEPTH:
        raise ValueError(f"tree_shap's kernel takes depth <= {TREE_SHAP_MAX_DEPTH}, got {depth}")
    if d > TREE_SHAP_MAX_D:
        raise ValueError(f"tree_shap's kernel takes d <= {TREE_SHAP_MAX_D}, got {d}")
    if binned.dtype != torch.int32:
        raise TypeError(f"tree_shap's kernel reads int32 bins, got {binned.dtype}")
    kernel_args = (binned, tables.path_feat, tables.path_thr, tables.leaf_sums,
                   tables.node_order, tables.node_start, tables.node_count)
    for t in kernel_args:
        if t.device != binned.device or not t.is_contiguous():
            raise ValueError("tree_shap wants contiguous tables on the rows' device")
    if n < 1:
        return torch.zeros((0, d), dtype=torch.float32, device=binned.device)
    lib = _lib("tree_shap")
    out = torch.empty((n, d), dtype=torch.float32, device=binned.device)
    rc = lib.tree_shap_launch(
        *(t.data_ptr() for t in kernel_args), out.data_ptr(),
        n, d, n_trees, depth, binned.device.index,
        torch.cuda.current_stream(binned.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "tree_shap launch failed: " + lib.tree_shap_error_string(rc).decode()
        )
    with _lock:
        TREE_SHAP_LAUNCHES += 1
    return out
