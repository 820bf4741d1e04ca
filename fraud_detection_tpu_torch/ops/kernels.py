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
import re
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel name → its C functions' argtypes (every pointer and the stream
#: are c_void_p: a bare int would be cut to 32 bits)
_SIGNATURES = {
    "fused_score": {
        "fused_score_launch": (
            [ctypes.c_void_p] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p],
            ctypes.c_int,
        ),
        "fused_score_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "knn_topk": {
        "knn_topk_plan": (
            [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p],
            ctypes.c_int,
        ),
        "knn_topk_launch": (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
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
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
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
#: nvcc's output (with ``ptxas -v``'s resource lines) of each kernel built
#: by this process
BUILD_LOGS: dict[str, str] = {}


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
            BUILD_LOGS[name] = log
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


def _bind(name: str, lib: ctypes.CDLL, signatures: dict | None = None) -> ctypes.CDLL:
    for fn, (argtypes, restype) in (_SIGNATURES[name] if signatures is None
                                    else signatures).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def build_library(source: Path, name: str, signatures: dict,
                  flags: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, str]:
    """Compile one ``.cu`` (an earlier design of a kernel, or a source built
    with extra ``flags`` such as a ``-D`` setting, for a comparison in
    turns) with the port's flags into ``build/lib<name>.so`` and load it
    with ``signatures`` (function → (argtypes, restype)). Returns the
    library and nvcc's output; raises with that output when the build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}")
    return _bind(name, ctypes.CDLL(str(out)), signatures), proc.stdout


def ptxas_usage(log: str) -> list[dict]:
    """Each entry function's resources from ``ptxas -v`` lines in nvcc's
    output: name (mangled), registers, stack frame and spill bytes."""
    out: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if hit:
            current = out.setdefault(hit.group(1), {"function": hit.group(1)})
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if hit and current is not None:
            current.update(stack=int(hit.group(1)), spill_stores=int(hit.group(2)),
                           spill_loads=int(hit.group(3)))
            continue
        hit = re.search(r"Used (\d+) registers", line)
        if hit and current is not None:
            current["registers"] = int(hit.group(1))
    return list(out.values())


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_kernels([name])
        lib = _libs[name]
    return lib


# ---------------------------------------------------------------------------
# fused_score — replaces fraud_detection_tpu/ops/pallas_kernels.py::_score_kernel
# ---------------------------------------------------------------------------
# Bound on the H100: bytes, (e·d + 4)·n (x read once at e = 4 or 2 bytes an
# element, one f32 score written). At the 1024-row serving bucket and d = 30
# that is ~127 KB in f32 — under 0.04 µs at 3.35 TB/s, far under the few µs
# a launch costs, so at serving sizes the launch dominates. The launcher
# picks the shape from n and d: a warp a row (one coalesced load, five
# shuffles) for the ladder's buckets and for rows wider than 64, and from
# 8192 rows up a thread a row of a 32-row tile staged in shared memory.
# Both give the same bits: a thread adds its row's 32 partials in the warp
# shape's order. bf16 elements are upcast exactly as they are read, so bf16
# rows give the f32 path's bits on ``x.float()``. See csrc/fused_score.cu.

#: the x dtypes the kernel takes, and the launcher's code for each
FUSED_SCORE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def halving_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum the last axis of a 2-D tensor by halving it (zero-padded to a
    power of two) with elementwise adds: a row's sum takes the same order
    whatever the other rows, unlike a matmul or a reduction kernel, whose
    summation order follows the batch's shape."""
    d = p.shape[1]
    width = 1 << max(0, (d - 1).bit_length())
    if width != d:
        p = torch.nn.functional.pad(p, (0, width - d))
    while p.shape[1] > 1:
        half = p.shape[1] // 2
        p = p[:, :half] + p[:, half:]
    return p[:, 0]


def row_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """``sigmoid`` of f32 logits whose bits do not depend on a row's
    position in the batch. The card's elementwise kernel is the same for
    every element; the CPU's vectorized loop leaves a scalar tail whose
    ``exp`` rounds differently, so there the sigmoid runs in float64 and
    rounds once to f32."""
    if z.device.type == "cpu":
        return torch.sigmoid(z.double()).float()
    return torch.sigmoid(z)


def fused_score_reference(
    coef: torch.Tensor, intercept: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``sigmoid(x.float() · coef + b)``.
    On the CPU, where it serves, the products are summed by
    :func:`halving_sum` and the sigmoid taken by :func:`row_sigmoid`, so the
    same row scores the same bits in any batch. On the card, where only the
    checks call it, it is the one matmul ``sigmoid(x @ coef + b)``."""
    if x.device.type == "cpu":
        return row_sigmoid(halving_sum(x.float() * coef) + intercept)
    return torch.sigmoid(x.float() @ coef + intercept)


def fused_score(
    coef: torch.Tensor, intercept: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """``sigmoid(x @ coef + intercept)`` per row: x (n, d) contiguous f32 or
    bf16 (upcast exactly, as JAX's ``fused_score`` does), coef (d,) f32,
    intercept () f32, all on one device → (n,) f32. CUDA tensors launch the
    hand-written kernel on the current stream; CPU tensors take
    :func:`fused_score_reference`."""
    global FUSED_SCORE_LAUNCHES
    if x.dim() != 2 or coef.dim() != 1 or intercept.numel() != 1:
        raise ValueError(
            f"fused_score wants x (n, d), coef (d,), intercept (); got "
            f"{tuple(x.shape)}, {tuple(coef.shape)}, {tuple(intercept.shape)}"
        )
    n, d = x.shape
    if coef.shape[0] != d:
        raise ValueError(f"coef has {coef.shape[0]} features, x has {d}")
    if x.dtype not in FUSED_SCORE_DTYPES:
        raise TypeError(f"fused_score wants a float32 x or a bfloat16 x, got {x.dtype}")
    for t, what in ((coef, "coef"), (intercept, "intercept")):
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
        n, d, FUSED_SCORE_DTYPES[x.dtype], x.device.index,
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
# Bound on the H100: operations, m(m − 1)·d + 3·m² flops in float32 outside
# the tensor cores (67 TFLOP/s; the dot of an unordered pair once, since
# fmaf's product is the same bits either way round): ~4.9 ms at m = 100,000,
# d = 30; at the default training run's m ≈ 158 the launch dominates. The design: register-tiled
# distances (a block stages a tile of queries and of keys in shared memory,
# a thread runs TM × TN independent fmaf chains, one a pair, in feature
# order), each query's k best kept as packed 64-bit (d2, index) keys and
# updated by a warp's rank merge only for candidates under its k-th best,
# and the keys split over blocks when m is small, with a second small pass
# merging the splits. Every d2 is the one-chain arithmetic of the earlier
# one-thread-a-query kernel, so the indices are bitwise its indices. See
# csrc/knn_topk.cu; :func:`knn_topk_split_reference` is its selection in
# PyTorch.

#: the kernel's compile-time bounds (csrc/knn_topk.cu: kMaxK, kMaxD)
KNN_MAX_K = 32
KNN_MAX_D = 128
#: keys a tile at m ≤ 4096 (csrc/knn_topk.cu: SmallTile; above, 128 at
#: d ≤ 32 and 64 at more features)
KNN_SMALL_TILE = 32
#: the kernel's empty list slot (+inf, 0x7fffffff) as a :func:`knn_pack_keys` key
KNN_EMPTY_KEY = (0xFF800000 - 2**31) * 2**32 + 0x7FFFFFFF


def knn_select_reference(d2: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version's selection: each row of ``d2`` (queries ``ids``
    against every row) with its own column set to +inf, stably sorted so
    that equal distances keep the lowest index first; the first k columns
    as int32. Writes the +inf into ``d2``."""
    d2[torch.arange(ids.shape[0], device=d2.device), ids] = float("inf")
    return torch.sort(d2, dim=1, stable=True).indices[:, :k].to(torch.int32)


def knn_pack_keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's packed key of each (d2, index), as int64: the kernel's
    unsigned 64-bit key minus 2^63, so that a signed sort keeps its order.
    High word: d2's float32 bits with −0.0 read as +0.0, then negative
    values complemented and non-negative ones given the top bit (the
    order-preserving unsigned image, negatives first); low word: the
    index. So key order is (d2 <, then index <) with −0.0 == +0.0."""
    u = d2.to(torch.float32).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    u = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return (u - 2**31) * 2**32 + idx.long()


def knn_select_split_reference(
    d2: torch.Tensor, k: int, splits: int, tile: int = KNN_SMALL_TILE
) -> torch.Tensor:
    """The kernel's selection over a square distance matrix ``d2`` (every
    row a query against all m keys): keys cut into ``splits``
    runs of ⌈⌈m / tile⌉ / splits⌉ tiles (the last ones short or empty), each
    run's k smallest packed keys per query (:func:`knn_pack_keys`; a query's
    own row and NaN distances are never candidates, missing slots are
    ``KNN_EMPTY_KEY``), then the k smallest of the runs' lists together —
    the kernel's pass 1 and pass 2. Returns the low words as (m, k)
    int32."""
    m = d2.shape[0]
    ids = torch.arange(m, device=d2.device)
    keys = knn_pack_keys(d2, ids.expand(m, m))
    keys[ids, ids] = KNN_EMPTY_KEY
    keys[torch.isnan(d2)] = KNN_EMPTY_KEY
    tiles = -(-m // tile)
    span = -(-tiles // splits) * tile
    empty = torch.full((m, k), KNN_EMPTY_KEY, dtype=torch.int64, device=d2.device)
    parts = []
    for s in range(splits):
        run = keys[:, min(s * span, m):min((s + 1) * span, m)]
        best = torch.sort(run, dim=1).values[:, :k]
        parts.append(torch.cat([best, empty[:, best.shape[1]:]], dim=1))
    merged = torch.sort(torch.cat(parts, dim=1), dim=1).values[:, :k]
    return (merged & 0xFFFFFFFF).to(torch.int32)


def knn_topk_split_reference(
    xc: torch.Tensor, sq: torch.Tensor, k: int, splits: int, tile: int = KNN_SMALL_TILE
) -> torch.Tensor:
    """:func:`knn_select_split_reference` on the distances the plain version
    computes (``(|q|² − 2 q·x) + |x|²`` by a matrix product, whose d2 bits
    are not the kernel's): the kernel's selection, split and merge, in
    PyTorch, for the CPU tests."""
    d2 = sq[:, None] - 2.0 * (xc @ xc.T) + sq[None, :]
    return knn_select_split_reference(d2, k, splits, tile)


_KNN_PLANS: dict[tuple[int, int, int, int], dict] = {}


def knn_topk_plan(m: int, d: int, k: int, device: torch.device) -> dict:
    """The kernel's launch shape for (m, d, k) on a CUDA ``device``, as its
    launcher chooses it from the card's SM count and occupancy: key
    ``splits`` (the grid's y), ``query_tiles`` (its x), ``tile`` (rows a
    tile) and ``keys_per_split``."""
    index = torch.device(device).index or 0
    key = (m, d, k, index)
    plan = _KNN_PLANS.get(key)
    if plan is None:
        lib = _lib("knn_topk")
        got = (ctypes.c_int * 4)()
        rc = lib.knn_topk_plan(m, d, k, index, ctypes.cast(got, ctypes.c_void_p))
        if rc != 0:
            raise ValueError(
                f"knn_topk refuses (m, d, k) = ({m}, {d}, {k}): "
                + lib.knn_topk_error_string(rc).decode()
            )
        plan = dict(zip(("splits", "query_tiles", "tile", "keys_per_split"), got))
        _KNN_PLANS[key] = plan
    return plan


def knn_topk_reference(
    xc: torch.Tensor,
    sq: torch.Tensor,
    k: int,
    block: int = 1024,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, after ``ops/smote._knn_indices``
    of the JAX package: blockwise over query rows, ``d2 = (|q|² − 2 q·x) +
    |x|²`` against every row, then :func:`knn_select_reference` (self set to
    +inf, a *stable* ascending sort so that equal distances keep the lowest
    index first: the rule of ``lax.top_k``; ``torch.topk`` does not keep
    it). ``rows`` restricts the queries to those row ids (all rows by
    default). Returns (len(rows), k) int32. The CPU path and the tests use
    it; the card's path never does."""
    m = xc.shape[0]
    q_ids = torch.arange(m, device=xc.device) if rows is None else rows.to(xc.device)
    out = []
    for lo in range(0, q_ids.shape[0], block):
        ids = q_ids[lo:lo + block]
        d2 = sq[ids][:, None] - 2.0 * (xc[ids] @ xc.T) + sq[None, :]
        out.append(knn_select_reference(d2, ids, k))
    if not out:
        return torch.empty((0, k), dtype=torch.int32, device=xc.device)
    return torch.cat(out)


def knn_topk(xc: torch.Tensor, sq: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (m, k) int32 of each row's k nearest other rows, ascending by
    (squared distance, index). ``xc`` (m, d) contiguous float32, already
    centred; ``sq`` (m,) float32, ``|x|²`` of those rows. CUDA tensors
    launch the hand-written kernel on the current stream (k ≤
    ``KNN_MAX_K``, d ≤ ``KNN_MAX_D``; with more than one key split, a
    (splits, m, k) int64 scratch from ``torch.empty`` and a second, merging
    launch); CPU tensors take :func:`knn_topk_reference`."""
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
    splits = knn_topk_plan(m, d, k, xc.device)["splits"]
    out = torch.empty((m, k), dtype=torch.int32, device=xc.device)
    # each split's k best a query, packed (every slot written by pass 1)
    scratch = (torch.empty((splits, m, k), dtype=torch.int64, device=xc.device)
               if splits > 1 else None)
    rc = lib.knn_topk_launch(
        xc.data_ptr(), sq.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel() * 8,
        out.data_ptr(), m, d, k, xc.device.index,
        torch.cuda.current_stream(xc.device).cuda_stream,
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
# a (T, L, D, 2^D) table when the explainer is built; a (row, tree) then
# needs 2^D − 1 compares, L·D table reads and the sums to the nodes: ~33 M
# operations for 1,024 rows × 100 trees at depth 5 (~0.5 µs at the f32
# rate) against ~2.1 MB of tables (~0.6 µs at 3.35 TB/s). The TPU kernel's
# dense three-matmul form would be ~0.4 MFLOP per (row, tree); the port does
# not carry it over. The design is tree-stationary: a block stages a group
# of TREE_SHAP_GROUP trees' tables in shared memory (TMA bulk copies) and
# streams 32-row tiles over them, a warp a tree and a lane a row; groups
# add in a second small pass, in group order. See csrc/tree_shap.cu.

#: the kernel's bounds and its trees per block (csrc/tree_shap.cu: kMaxDepth,
#: kMaxD, kGroup)
TREE_SHAP_MAX_DEPTH = 5
TREE_SHAP_MAX_D = 128
TREE_SHAP_GROUP = 8


class TreeShapTables(NamedTuple):
    """A forest and its background table, with the compact per-tree tables
    the kernel reads (built once per explainer by
    ``ops/tree_shap.build_tables``). The plain version reads the first
    four fields, the kernel the rest. N = 2^D − 1 internal nodes in heap
    order, L = 2^D leaves, G = ``TREE_SHAP_GROUP``."""

    split_feature: torch.Tensor  # (T, N) int
    split_bin: torch.Tensor  # (T, N) int
    leaf_value: torch.Tensor  # (T, L) float32
    bg_table: torch.Tensor  # (T, L, M) float32
    node_key: torch.Tensor  # (T, 32) int32: split bin << 8 | split feature
    leaf_sums: torch.Tensor  # (T, L, D, 2^D) float32, by failed-level pattern
    group_order: torch.Tensor  # (T·N,) int32: each group's nodes by feature
    group_start: torch.Tensor  # (⌈T/G⌉, d) int32
    group_count: torch.Tensor  # (⌈T/G⌉, d) int32


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
    if tables.group_start.shape[1] != d:
        raise ValueError(f"tables for {tables.group_start.shape[1]} features, rows have {d}")
    if binned.device.type == "cpu":
        return tree_shap_reference(
            binned, tables.split_feature, tables.split_bin, tables.leaf_value,
            tables.bg_table,
        )
    if binned.device.type != "cuda":
        raise ValueError(f"tree_shap runs on cuda or cpu, not {binned.device}")
    n_trees, _, depth, _ = tables.leaf_sums.shape
    if depth > TREE_SHAP_MAX_DEPTH:
        raise ValueError(f"tree_shap's kernel takes depth <= {TREE_SHAP_MAX_DEPTH}, got {depth}")
    if d > TREE_SHAP_MAX_D:
        raise ValueError(f"tree_shap's kernel takes d <= {TREE_SHAP_MAX_D}, got {d}")
    if binned.dtype != torch.int32:
        raise TypeError(f"tree_shap's kernel reads int32 bins, got {binned.dtype}")
    kernel_args = (binned, tables.node_key, tables.leaf_sums, tables.group_order,
                   tables.group_start, tables.group_count)
    for t in kernel_args:
        if t.device != binned.device or not t.is_contiguous():
            raise ValueError("tree_shap wants contiguous tables on the rows' device")
    if n < 1:
        return torch.zeros((0, d), dtype=torch.float32, device=binned.device)
    lib = _lib("tree_shap")
    groups = -(-n_trees // TREE_SHAP_GROUP)
    out = torch.empty((n, d), dtype=torch.float32, device=binned.device)
    # each group's sums (the kernel writes every cell); one group writes φ
    part = (torch.empty((groups, d, n), dtype=torch.float32, device=binned.device)
            if groups > 1 else None)
    rc = lib.tree_shap_launch(
        *(t.data_ptr() for t in kernel_args),
        None if part is None else part.data_ptr(), out.data_ptr(),
        n, d, n_trees, depth, TREE_SHAP_GROUP, binned.device.index,
        torch.cuda.current_stream(binned.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "tree_shap launch failed: " + lib.tree_shap_error_string(rc).decode()
        )
    with _lock:
        TREE_SHAP_LAUNCHES += 1
    return out
