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
module-level integer (``FUSED_SCORE_LAUNCHES``, ``KNN_TOPK_LAUNCHES``), so
a run can show that the served and the trained path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

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
}

#: launches of each kernel (CUDA tensors only; the CPU path and the plain
#: versions never count)
FUSED_SCORE_LAUNCHES = 0
KNN_TOPK_LAUNCHES = 0

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel with a source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def reset_launch_counts() -> None:
    global FUSED_SCORE_LAUNCHES, KNN_TOPK_LAUNCHES
    with _lock:
        FUSED_SCORE_LAUNCHES = 0
        KNN_TOPK_LAUNCHES = 0


def launch_counts() -> dict[str, int]:
    return {"fused_score": FUSED_SCORE_LAUNCHES, "knn_topk": KNN_TOPK_LAUNCHES}


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
