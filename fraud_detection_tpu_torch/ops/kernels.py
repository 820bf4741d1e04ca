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
module-level integer (``FUSED_SCORE_LAUNCHES``), so a run can show that
the served path went through the kernel.
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
}

#: launches of the fused_score kernel (CUDA tensors only; the CPU path and
#: the plain version never count)
FUSED_SCORE_LAUNCHES = 0

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel with a source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def reset_launch_counts() -> None:
    global FUSED_SCORE_LAUNCHES
    with _lock:
        FUSED_SCORE_LAUNCHES = 0


def launch_counts() -> dict[str, int]:
    return {"fused_score": FUSED_SCORE_LAUNCHES}


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
