"""ctypes bindings for the port's native CSV reader (``csrc/csvloader.cpp``).

The port's own copy of the JAX package's ``data/native.py``: mmap and
parallel float parsing straight into a numpy buffer, through the same C
ABI (``csv_open``, ``csv_dims_h``, ``csv_header_h``, ``csv_read_h``,
``csv_close``), so both packages parse a file to the same float32 bits.

The library builds at first use with ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` (``CXX`` overrides the compiler) into the git-ignored
``fraud_detection_tpu_torch/build/libfraudcsv-<hash>.so``, the hash taken
over the source and the flags. The compiler writes a PID-unique temporary
file that is renamed into place, so processes building at once never load
a half-written library. Unlike the JAX package, a failed build or load
raises: ``NATIVE_CSV=0`` is the only way to choose the plain version
(``np.loadtxt``, in ``data/loader.py``).

A file the reader rejects (ragged rows, an empty or malformed field: a
non-zero return code) falls through to the plain version, as the JAX
package's does, so both paths keep the same file semantics; each such
fall-through logs a WARNING and adds one to :data:`NATIVE_CSV_FALLBACKS`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("fraud_detection_tpu_torch.native")

_PKG = Path(__file__).resolve().parent.parent
SRC_PATH = _PKG / "csrc" / "csvloader.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread", "-shared")

#: files the reader rejected and the plain version parsed instead
NATIVE_CSV_FALLBACKS = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """The built library's path: one per (source, flags) hash."""
    tag = hashlib.sha256(
        SRC_PATH.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libfraudcsv-{tag}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its
    path. Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SRC_PATH)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native CSV reader build failed ({cmd[0]}): {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native CSV reader build failed:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.csv_open.argtypes = [ctypes.c_char_p]
    lib.csv_open.restype = ctypes.c_void_p
    lib.csv_close.argtypes = [ctypes.c_void_p]
    lib.csv_close.restype = None
    lib.csv_dims_h.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
    ]
    lib.csv_dims_h.restype = ctypes.c_int
    lib.csv_header_h.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.csv_header_h.restype = ctypes.c_int
    lib.csv_read_h.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_long, ctypes.c_int,
    ]
    lib.csv_read_h.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once) and load the library; raises on a failed build or
    ``dlopen``."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _fall_back(path: str, why: str) -> None:
    global NATIVE_CSV_FALLBACKS
    NATIVE_CSV_FALLBACKS += 1
    log.warning("native CSV reader rejected %s (%s); parsing with np.loadtxt",
                path, why)


def load_csv_native(path: str, n_threads: int = 0
                    ) -> tuple[np.ndarray, list[str]] | None:
    """Parse a numeric CSV → (float32 (rows, cols) matrix, column names),
    or None when the reader rejects the file (counted in
    :data:`NATIVE_CSV_FALLBACKS`; the caller parses it with the plain
    version). Names are unwrapped of CSV double quotes only, as the JAX
    package's reader does."""
    lib = load_library()
    handle = lib.csv_open(os.fsencode(path))
    if not handle:
        _fall_back(path, "open failed")
        return None
    try:
        rows, cols = ctypes.c_long(), ctypes.c_long()
        lib.csv_dims_h(handle, ctypes.byref(rows), ctypes.byref(cols))
        if rows.value <= 0 or cols.value <= 0:
            _fall_back(path, f"{rows.value} rows x {cols.value} columns")
            return None
        hdr = ctypes.create_string_buffer(1 << 20)
        if lib.csv_header_h(handle, hdr, len(hdr)) != 0:
            _fall_back(path, "header longer than 1 MiB")
            return None
        names = [
            c[1:-1] if len(c) >= 2 and c[0] == '"' and c[-1] == '"' else c
            for c in hdr.value.decode().split(",")
        ]
        out = np.empty((rows.value, cols.value), dtype=np.float32)
        rc = lib.csv_read_h(
            handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows.value, cols.value, n_threads,
        )
        if rc != 0:
            _fall_back(path, f"rc={rc}")
            return None
        return out, names
    finally:
        lib.csv_close(handle)
