"""Crash-consistent artifact writes: the one tmp→fsync→rename helper.

A copy of ``fraud_detection_tpu/ckpt/atomic.py`` (the port imports nothing
of the JAX package). Every ``.npz`` the port writes lands this way:

- bytes land in a temp file **in the same directory** (same filesystem, so
  the rename is atomic),
- the temp file is flushed and ``fsync``-ed (data durable before the name
  flips),
- ``os.replace`` swaps it in (readers see the old bytes or the new bytes,
  never a mixture),
- the **directory** is fsynced afterwards (the rename itself durable).
"""

from __future__ import annotations

import io
import os
import tempfile

import numpy as np


def fsync_dir(directory: str) -> None:
    """Best-effort directory fsync — makes a just-completed rename durable.
    Filesystems that refuse O_RDONLY dir fds degrade to the rename-only
    guarantee."""
    try:
        fd = os.open(directory or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # best-effort on filesystems without dir fsync
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write ``data`` to ``path`` crash-consistently: tmp file beside the
    target, fsync, atomic rename, directory fsync."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # never leave the temp file to be mistaken for an artifact
        try:
            os.unlink(tmp)
        except OSError:  # tmp already renamed/gone
            pass
        raise
    fsync_dir(directory)
    return path


def atomic_savez(path: str, **arrays) -> str:
    """``np.savez`` with the atomic-write discipline (serialized in memory
    first — artifacts here are small)."""
    return atomic_write_bytes(path, savez_bytes(**arrays))


def savez_bytes(**arrays) -> bytes:
    """An npz archive as bytes: for a caller that embeds the archive in a
    larger CRC-framed container (the lifeboat snapshot) and lands that
    through :func:`atomic_write_bytes`."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()
