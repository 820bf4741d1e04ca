"""Device-memory watermark gauges.

The JAX package's ``telemetry/devicemem.py`` on the port, read from the
caching allocator of the served device (``torch.cuda.memory_stats``):

- ``device_memory_bytes_in_use`` — ``allocated_bytes.all.current``;
- ``device_memory_peak_bytes_in_use`` — ``allocated_bytes.all.peak``, or a
  process-lifetime high-water mark of the in-use bytes where that is higher;
- ``device_memory_bytes_limit`` — the card's total memory
  (``torch.cuda.mem_get_info``) times the process's memory fraction.

What the gauges do not see: the CUDA context, the memory of the loaded
kernel libraries and cuBLAS's workspaces, which the allocator does not
hand out, and the blocks it holds reserved but not allocated. Refreshes are
pull-driven (the API refreshes at the ``/metrics`` scrape, the worker every
~30 s in its poll loop through :func:`maybe_refresh`). On the CPU there are
no stats: :func:`refresh` returns None and the gauges stay at 0, as JAX's
do on a backend without memory stats.
"""

from __future__ import annotations

import logging
import threading
import time

import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.service import metrics

log = logging.getLogger("fraud_detection_tpu_torch.telemetry")

_lock = threading.Lock()
_last_refresh = 0.0
_peak_seen = 0


def _stats(device) -> tuple[int, int, int] | None:
    """(in use, limit, allocator peak) of ``device`` (default ``DEVICE``),
    or None on the CPU or without a card."""
    dev = torch.device(device if device is not None else config.device_backend())
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(dev)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    peak = int(stats.get("allocated_bytes.all.peak", in_use))
    _, total = torch.cuda.mem_get_info(dev)
    # the reader is recent; an older build has only the setter, and then
    # the fraction is its default, 1, unless this process set it
    reader = getattr(torch.cuda, "get_per_process_memory_fraction", None)
    fraction = reader(dev) if reader is not None else 1.0
    return in_use, int(total * fraction), peak


def refresh(device=None) -> dict | None:
    """Read the served device's allocator and update the gauges. Returns
    the stats dict, or None where the device reports no memory stats."""
    global _peak_seen
    got = _stats(device)
    if got is None:
        return None
    in_use, limit, peak = got
    with _lock:
        _peak_seen = max(_peak_seen, in_use, peak)
        peak_out = _peak_seen
    metrics.device_memory_bytes_in_use.set(in_use)
    metrics.device_memory_bytes_limit.set(limit)
    metrics.device_memory_peak_bytes_in_use.set(peak_out)
    return {
        "bytes_in_use": in_use,
        "bytes_limit": limit,
        "peak_bytes_in_use": peak_out,
    }


def maybe_refresh(min_interval_s: float = 30.0, device=None) -> None:
    """Rate-limited :func:`refresh` of ``device`` for polling loops (the
    worker)."""
    global _last_refresh
    now = time.monotonic()
    with _lock:
        if now - _last_refresh < min_interval_s:
            return
        _last_refresh = now
    refresh(device)
