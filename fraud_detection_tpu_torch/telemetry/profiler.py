"""On-demand device profiling of the live service (``POST /admin/profile``).

The JAX package's ``telemetry/profiler.py`` on the port: capture whatever
the process runs, CPU ops and (with a card) every CUDA kernel, for a bounded
window while live traffic keeps flowing (the micro-batcher's
``annotate("microbatch-score")`` ranges line the trace up with the
kernels), then hand back the trace file (``utils/profiling``; a Chrome
trace for Perfetto).

Guardrails, because the profiler is not free:

- **duration-bounded** — a request is refused (ValueError → 422) outside
  ``(0, DEVICE_PROFILE_MAX_S]``: a forgotten trace must not run for hours;
- **single-flight** — one capture at a time a process; a concurrent request
  gets :class:`ProfileBusy` (409);
- **auth-gated** like the other ``/admin/*`` endpoints (``ADMIN_TOKEN``,
  enforced in ``service/app.py``).

Each capture also refreshes the device-memory watermark (:mod:`.devicemem`)
into its response. A profiler that fails to start or stop raises out of
:meth:`DeviceProfiler.capture`: the endpoint answers 5xx, never a 200
without a trace.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.telemetry import devicemem
from fraud_detection_tpu_torch.utils.profiling import capture as trace_capture

log = logging.getLogger("fraud_detection_tpu_torch.telemetry")


class ProfileBusy(RuntimeError):
    """A capture is already in flight (single-flight guard)."""


class DeviceProfiler:
    def __init__(self, base_dir: str | None = None, device=None):
        self.base_dir = base_dir or config.device_profile_dir()
        self.device = device
        self._lock = threading.Lock()

    @property
    def busy(self) -> bool:
        return self._lock.locked()

    def capture(self, duration_s: float | None = None) -> dict:
        """Blocking capture (run it off the event loop): trace everything
        the process runs for ``duration_s`` seconds; return the trace's path
        and the memory watermark. Raises :class:`ProfileBusy` while a
        capture runs and ValueError for a duration out of bounds."""
        max_s = config.device_profile_max_s()
        if duration_s is None:
            duration_s = config.device_profile_default_s()
        duration_s = float(duration_s)
        if not (0 < duration_s <= max_s):
            raise ValueError(
                f"duration_s must be in (0, {max_s}] "
                f"(DEVICE_PROFILE_MAX_S), got {duration_s}"
            )
        if not self._lock.acquire(blocking=False):
            raise ProfileBusy("a device profile capture is already running")
        try:
            # ns suffix: sequential sub-second captures (single-flight only
            # blocks concurrent ones) must not share a directory
            trace_dir = os.path.join(
                self.base_dir,
                f"{time.strftime('%Y%m%d-%H%M%S')}-{time.time_ns() % 1_000_000_000:09d}",
            )
            t0 = time.perf_counter()
            with trace_capture(trace_dir) as trace_file:
                # the capture window: live traffic keeps flowing through the
                # micro-batcher while the profiler records it. The gauge
                # reads 1 only once the profiler records: its first start
                # in a process initializes CUPTI, which takes seconds
                metrics.device_profile_active.set(1)
                time.sleep(duration_s)
            wall = time.perf_counter() - t0
            metrics.device_profiles.inc()
            mem = devicemem.refresh(self.device)
            log.warning("device profile captured: %s (%.2fs window)",
                        trace_file, duration_s)
            return {
                "trace_dir": trace_dir,
                "trace_file": trace_file,
                "duration_s": duration_s,
                "wall_s": round(wall, 3),
                "device_memory": mem,
                "hint": f"open {trace_file} in Perfetto (ui.perfetto.dev) "
                        "or chrome://tracing",
            }
        finally:
            metrics.device_profile_active.set(0)
            self._lock.release()
