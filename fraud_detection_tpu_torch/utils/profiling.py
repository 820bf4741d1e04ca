"""Device-side profiling on ``torch.profiler``.

The JAX package's ``utils/profiling.py`` on the port: :func:`device_trace`
captures the CPU's and (with a card) the CUDA activity of everything run
inside the block, every thread of the process included, and writes a
Chrome trace (``trace.json``, open it in Perfetto or ``chrome://tracing``)
under ``log_dir``; :func:`annotate` names host-side regions so they line up
with the kernels in that timeline.

Usage::

    with device_trace("/tmp/torch-trace"):
        with annotate("score-batch"):
            scorer.predict_proba(x)

``torch.profiler`` records CPU ops and ``record_function`` ranges only on
the threads it is enabled for, while CUPTI sees every launch: a capture
started on a request thread would miss the micro-batcher's executor
thread. :func:`device_trace` therefore profiles all threads
(``_ExperimentalConfig(profile_all_threads=True)``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

log = logging.getLogger("fraud_detection_tpu_torch.profiling")

#: the trace file :func:`device_trace` writes under its ``log_dir``
TRACE_FILE = "trace.json"

# Count of device_trace blocks currently capturing. annotate() keys off this
# so the disabled path (serving hot loops run annotated but untraced)
# allocates nothing a call.
_active_traces = 0


def _profiler():
    """A ``torch.profiler.profile`` over the CPU and, with a card, CUDA,
    recording every thread's ops and ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        ),
    )


def _start(log_dir: str):
    """Start a capture into ``log_dir``; the started profiler. Raises what
    the profiler raises."""
    global _active_traces
    os.makedirs(log_dir, exist_ok=True)
    prof = _profiler()
    prof.start()
    _active_traces += 1
    return prof


def _stop(prof, log_dir: str) -> str:
    """Stop ``prof`` and write its trace; the trace file's path."""
    global _active_traces
    _active_traces -= 1
    prof.stop()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def capture(log_dir: str):
    """Trace everything run inside the block into ``log_dir``; yields the
    trace file's path (written when the block ends). Raises when the
    profiler cannot start or stop: the caller that asked for a trace is told
    it has none (``POST /admin/profile`` answers 5xx)."""
    prof = _start(log_dir)
    path = os.path.join(log_dir, TRACE_FILE)
    try:
        yield path
    finally:
        _stop(prof, log_dir)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a trace of everything run inside the block into ``log_dir``
    (``trace.json``). Never raises out of a profiler failure — a broken
    profiler must not take a training run down; it logs and runs the block
    unprofiled."""
    t0 = time.perf_counter()
    prof = None
    try:
        prof = _start(log_dir)
    except Exception as e:  # noqa: BLE001 — the trace is best-effort here
        log.warning("profiler start failed (%s); running unprofiled", e)
    try:
        yield log_dir
    finally:
        if prof is not None:
            try:
                path = _stop(prof, log_dir)
                log.info("device trace captured to %s (%.2fs)", path,
                         time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001
                log.warning("profiler stop failed: %s", e)


def _raw_trace_active() -> bool:
    """True while a ``torch.profiler.profile`` that :func:`device_trace`
    did not start is recording: the profiler's own process-wide flag."""
    from torch.autograd import profiler

    return bool(profiler._is_profiler_enabled)


class _NullAnnotation:
    """Shared no-op context manager for the trace-off path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_ANNOTATION = _NullAnnotation()


def annotate(name: str):
    """Name a host-side region in the trace
    (``torch.profiler.record_function``). Outside a trace this returns one
    shared no-op context manager — no allocation, so annotations can sit on
    the serving hot path at no cost when nobody is tracing. Inside one —
    :func:`device_trace`'s, or a ``torch.profiler.profile`` the caller
    started itself — it is a live range."""
    if _active_traces == 0 and not _raw_trace_active():
        return _NULL_ANNOTATION
    from torch.profiler import record_function

    return record_function(name)


def save_device_memory_profile(path: str) -> bool:
    """Dump the card's allocator snapshot (``torch.cuda.memory.
    _dump_snapshot``, a pickle that PyTorch's memory visualizer reads) to
    ``path``; returns False (logged) where there is none: no card, or a
    build without the snapshot API. The snapshot's allocation history holds
    only what was allocated after ``torch.cuda.memory._record_memory_history``
    was turned on."""
    import torch

    dump = getattr(torch.cuda.memory, "_dump_snapshot", None)
    if not torch.cuda.is_available() or dump is None:
        log.warning("device memory profile unavailable: no card or no snapshot API")
        return False
    try:
        dump(path)
        return True
    except Exception as e:  # noqa: BLE001
        log.warning("device memory profile unavailable: %s", e)
        return False
