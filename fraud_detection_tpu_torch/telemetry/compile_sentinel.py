"""Compile sentinel: per-entrypoint compile counting and storm detection.

The JAX package's ``telemetry/compile_sentinel.py`` on the port. JAX counts
XLA executable-cache misses, the worst latency failure on a TPU (a cold
compile stalls every request behind it for seconds). Eager PyTorch has no
executable cache: the port's counterpart of a miss is a kernel library that
a wrapped call causes to be built by ``nvcc`` or loaded into the process
(``ops/kernels.build_kernels``, reached from ``ops/kernels._lib`` at a
kernel's first launch). ``ops/kernels.LOAD_EVENTS`` records each such event
with its seconds and thread; the wrapper reads it before and after the call,
as JAX reads ``fn._cache_size()``.

- :func:`instrument` wraps one callable. The events on the calling thread
  during the call, less those an inner wrapped call already claimed, are
  exported as ``xla_compiles_total{entrypoint}`` and their build-and-load
  seconds as ``xla_compile_duration_seconds{entrypoint}``. The wrapper also
  notes every call's (entrypoint, bucket) for the roofline on the calling
  thread (:func:`~.roofline.note_dispatch`) and, at the first call of each
  fused flush's (entrypoint, bucket), has the roofline take its costs.
  The micro-batcher dispatches a flush and fences it on one executor
  thread, so the roofline pairs the fence with the dispatch as in JAX.
- A **jump detector**: every unexpected compile lands in a per-entrypoint
  sliding window; ``RECOMPILE_STORM_THRESHOLD`` compiles within
  ``RECOMPILE_STORM_WINDOW_S`` latch ``xla_recompile_storm{entrypoint}``
  to 1, which clears as the window drains (:func:`refresh_storm_gauges`
  runs at scrape time). Warm-ups run under :func:`expected_compiles` and
  never feed it.

Until CUDA graphs arrive (ROADMAP items 15a, 15b) a kernel library loads
once a process, so a storm can arise on the card only from a wiped build
directory or a source changed under a running process (each load of a new
build hash counts). The series stay for the alert contract of
``monitoring/prometheus/rules/telemetry-alerts.yml``. A load outside every
wrapped call (the trainer's ``knn_topk`` and ``gbt_hist``) is not counted:
the port has no counterpart of JAX's ``_unattributed`` backend-compile
listener.

:func:`install` wraps the registered bindings in place (:data:`WRAP_TARGETS`:
the flush bodies, the drift window update, the scorer's score and cast, the
``fused_score`` wrapper, the lifecycle gate, linear and tree SHAP, the
forest's predict, and the serving mesh's shard-axis flushes
``mesh.sharded_flush``, ``mesh.lantern_flush``, ``mesh.ledger_flush`` and
``mesh.broadside_flush``). The JAX package's separate quant flush bodies
are one body on the port that takes its wire as an argument; a call of
``_fused_flush`` (``_sharded_flush``) with a ``dequant_scale`` (the int8
wire) counts as ``quickwire.flush`` (``mesh.quickwire_flush``), as JAX
labels it. A kernel library loads once a process, under the innermost
wrapped call that reached it: at a serving start-up the scorer's own
warm-up loads ``fused_score`` first, so the flush entrypoints, the mesh's
included, show their dispatches in the roofline, not here.
"""

from __future__ import annotations

import functools
import importlib
import logging
import threading
import time
from collections import deque

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.telemetry import roofline

log = logging.getLogger("fraud_detection_tpu_torch.telemetry")

_local = threading.local()

_storm_lock = threading.Lock()
_storm_windows: dict[str, deque] = {}

_P = "fraud_detection_tpu_torch"

#: entrypoint label → the (module, attribute) bindings to wrap. Several
#: bindings may alias one function (``models/logistic`` imports
#: ``linear_shap`` by name, so both modules are patched).
WRAP_TARGETS: dict[str, list[tuple[str, str]]] = {
    "scorer": [
        (f"{_P}.ops.scorer", "_raw_score_linear"),
        (f"{_P}.ops.scorer", "_cast_scores"),
        (f"{_P}.ops.kernels", "fused_score"),
    ],
    "drift_window": [(f"{_P}.monitor.drift", "_window_update")],
    "fastlane.flush": [(f"{_P}.monitor.drift", "_fused_flush")],
    "lantern.flush": [(f"{_P}.monitor.drift", "_fused_flush_explain")],
    "ledger.flush": [(f"{_P}.monitor.drift", "_fused_flush_ledger")],
    "broadside.flush": [(f"{_P}.monitor.drift", "_fused_flush_wide")],
    "mesh.sharded_flush": [(f"{_P}.mesh.shardflush", "_sharded_flush")],
    "mesh.lantern_flush": [(f"{_P}.mesh.shardflush", "_sharded_flush_explain")],
    "mesh.ledger_flush": [(f"{_P}.mesh.shardflush", "_sharded_flush_ledger")],
    "mesh.broadside_flush": [(f"{_P}.mesh.shardflush", "_sharded_flush_wide")],
    "gate": [(f"{_P}.lifecycle.gate", "_gate_stats")],
    "linear_shap": [
        (f"{_P}.ops.linear_shap", "linear_shap"),
        (f"{_P}.models.logistic", "linear_shap"),
    ],
    "tree_shap": [(f"{_P}.ops.tree_shap", "tree_shap")],
    "gbt_predict": [(f"{_P}.ops.gbt", "gbt_predict_proba")],
}

#: an entrypoint whose int8-wire calls JAX counts under another name
_WIRE_LABELS = {
    "fastlane.flush": "quickwire.flush",
    "mesh.sharded_flush": "mesh.quickwire_flush",
}


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class expected_compiles:
    """Context manager marking compiles as *expected* (warm-ups, a swap's
    warm-up): they still count in ``xla_compiles_total`` but never feed the
    storm detector — a deploy's bucket-ladder warm-up must not page."""

    def __enter__(self):
        self._prev = getattr(_local, "expected", False)
        _local.expected = True
        return self

    def __exit__(self, *exc):
        _local.expected = self._prev
        return False


# -- storm detector ---------------------------------------------------------

def _note_compiles(entrypoint: str, n: int, now: float | None = None) -> None:
    """Feed ``n`` unexpected compiles into the entrypoint's sliding window
    and refresh its storm gauge."""
    now = now if now is not None else time.monotonic()
    window_s = config.recompile_storm_window_s()
    threshold = config.recompile_storm_threshold()
    with _storm_lock:
        dq = _storm_windows.setdefault(entrypoint, deque())
        for _ in range(n):
            dq.append(now)
        while dq and dq[0] < now - window_s:
            dq.popleft()
        storming = len(dq) >= threshold
    metrics.xla_recompile_storm.labels(entrypoint).set(1 if storming else 0)
    if storming:
        log.error(
            "RECOMPILE STORM on %r: %d kernel-library builds or loads in the "
            "last %.0fs — a build directory or a kernel source is changing "
            "under the running process", entrypoint, len(dq), window_s,
        )


def refresh_storm_gauges() -> None:
    """Prune every window and re-derive the storm gauges — called at scrape
    time so a storm clears once its window drains even with no new calls."""
    now = time.monotonic()
    window_s = config.recompile_storm_window_s()
    threshold = config.recompile_storm_threshold()
    with _storm_lock:
        states = {}
        for ep, dq in _storm_windows.items():
            while dq and dq[0] < now - window_s:
                dq.popleft()
            states[ep] = len(dq) >= threshold
    for ep, storming in states.items():
        metrics.xla_recompile_storm.labels(ep).set(1 if storming else 0)


def _reset_for_tests() -> None:
    with _storm_lock:
        _storm_windows.clear()


# -- the wrapper ------------------------------------------------------------

def _loads_since(start: int) -> tuple[int, float]:
    """(count, seconds) of the kernel-library events this thread appended to
    ``kernels.LOAD_EVENTS`` from index ``start`` on."""
    me = threading.get_ident()
    n, secs = 0, 0.0
    for _, seconds, tid in kernels.LOAD_EVENTS[start:]:
        if tid == me:
            n += 1
            secs += seconds
    return n, secs


def instrument(entrypoint: str, fn):
    """Wrap ``fn`` so the kernel libraries its calls build or load are
    counted and timed under ``entrypoint``, and its dispatches noted for the
    roofline. Idempotent: an instrumented callable is returned as it is."""
    if getattr(fn, "_spyglass_entrypoint", None) is not None:
        return fn
    wire_label = _WIRE_LABELS.get(entrypoint)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        ep = (wire_label if wire_label is not None
              and kwargs.get("dequant_scale") is not None else entrypoint)
        stack = _stack()
        frame = [0, 0.0]  # events and seconds claimed by inner wrapped calls
        stack.append(frame)
        start = len(kernels.LOAD_EVENTS)
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()
            if len(kernels.LOAD_EVENTS) != start:  # else a hit: nothing loaded
                total, total_secs = _loads_since(start)
                if stack:  # the enclosing wrapped call must not count them again
                    stack[-1][0] += total
                    stack[-1][1] += total_secs
                misses, secs = total - frame[0], total_secs - frame[1]
                if misses > 0:
                    metrics.xla_compiles.labels(ep).inc(misses)
                    metrics.xla_compile_duration.labels(ep).observe(secs)
                    if not getattr(_local, "expected", False):
                        _note_compiles(ep, misses)
            roofline.note_dispatch(ep, args)
            if roofline.wants_capture(ep, args):
                roofline.capture(ep, args, kwargs)

    wrapped._spyglass_entrypoint = entrypoint
    return wrapped


# -- in-place installation --------------------------------------------------

def install() -> list[str]:
    """Instrument every registered binding in place; returns the bindings
    wrapped (empty when all already are). Runs at service start-up, before
    any scorer is built."""
    wrapped: list[str] = []
    for entrypoint, bindings in WRAP_TARGETS.items():
        for mod_name, attr in bindings:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            new = instrument(entrypoint, fn)
            if new is not fn:
                setattr(mod, attr, new)
                wrapped.append(f"{mod_name}.{attr}")
    if wrapped:
        log.info("compile sentinel installed on %d bindings", len(wrapped))
    return wrapped


def uninstall() -> None:
    """Restore the original callables."""
    for bindings in WRAP_TARGETS.values():
        for mod_name, attr in bindings:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            orig = getattr(fn, "__wrapped__", None)
            if orig is not None and getattr(fn, "_spyglass_entrypoint", None):
                setattr(mod, attr, orig)
