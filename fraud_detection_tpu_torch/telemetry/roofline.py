"""Live roofline gauges for the fused serving flushes.

The JAX package's ``telemetry/roofline.py`` on the port:

- **Per-program costs.** The compile sentinel wraps every fused flush
  body (``monitor/drift``); at the first dispatch of each ``(entrypoint,
  bucket)`` the wrapper hands the call to :func:`capture`, which records
  the flush's flops and bytes and exports ``device_program_flops``.
- **Per-flush division.** The micro-batcher dispatches the flush and fences
  it on one executor thread (the ``device_compute`` stage); right after
  the fence it calls :func:`note_device_time` with the measured duration.
  The dispatch the sentinel noted on the same thread names the entrypoint
  and bucket, so ``device_utilization_fraction{entrypoint}`` = flops /
  duration / peak, smoothed by an EWMA (α 0.2). Steady-state cost: one
  thread-local read, two dict lookups, one gauge set.
- **Peaks.** ``DEVICE_PEAK_FLOPS`` and ``DEVICE_PEAK_BYTES_PER_S`` when the
  operator pins them; else :func:`ensure_peak` and :func:`ensure_membw`,
  run once inside the warm-up, measure what the device does.

``device_compute`` includes the h2d upload and the launches' host cost, so
the gauge is an end-to-end utilization (the number that bounds
throughput), not a duty cycle of the card's units. :func:`audit` places
every captured program on the roofline (arithmetic intensity against the
ridge point) and grades measured utilization against the ceiling the
roofline permits (``KERNEL_CANDIDATE_SLACK`` 0.6; the verdict strings are
JAX's).

Three things differ from the JAX package, by necessity:

1. **Where the costs come from.** JAX reads XLA's ``cost_analysis()`` of
   the freshly compiled executable. Eager PyTorch has no such thing, and
   ``torch.utils.flop_counter`` sees neither a ``ctypes`` kernel nor
   elementwise work. So :func:`flush_cost` computes a flush's flops and
   bytes from its shapes: a function of (entrypoint, bucket, width, explain
   k, drift bins, forest trees and depth, wire element size). It counts the
   score (:func:`fused_score_cost`, the formula of ``chip_smoke.py``'s
   ``fused_score_bound``; a forest: :func:`forest_score_ops`), the explain
   leg (linear ``n·d``; TreeSHAP :func:`tree_shap_ops`, the L·D a (row,
   tree) of ``chip_smoke.py``'s TreeSHAP bound), the int8 wire's dequant
   and the drift window's histogram fold (:func:`drift_fold_ops`); and the
   bytes of the rows, the model's parameters, the scores, the window state
   and the explain outputs, each read or written once. The ledger's table
   traffic and the wide table's gathers are not counted: for those flushes
   the count is a lower bound.
2. **The peak probe.** JAX times a 512 × 512 f32 matmul by the host clock;
   on the H100 that reads mostly launch overhead. On the card the probe
   times an 8192 × 8192 f32 matmul (enough to fill the card) with CUDA
   events, best of 5. TF32 stays off (``device.set_precision_policy``), so
   it measures the float32 rate outside the tensor cores, the denominator
   of the float32 serving programs. On the CPU it keeps JAX's 512 and the
   host clock.
3. **The bandwidth probe.** JAX streams a 32 MiB add, which on the H100
   stays in the 50 MB L2 and would read L2 bandwidth. On the card the probe
   streams a 1 GiB add (1 GiB read, 1 GiB written) timed by CUDA events,
   best of 5; on the CPU JAX's 32 MiB by the host clock.

A probe that fails raises: the warm-up fails with it rather than leaving
the gauges silent.
"""

from __future__ import annotations

import logging
import threading
import time

import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.service import metrics

log = logging.getLogger("fraud_detection_tpu_torch.telemetry")

_local = threading.local()

_lock = threading.Lock()
#: (entrypoint, bucket) → {"flops": float, "bytes": float}
_costs: dict[tuple[str, int], dict] = {}
#: (entrypoint, bucket) whose cost capture failed: logged once, not retried
_uncosted: set[tuple[str, int]] = set()
_peak_flops: float = 0.0
_peak_bytes_per_s: float = 0.0
#: entrypoint → EWMA'd utilization (mirrors the gauge for /slo/status)
_util: dict[str, float] = {}
_util_gauges: dict[str, object] = {}
_flops_gauges: dict[str, object] = {}

#: EWMA smoothing of the utilization gauge: heavy enough to damp a flush's
#: host-timer noise, light enough that a collapse shows within tens of
#: flushes.
_EWMA_ALPHA = 0.2

#: the probes' sizes: matmul side and streamed f32 elements, by device type
PEAK_PROBE_N = {"cuda": 8192, "cpu": 512}
MEMBW_PROBE_ELEMS = {"cuda": 1 << 28, "cpu": 1 << 23}
PROBE_REPS = 5


# -- shape-derived costs ------------------------------------------------------

def fused_score_cost(n: int, d: int, elem_bytes: int = 4) -> tuple[int, int]:
    """(operations, bytes) of ``sigmoid(x · coef + b)`` over n rows of d:
    a multiply-add an element, then bias, exp, add and divide a row; x read
    once at ``elem_bytes`` an element, coef and intercept read once, one f32
    score written. ``chip_smoke.py``'s ``fused_score_bound`` divides these."""
    return 2 * n * d + 4 * n, elem_bytes * n * d + 4 * d + 4 + 4 * n


def tree_shap_ops(n: int, trees: int, depth: int) -> int:
    """Operations of compact TreeSHAP over n rows: per (row, tree) L·D
    compares and L·D adds, L = 2^depth leaves (each leaf's level values
    summed to its nodes, the nodes to their features). ``chip_smoke.py``'s
    ``shap_work`` counts the same."""
    return 2 * n * trees * (1 << depth) * depth


def forest_score_ops(n: int, trees: int, depth: int) -> int:
    """Operations of a forest's score over n rows: per (row, tree) ``depth``
    compares to reach a leaf and one add of its value, then the sigmoid's
    four a row."""
    return n * trees * (depth + 1) + 4 * n


def drift_fold_ops(n: int, d: int, feature_bins: int, score_bins: int) -> int:
    """Operations of the drift window's fold of n rows of d: a compare an
    (element, interior edge) and a weighted add an element into its bin,
    the same for the score, and the decay's multiply-add on every window
    cell (the feature and score histograms and the row count)."""
    window = d * feature_bins + score_bins + 1
    return n * d * feature_bins + n * score_bins + 2 * window


def flush_cost(
    n: int,
    d: int,
    *,
    feature_bins: int,
    score_bins: int,
    d_in: int | None = None,
    elem_bytes: int = 4,
    out_bytes: int = 4,
    explain_k: int = 0,
    forest: tuple[int, int, int] | None = None,
    dequant: bool = False,
    shards: int = 1,
) -> tuple[float, float]:
    """(flops, bytes) of one fused flush over a bucket of ``n`` rows scored
    at width ``d`` (the ledger and wide flushes' widened width) from rows
    staged ``d_in`` wide (default ``d``) at ``elem_bytes`` an element (4
    f32, 2 bf16, 1 int8 codes). ``forest`` is ``(trees, depth, n_bins)``
    for the GBT family, None for the linear one; ``dequant`` the int8 wire's
    multiply; ``out_bytes`` the score return wire's element size. Bytes: each
    input read once (the rows, the valid mask, the model's parameters, the
    window state and its edges), each output written once (the scores, the
    window state, the reason codes). ``shards`` windows (the serving mesh's
    per-shard windows) are each read and written once; the fold's work is
    the same however the rows split."""
    d_in = d if d_in is None else d_in
    ops = 0
    nbytes = elem_bytes * n * d_in + 4 * n
    if dequant:
        ops += n * d_in
        nbytes += 4 * d_in
    if forest is None:
        score_ops, _ = fused_score_cost(n, d, elem_bytes)
        ops += score_ops
        nbytes += 4 * d + 4
    else:
        trees, depth, n_bins = forest
        ops += forest_score_ops(n, trees, depth)
        internal, leaves = (1 << depth) - 1, 1 << depth
        nbytes += trees * (8 * internal + 4 * leaves) + 4 * d * (n_bins - 1) + 4
    if explain_k:
        if forest is None:
            ops += n * d
            nbytes += 4 * d
        else:
            ops += tree_shap_ops(n, forest[0], forest[1])
        idx_bytes = 1 if d <= 256 else 4
        val_bytes = 4 if out_bytes == 4 else 2
        nbytes += n * explain_k * (idx_bytes + val_bytes)
    ops += drift_fold_ops(n, d, feature_bins, score_bins)
    window = d * feature_bins + score_bins + 1
    nbytes += 2 * 4 * window * shards + 4 * (d * (feature_bins - 1) + score_bins - 1)
    nbytes += out_bytes * n
    return float(ops), float(nbytes)


def program_cost(entrypoint: str, args, kwargs) -> tuple[float, float]:
    """:func:`flush_cost` of one call of a fused flush body
    (``monitor/drift._fused_flush``, ``_fused_flush_explain``,
    ``_fused_flush_ledger``, ``_fused_flush_wide``, and the serving mesh's
    ``mesh/shardflush`` flushes over them), read from its arguments: the
    window (``args[0]``) gives the scored width, the bins and the shards,
    the staged rows (the first 2-D tensor) the bucket, width and wire, a
    ``GBTModel`` among the arguments the forest."""
    window = args[0]
    # the serving mesh's per-shard windows carry a leading shard axis
    *lead, d, feature_bins = (int(s) for s in window.feature_counts.shape)
    score_bins = int(window.score_counts.shape[0])
    x = next(a for a in args if isinstance(a, torch.Tensor) and a.dim() == 2)
    model = next((a for a in args if hasattr(a, "split_feature")), None)
    forest = None
    if model is not None:
        forest = (int(model.split_feature.shape[0]), model.depth,
                  int(model.bin_edges.shape[1]) + 1)
    out_dtype = kwargs.get("out_dtype", torch.float32)
    return flush_cost(
        int(x.shape[0]), d, feature_bins=feature_bins, score_bins=score_bins,
        d_in=int(x.shape[1]), elem_bytes=x.element_size(),
        out_bytes=torch.empty((), dtype=out_dtype).element_size(),
        explain_k=int(kwargs.get("explain_k", 0)), forest=forest,
        dequant=kwargs.get("dequant_scale") is not None,
        shards=lead[0] if lead else 1,
    )


# -- the sentinel's hooks -----------------------------------------------------

def _bucket_of(args) -> int:
    """The padded bucket a flush call dispatched: the leading dim of the
    first 2-D tensor argument (the staged rows in every flush signature)."""
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None and len(shape) >= 2:
            return int(shape[0])
    for a in args:
        shape = getattr(a, "shape", None)
        if shape:
            return int(shape[0])
    return 0


def note_dispatch(entrypoint: str, args) -> None:
    """Called by the compile sentinel for every instrumented call: note
    (entrypoint, bucket) on this thread so :func:`note_device_time` can pair
    the flush's fence with it. One thread-local write."""
    if not config.roofline_enabled():
        return
    _local.last = (entrypoint, _bucket_of(args))


def wants_capture(entrypoint: str, args) -> bool:
    """Whether this call's costs are still to be taken: fused flushes only
    (the ``*flush`` entrypoints), once per (entrypoint, bucket)."""
    if not entrypoint.endswith("flush") or not config.roofline_enabled():
        return False
    key = (entrypoint, _bucket_of(args))
    with _lock:
        return key not in _costs and key not in _uncosted


def capture(entrypoint: str, args, kwargs) -> None:
    """Record (entrypoint, bucket)'s flops and bytes from the call's shapes
    (:func:`program_cost`) and export ``device_program_flops``. Never raises into the
    serving path: a failure is logged once with its traceback, and that
    (entrypoint, bucket) stays without a cost."""
    bucket = _bucket_of(args)
    key = (entrypoint, bucket)
    try:
        flops, nbytes = program_cost(entrypoint, args, kwargs)
    except Exception:
        log.warning("roofline cost capture failed for %s", entrypoint, exc_info=True)
        with _lock:
            _uncosted.add(key)
        return
    with _lock:
        _costs[key] = {"flops": flops, "bytes": nbytes}
    g = _flops_gauges.get(entrypoint)
    if g is None:
        g = _flops_gauges[entrypoint] = metrics.device_program_flops.labels(entrypoint)
    g.set(flops)
    log.info("roofline: %s bucket=%d costs %.3g flops, %.3g bytes",
             entrypoint, bucket, flops, nbytes)


def note_device_time(duration_s: float) -> None:
    """Pair the flush's measured ``device_compute`` duration with the last
    fused dispatch on this thread and refresh the utilization gauge."""
    last = getattr(_local, "last", None)
    if last is None or duration_s <= 0.0:
        return
    entrypoint, bucket = last
    _local.last = None
    cost = _costs.get((entrypoint, bucket))
    peak = _peak_flops
    if cost is None or peak <= 0.0:
        return
    util = cost["flops"] / duration_s / peak
    with _lock:
        prev = _util.get(entrypoint)
        util = util if prev is None else prev + _EWMA_ALPHA * (util - prev)
        _util[entrypoint] = util
    g = _util_gauges.get(entrypoint)
    if g is None:
        g = _util_gauges[entrypoint] = metrics.device_utilization_fraction.labels(
            entrypoint
        )
    g.set(util)


# -- the probes ---------------------------------------------------------------

def _probe_device(device) -> torch.device:
    return torch.device(device if device is not None else config.device_backend())


def _release(dev: torch.device) -> None:
    """Hand a probe's blocks back to the card: the serving process would
    otherwise keep gigabytes reserved that it never uses again."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _best_rate(fn, work: float, dev: torch.device, reps: int) -> float:
    """``work`` over the best of ``reps`` timed calls of ``fn`` (after one
    untimed call): CUDA events on the card, the host clock on the CPU."""
    fn()
    best = 0.0
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        if dt > 0:
            best = max(best, work / dt)
    return best


def peak_flops_probe(device=None, n: int | None = None, reps: int = PROBE_REPS) -> float:
    """The achieved f32 FLOP/s of an ``n × n`` matmul on ``device``
    (default ``DEVICE``): ``2n³`` over the best of ``reps`` runs. TF32 off."""
    from fraud_detection_tpu_torch.device import set_precision_policy

    set_precision_policy()
    dev = _probe_device(device)
    n = PEAK_PROBE_N[dev.type] if n is None else n
    a = torch.randn(n, n, device=dev)
    b = torch.randn(n, n, device=dev)
    c = torch.empty(n, n, device=dev)
    try:
        return _best_rate(lambda: torch.matmul(a, b, out=c), 2.0 * n ** 3, dev, reps)
    finally:
        del a, b, c
        _release(dev)


def membw_probe(device=None, elems: int | None = None, reps: int = PROBE_REPS) -> float:
    """The achieved bytes/s of ``x + 1`` over ``elems`` f32 on ``device``
    (default ``DEVICE``): ``8·elems`` (one read, one write) over the best of
    ``reps`` runs."""
    dev = _probe_device(device)
    elems = MEMBW_PROBE_ELEMS[dev.type] if elems is None else elems
    a = torch.ones(elems, device=dev)
    b = torch.empty(elems, device=dev)
    try:
        return _best_rate(lambda: torch.add(a, 1.0, out=b), 8.0 * elems, dev, reps)
    finally:
        del a, b
        _release(dev)


def ensure_peak(device=None, n: int | None = None) -> float:
    """Resolve the peak FLOP/s denominator once: the pinned
    ``DEVICE_PEAK_FLOPS``, else :func:`peak_flops_probe` (run inside the
    warm-up executor, never on a request)."""
    global _peak_flops
    if _peak_flops > 0.0:
        return _peak_flops
    pinned = config.device_peak_flops()
    best = pinned if pinned > 0.0 else peak_flops_probe(device, n)
    if best <= 0.0:
        raise RuntimeError("the roofline's matmul probe measured no rate")
    _peak_flops = best
    metrics.device_peak_flops_estimate.set(best)
    if pinned <= 0.0:
        log.info("roofline: matmul-probe peak ≈ %.3g FLOP/s", best)
    return best


def ensure_membw(device=None, elems: int | None = None) -> float:
    """Resolve the memory-bandwidth denominator once: the pinned
    ``DEVICE_PEAK_BYTES_PER_S``, else :func:`membw_probe`."""
    global _peak_bytes_per_s
    if _peak_bytes_per_s > 0.0:
        return _peak_bytes_per_s
    pinned = config.device_peak_bytes_per_s()
    best = pinned if pinned > 0.0 else membw_probe(device, elems)
    if best <= 0.0:
        raise RuntimeError("the roofline's stream probe measured no rate")
    _peak_bytes_per_s = best
    if pinned <= 0.0:
        log.info("roofline: stream-probe membw ≈ %.3g B/s", best)
    return best


# -- classification -----------------------------------------------------------

#: A program earning less than this fraction of its roofline ceiling is a
#: hand-kernel candidate; at or above it the implementation is close enough
#: to the ceiling that a kernel's upside is inside measurement noise.
KERNEL_CANDIDATE_SLACK = 0.6


def classify_program(
    flops: float,
    nbytes: float,
    seconds: float | None = None,
    *,
    peak_flops: float | None = None,
    peak_bytes_per_s: float | None = None,
) -> dict:
    """Place one program on the roofline: arithmetic intensity (FLOP/byte),
    the ridge point (``peak_flops / peak_bytes_per_s``), the utilization
    ceiling the roofline permits (``min(1, AI/ridge)``), the bound
    (``memory`` below the ridge, ``compute`` at or above) and, with a
    measured duration, the achieved utilization and the verdict:
    ``kernel-candidate`` below ``KERNEL_CANDIDATE_SLACK × ceiling``,
    ``compiler-wins`` otherwise (``unmeasured`` without a duration). Peaks
    default to the resolved probe values."""
    peak = peak_flops if peak_flops is not None else ensure_peak()
    bw = peak_bytes_per_s if peak_bytes_per_s is not None else ensure_membw()
    out: dict = {
        "flops": flops,
        "bytes": nbytes,
        "arithmetic_intensity": (flops / nbytes) if nbytes > 0 else None,
        "ridge": None,
        "ceiling": None,
        "bound": None,
        "utilization": None,
        "verdict": "unmeasured",
    }
    if peak <= 0.0 or bw <= 0.0 or nbytes <= 0.0 or flops <= 0.0:
        return out
    ai = flops / nbytes
    ridge = peak / bw
    ceiling = min(1.0, ai / ridge)
    out.update(ridge=ridge, ceiling=ceiling,
               bound="memory" if ai < ridge else "compute")
    if seconds is not None and seconds > 0.0:
        util = flops / seconds / peak
        out["utilization"] = util
        out["verdict"] = (
            "kernel-candidate" if util < KERNEL_CANDIDATE_SLACK * ceiling
            else "compiler-wins"
        )
    return out


def audit() -> dict:
    """Classify every captured ``entrypoint@bucket`` against the peaks and,
    where flushes have flowed, grade the achieved utilization (seconds
    reconstructed from the entrypoint's EWMA) against its ceiling; a program
    with no measured flush stays ``unmeasured``."""
    peak = ensure_peak()
    bw = ensure_membw()
    with _lock:
        items = list(_costs.items())
        util = dict(_util)
    programs = {}
    for (ep, bucket), c in items:
        u = util.get(ep)
        seconds = c["flops"] / (u * peak) if u and peak > 0.0 else None
        programs[f"{ep}@{bucket}"] = classify_program(
            c["flops"], c["bytes"], seconds, peak_flops=peak, peak_bytes_per_s=bw,
        )
    return {
        "peak_flops": peak,
        "peak_bytes_per_s": bw,
        "kernel_candidate_slack": KERNEL_CANDIDATE_SLACK,
        "programs": programs,
    }


def snapshot() -> dict:
    """The roofline's state for ``/slo/status``: the peaks, each
    entrypoint's smoothed utilization and the captured program costs."""
    with _lock:
        return {
            "peak_flops": _peak_flops,
            "peak_bytes_per_s": _peak_bytes_per_s,
            "utilization": dict(_util),
            "programs": {
                f"{ep}@{bucket}": dict(c) for (ep, bucket), c in _costs.items()
            },
        }


def _reset_for_tests() -> None:
    global _peak_flops, _peak_bytes_per_s
    with _lock:
        _costs.clear()
        _uncosted.clear()
        _util.clear()
    _util_gauges.clear()
    _flops_gauges.clear()
    _peak_flops = 0.0
    _peak_bytes_per_s = 0.0
    _local.last = None
