"""Batched online scorer (f32 wire).

Counterpart of ``fraud_detection_tpu/ops/scorer.py``:

- **Scaler folding.** ``σ((x−μ)/s·w + b) = σ(x·w′ + b′)`` with
  ``w′ = w/s`` and ``b′ = b − μ·w′``, folded once at load time, so serving
  never materializes a scaled copy of the input.
- **Shape buckets.** Request batches pad up to power-of-two buckets, as in
  the reference, so the staging buffers and the drift monitor see a handful
  of shapes. PyTorch runs eagerly, so a bucket costs no compile here.
- **The kernel.** On the card the linear score body is the hand-written
  ``fused_score`` CUDA kernel (:mod:`.kernels`); on the CPU its plain
  version.

Only the float32 wire is ported; the bf16 and int8 wires raise
``NotImplementedError`` (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scaler import ScalerParams


def fold_scaler_into_linear(
    params: LogisticParams, scaler: ScalerParams | None
) -> LogisticParams:
    """Params ``(w′, b′)`` scoring *raw* inputs identically to scoring
    scaled inputs with the original params (float32, like the reference)."""
    if scaler is None:
        return params
    w = params.coef / scaler.scale
    b = params.intercept - torch.dot(scaler.mean, w)
    return LogisticParams(coef=w, intercept=b)


def _bucket(n: int, min_bucket: int = 8) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


class FusedSpec(NamedTuple):
    """What a scorer hands the fused flush (monitor/drift): the score body
    ``score_fn(score_args, x)`` and the raw-space linear-SHAP pair
    ``explain_args = (coef, background_mean)`` for the reason-code leg."""

    score_fn: Callable
    score_args: Any
    explain_args: Any


#: d2h score wire formats: name → the dtype the fused flush returns.
#: ``uint8`` codes are ``round(p · 255)``; both narrow formats decode to
#: f32 probabilities host-side (:func:`decode_scores_into`).
RETURN_WIRES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "uint8": torch.uint8,
}


def decode_scores_into(raw: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Decode a fetched score vector (any return wire) into the
    preallocated f32 buffer ``out``."""
    if raw.dtype == np.uint8:
        np.multiply(raw, np.float32(1.0 / 255.0), out=out)
    else:
        np.copyto(out, raw, casting="unsafe")
    return out


def decode_explain_into(
    raw_idx: np.ndarray, raw_val: np.ndarray, slot: "_StagingSlot"
) -> tuple[np.ndarray, np.ndarray]:
    """Decode fetched top-k reason codes (uint8/int32 indices, f16/f32
    values) into the slot's preallocated explain buffers."""
    slot.ensure_explain(raw_idx.shape[1])
    np.copyto(slot.ei, raw_idx, casting="unsafe")
    np.copyto(slot.ev, raw_val, casting="unsafe")
    return slot.ei, slot.ev


def _raw_score_linear(score_args, x: torch.Tensor) -> torch.Tensor:
    """``sigmoid(x @ coef + intercept)``; ``score_args = (coef,
    intercept)``. The fused flush's score body: the ``fused_score`` kernel
    on the card, its plain version on the CPU."""
    coef, intercept = score_args
    return kernels.fused_score(coef, intercept, x)


# --------------------------------------------------------------------------
# Zero-allocation staging: reusable per-bucket host buffers
# --------------------------------------------------------------------------


def _host_zeros(shape, pin: bool) -> np.ndarray:
    """A zeroed f32 numpy buffer; page-locked when ``pin`` (the h2d copy of
    a pinned buffer runs asynchronously on the copy engine). The ndarray
    keeps its torch storage alive."""
    if not pin:
        return np.zeros(shape, np.float32)
    return torch.zeros(shape, dtype=torch.float32, pin_memory=True).numpy()


class _StagingSlot:
    """One bucket's worth of host staging: the f32 row buffer, the validity
    mask (1.0 for real rows, 0.0 for bucket padding), the return-wire
    decode buffer and, on first use, the explain decode buffers."""

    __slots__ = ("bucket", "f32", "valid", "scores", "ei", "ev", "pool")

    def __init__(self, bucket: int, n_features: int, pool=None, pin=False):
        self.bucket = bucket
        self.f32 = _host_zeros((bucket, n_features), pin)
        self.valid = _host_zeros((bucket,), pin)
        self.scores = np.zeros((bucket,), np.float32)
        self.ei: np.ndarray | None = None  # (bucket, k) int32 reason indices
        self.ev: np.ndarray | None = None  # (bucket, k) f32 reason values
        self.pool = pool

    def ensure_explain(self, k: int) -> None:
        """Materialize the (bucket, k) explain decode buffers — first
        explain flush of a slot only, counted in the pool's
        ``allocations``."""
        if self.ei is None or self.ei.shape[1] != k:
            if self.pool is not None:
                with self.pool._lock:
                    self.pool.allocations += 1
            self.ei = np.zeros((self.bucket, k), np.int32)
            self.ev = np.zeros((self.bucket, k), np.float32)


class StagingPool:
    """Thread-safe freelist of :class:`_StagingSlot` per shape bucket.
    ``allocations`` counts slot creations; in steady state it is constant."""

    def __init__(self, n_features: int, pin: bool = False):
        self.n_features = n_features
        self.pin = pin
        self._free: dict[int, list[_StagingSlot]] = {}
        self._lock = threading.Lock()
        self.allocations = 0

    def acquire(self, bucket: int) -> _StagingSlot:
        with self._lock:
            free = self._free.get(bucket)
            if free:
                return free.pop()
            self.allocations += 1
        return _StagingSlot(bucket, self.n_features, pool=self, pin=self.pin)

    def release(self, slot: _StagingSlot) -> None:
        with self._lock:
            self._free.setdefault(slot.bucket, []).append(slot)


class _BucketedScorer:
    """Shared serving mechanics: pad request batches up to power-of-two
    buckets and score on ``self.device``. Subclasses provide
    ``n_features`` and ``_score_padded``."""

    min_bucket: int
    n_features: int
    device: torch.device

    def _score_padded(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def staging(self) -> StagingPool:
        """Lazy per-scorer staging pool (pinned host buffers on a card)."""
        pool = getattr(self, "_staging", None)
        if pool is None:
            pool = self._staging = StagingPool(
                self.n_features, pin=self.device.type == "cuda"
            )
        return pool

    def stage_rows(self, slot: _StagingSlot, rows: list) -> np.ndarray:
        """Stack ``rows`` into the slot's preallocated buffers (no fresh
        batch array); padding rows are zero with valid 0."""
        n = len(rows)
        np.stack(rows, out=slot.f32[:n])
        slot.f32[n:] = 0.0
        slot.valid[:n] = 1.0
        slot.valid[n:] = 0.0
        return slot.f32

    def to_device(self, host: np.ndarray) -> torch.Tensor:
        """h2d copy of a staged host buffer on the current stream (async
        from a pinned buffer; the caller's fetch synchronises before the
        buffer is reused)."""
        return torch.from_numpy(host).to(self.device, non_blocking=True)

    def warmup(self, max_bucket: int = 4096) -> None:
        """Score one zero batch per bucket of the ladder, so the first
        requests find the kernel built and the allocator's blocks cached."""
        b = self.min_bucket
        while b <= max_bucket:
            self.predict_proba(np.zeros((b, self.n_features), np.float32))
            b *= 2

    def _pad(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        b = _bucket(n, self.min_bucket)
        if b != n:
            x = np.concatenate([x, np.zeros((b - n, x.shape[1]), np.float32)])
        return x

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        n = x.shape[0]
        hx = np.ascontiguousarray(self._pad(x))
        return self._score_padded(self.to_device(hx)).cpu().numpy()[:n]

    def predict(self, x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        return (self.predict_proba(x) >= threshold).astype(np.int64)


class BatchScorer(_BucketedScorer):
    """Scaler-folded linear scorer: one ``fused_score`` launch per bucket."""

    def __init__(
        self,
        params: LogisticParams,
        scaler: ScalerParams | None = None,
        min_bucket: int = 8,
        io_dtype: str = "float32",
        device: str | torch.device | None = None,
    ):
        if io_dtype in ("bfloat16", "int8"):
            raise NotImplementedError(
                f"the {io_dtype} wire is not ported yet: ROADMAP queue 8 "
                "(queue 1, item 8 — the quantized wire); serve on float32"
            )
        if io_dtype != "float32":
            raise ValueError(
                f"io_dtype must be float32|bfloat16|int8, got {io_dtype}"
            )
        self.device = resolve_device(device)
        params = params.to(self.device)
        if scaler is not None:
            scaler = scaler.to(self.device)
        folded = fold_scaler_into_linear(params, scaler)
        self.coef = folded.coef.contiguous()
        self.intercept = folded.intercept.reshape(())
        self.n_features = int(self.coef.shape[0])
        # the fused explain leg's raw-space linear-SHAP params: the folded
        # coef over raw inputs with the scaler mean as background
        # (φⱼ = w′ⱼ·(xⱼ − μⱼ)), the same pair models/logistic.raw_explainer
        # builds, so fused reason codes are bitwise its attributions
        self._explain_mean = (
            scaler.mean if scaler is not None
            else torch.zeros(self.n_features, device=self.device)
        )
        self.min_bucket = min_bucket
        self.io_dtype = io_dtype

    def fused_spec(self) -> FusedSpec:
        return FusedSpec(
            _raw_score_linear, (self.coef, self.intercept),
            explain_args=(self.coef, self._explain_mean),
        )

    def _score_padded(self, x: torch.Tensor) -> torch.Tensor:
        return _raw_score_linear((self.coef, self.intercept), x)
