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
- **Two families.** :class:`BatchScorer` (linear) and
  :class:`GBTBatchScorer` (the forest; its fused explain leg is the cached
  TreeSHAP explainer) share the serving protocol, so the micro-batcher and
  the fused flush do not know which family they serve.
- **Three h2d wires** (``io_dtype``). ``float32`` ships the rows;
  ``bfloat16`` halves the bytes (a pinned bf16 staging tensor, rounded to
  nearest even as ``ml_dtypes`` rounds; the card's kernel reads bf16 rows);
  ``int8`` ships per-feature quantization codes over a
  :class:`~fraud_detection_tpu_torch.ops.quant.QuantCalibration`, encoded
  on the host by the JAX package's numpy steps (so the codes are bitwise
  its codes). The linear family folds the dequant scale into its weights
  and scores the codes upcast to f32 (exact: they are small integers); the
  forest dequantizes explicitly (``codes · scale``), the multiply the drift
  histograms bin.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.quant import QuantCalibration, derive_calibration
from fraud_detection_tpu_torch.ops.scaler import ScalerParams

#: the h2d wires a scorer can be built with
WIRES = ("float32", "bfloat16", "int8")


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
    ``score_fn(score_args, x)`` and the reason-code leg's ``explain_args``
    — the raw-space linear-SHAP pair ``(coef, background_mean)``, or the
    GBT family's ``TreeShapExplainer``. On the int8 wire ``dequant_scale``
    is the per-feature (d,) f32 scale the flush multiplies the codes by
    for the drift histograms, and ``score_codes`` says whether
    ``score_fn`` takes the codes (linear: the scale folded into the
    weights) or the dequantized rows (the forest). ``ledger`` is the
    scorer's :class:`~fraud_detection_tpu_torch.ledger.state.LedgerSpec`
    when the family is widened: the flush then runs the ledger program
    (``monitor/drift._fused_flush_ledger``), which computes the velocity
    block on the device and scores the widened rows with the raw-space
    ``score_args``."""

    score_fn: Callable
    score_args: Any
    dequant_scale: torch.Tensor | None = None
    score_codes: bool = True
    explain_args: Any = None
    ledger: Any = None


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


def _cast_scores(p: torch.Tensor, out_dtype) -> torch.Tensor:
    """Cast f32 scores to a d2h return wire. ``uint8`` ships
    ``round(p·255)`` (round half to even, like the reference)."""
    if out_dtype == torch.uint8:
        return torch.round(p * 255.0).to(torch.uint8)
    if out_dtype == torch.float32:
        return p
    return p.to(out_dtype)


def _raw_score_linear(score_args, x: torch.Tensor) -> torch.Tensor:
    """``sigmoid(x @ coef + intercept)``; ``score_args = (coef,
    intercept)``. The fused flush's score body: the ``fused_score`` kernel
    on the card, its plain version on the CPU. The kernel reads f32 or bf16
    rows; int8 codes go in upcast to f32, which is exact."""
    coef, intercept = score_args
    if x.dtype == torch.int8:
        x = x.float()
    return kernels.fused_score(coef, intercept, x)


def _raw_score_gbt(model, x: torch.Tensor) -> torch.Tensor:
    """The forest's score body; ``score_args`` is the GBTModel."""
    from fraud_detection_tpu_torch.ops.gbt import gbt_predict_proba

    return gbt_predict_proba(model, x)


def _gbt_score_dequant(model, x: torch.Tensor, scale: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """The forest's split int8 path: explicit dequant, then the forest —
    the same multiply the fused flush shares with the histogram bin."""
    from fraud_detection_tpu_torch.ops.gbt import gbt_predict_proba

    return _cast_scores(gbt_predict_proba(model, x.float() * scale), out_dtype)


# --------------------------------------------------------------------------
# Zero-allocation staging: reusable per-bucket host buffers
# --------------------------------------------------------------------------


def _host_zeros(shape, pin: bool, dtype=torch.float32) -> np.ndarray:
    """A zeroed numpy buffer; page-locked when ``pin`` (the h2d copy of a
    pinned buffer runs asynchronously on the copy engine). The ndarray
    keeps its torch storage alive."""
    return torch.zeros(shape, dtype=dtype, pin_memory=pin).numpy()


class _StagingSlot:
    """One bucket's worth of host staging: the f32 row buffer, the buffer
    the h2d copy ships (``io``: the f32 buffer itself on the f32 wire, a
    pinned int8 buffer on the int8 wire, a pinned ``torch.bfloat16``
    tensor on the bf16 wire — numpy has no bf16), on the int8 wire an f32
    ``scratch`` to quantize through (the raw rows must survive the encode:
    the split path's monitoring copy reads them), the validity mask (1.0
    for real rows, 0.0 for bucket padding), the return-wire decode buffer
    and, on first use, the explain decode buffers and the ledger's
    per-row columns."""

    __slots__ = ("bucket", "f32", "io", "scratch", "valid", "scores", "ei", "ev",
                 "ls", "lf", "lt", "lh", "pin", "pool")

    def __init__(self, bucket: int, n_features: int, pool=None, pin=False,
                 wire: str = "float32"):
        self.bucket = bucket
        self.f32 = _host_zeros((bucket, n_features), pin)
        if wire == "bfloat16":
            self.io = torch.zeros((bucket, n_features), dtype=torch.bfloat16,
                                  pin_memory=pin)
        elif wire == "int8":
            self.io = _host_zeros((bucket, n_features), pin, torch.int8)
        else:
            self.io = self.f32
        self.scratch = (
            np.zeros((bucket, n_features), np.float32) if wire == "int8" else None
        )
        self.valid = _host_zeros((bucket,), pin)
        self.scores = np.zeros((bucket,), np.float32)
        self.ei: np.ndarray | None = None  # (bucket, k) int32 reason indices
        self.ev: np.ndarray | None = None  # (bucket, k) f32 reason values
        # the ledger flush's per-row columns (staged, then copied h2d)
        self.ls: np.ndarray | None = None  # (bucket,) int64 table slot
        self.lf: np.ndarray | None = None  # (bucket,) int64 fingerprint
        self.lt: np.ndarray | None = None  # (bucket,) f32 event time
        self.lh: np.ndarray | None = None  # (bucket,) f32 has-entity mask
        self.pin = pin
        self.pool = pool

    def ensure_ledger(self) -> None:
        """Materialize the ledger's per-row staging columns — first ledger
        flush of a slot only, counted in the pool's ``allocations``."""
        if self.ls is None:
            if self.pool is not None:
                with self.pool._lock:
                    self.pool.allocations += 1
            self.ls = _host_zeros((self.bucket,), self.pin, torch.int64)
            self.lf = _host_zeros((self.bucket,), self.pin, torch.int64)
            self.lt = _host_zeros((self.bucket,), self.pin)
            self.lh = _host_zeros((self.bucket,), self.pin)

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

    def __init__(self, n_features: int, pin: bool = False, wire: str = "float32"):
        self.n_features = n_features
        self.pin = pin
        self.wire = wire
        self._free: dict[int, list[_StagingSlot]] = {}
        self._lock = threading.Lock()
        self.allocations = 0

    def acquire(self, bucket: int) -> _StagingSlot:
        with self._lock:
            free = self._free.get(bucket)
            if free:
                return free.pop()
            self.allocations += 1
        return _StagingSlot(bucket, self.n_features, pool=self, pin=self.pin,
                            wire=self.wire)

    def release(self, slot: _StagingSlot) -> None:
        with self._lock:
            self._free.setdefault(slot.bucket, []).append(slot)


class _BucketedScorer:
    """Shared serving mechanics: pad request batches up to power-of-two
    buckets, encode them on the scorer's wire and score on
    ``self.device``. Subclasses provide ``n_features``, ``io_dtype`` and
    ``_score_padded``."""

    min_bucket: int
    n_features: int
    device: torch.device
    io_dtype: str = "float32"
    #: the int8 wire's per-feature dequant scale (host copy), set by
    #: :meth:`_bind_calibration`; both families share one host quantizer
    _quant_scale: np.ndarray | None = None
    calibration: QuantCalibration | None = None

    def _score_padded(self, x: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def _bind_calibration(self, calibration: QuantCalibration) -> None:
        """Adopt a quant calibration as this scorer's int8 wire: the host
        encoder multiplies by 1/scale, the dequant paths by scale."""
        self.calibration = calibration
        self._quant_scale = np.asarray(calibration.scale, np.float32)
        self._inv_quant_scale = (1.0 / self._quant_scale).astype(np.float32)
        self._dequant_scale = torch.from_numpy(self._quant_scale.copy()).to(self.device)

    def _prepare_host(self, x: np.ndarray):
        """Host-side wire encoding of f32 rows: the int8 codes (an ndarray),
        the bf16 rows (a ``torch.bfloat16`` tensor), or ``x`` itself."""
        if self._quant_scale is not None:
            buf = x * self._inv_quant_scale
            np.rint(buf, out=buf)
            np.clip(buf, -127.0, 127.0, out=buf)
            return buf.astype(np.int8)
        if self.io_dtype == "bfloat16":
            return torch.from_numpy(x).to(torch.bfloat16)
        return x

    @property
    def staging_features(self) -> int:
        """The width of a staged row (the ingest lanes' frame width): the
        base schema for a ledger-widened scorer, whose velocity columns
        are computed on the device and never ride the wire."""
        return getattr(self, "n_base_features", self.n_features)

    @property
    def staging(self) -> StagingPool:
        """Lazy per-scorer staging pool (pinned host buffers on a card)."""
        pool = getattr(self, "_staging", None)
        if pool is None:
            pool = self._staging = StagingPool(
                self.staging_features, pin=self.device.type == "cuda",
                wire=self.io_dtype,
            )
        return pool

    def _encode_slot(self, slot: _StagingSlot):
        """Wire-encode the slot's staged f32 rows into its ``io`` buffer,
        allocating no buffer: the identity on the f32 wire (``io`` is the
        f32 buffer), the quantizer through the slot's scratch on the int8
        wire, a rounding copy on the bf16 wire."""
        if self._quant_scale is not None:
            np.multiply(slot.f32, self._inv_quant_scale, out=slot.scratch)
            np.rint(slot.scratch, out=slot.scratch)
            np.clip(slot.scratch, -127.0, 127.0, out=slot.scratch)
            np.copyto(slot.io, slot.scratch, casting="unsafe")
            return slot.io
        if slot.io is not slot.f32:
            slot.io.copy_(torch.from_numpy(slot.f32))
        return slot.io

    def stage_items(self, slot: _StagingSlot, items: list):
        """Stage a micro-batch of queue items — single rows (1-D
        ``item[0]``) and ingest blocks (2-D ``item[0]``, a view into a
        pooled ingest slot) — contiguously into the flush slot: one bulk
        ``np.copyto`` a block, one row assignment a single row, no fresh
        array; padding rows are zero with valid 0. Returns the encoded
        ``io`` buffer the h2d copy ships."""
        off = 0
        f32 = slot.f32
        for item in items:
            rows = item[0]
            if rows.ndim == 2:
                k = rows.shape[0]
                np.copyto(f32[off:off + k], rows, casting="unsafe")
                off += k
            else:
                f32[off] = rows
                off += 1
        f32[off:] = 0.0
        slot.valid[:off] = 1.0
        slot.valid[off:] = 0.0
        return self._encode_slot(slot)

    def to_device(self, host) -> torch.Tensor:
        """h2d copy of a staged host buffer (an ndarray, or the bf16 wire's
        tensor) on the current stream (async from a pinned buffer; the
        caller's fetch synchronises before the buffer is reused)."""
        if not isinstance(host, torch.Tensor):
            host = torch.from_numpy(host)
        return host.to(self.device, non_blocking=True)

    def warmup(self, max_bucket: int = 4096) -> None:
        """Score one zero batch per bucket of the ladder, so the first
        requests find the kernel built and the allocator's blocks cached.
        A ledger-widened scorer warms both widths: the base schema (the
        null-slot fold) and the widened block."""
        widths = sorted({self.n_features, self.staging_features})
        b = self.min_bucket
        while b <= max_bucket:
            for d in widths:
                self.predict_proba(np.zeros((b, d), np.float32))
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
        hx = self._prepare_host(np.ascontiguousarray(self._pad(x)))
        return self._score_padded(self.to_device(hx)).cpu().numpy()[:n]

    def predict_proba_stream(
        self,
        x: np.ndarray,
        chunk: int = 1 << 15,
        inflight: int = 8,
        out_dtype: str = "float32",
    ) -> np.ndarray:
        """Streaming scoring: ``inflight`` worker threads each run a chunk's
        whole pipeline (host wire encode → h2d → score → d2h), so up to
        ``inflight`` chunks are in flight at once. On a card each worker
        thread issues its chunks on its own ``torch.cuda.Stream`` and a
        chunk synchronises only that stream; every chunk has its own host
        and device buffers. ``out_dtype`` narrows the return wire
        (``float16``, or ``uint8``: scores in steps of 1/255); the result
        is decoded to f32 probabilities on the host, in row order."""
        from concurrent.futures import ThreadPoolExecutor

        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        out_torch = RETURN_WIRES[out_dtype]
        n = x.shape[0]
        spans = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
        cuda = self.device.type == "cuda"
        local = threading.local()

        def one(span: tuple[int, int]) -> np.ndarray:
            lo, hi = span
            hx = self._prepare_host(np.ascontiguousarray(self._pad(x[lo:hi])))
            if not cuda:
                return self._score_padded(self.to_device(hx), out_torch).numpy()[: hi - lo]
            stream = getattr(local, "stream", None)
            if stream is None:
                stream = local.stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                score = self._score_padded(self.to_device(hx), out_torch)
                host = score.to("cpu", non_blocking=True)
            stream.synchronize()
            return host.numpy()[: hi - lo]

        if len(spans) == 1 or inflight <= 1:
            host = [one(s) for s in spans]
        else:
            with ThreadPoolExecutor(max_workers=inflight) as pool:
                host = list(pool.map(one, spans))  # map keeps the order
        scores = np.concatenate(host)
        if out_dtype == "uint8":
            return scores.astype(np.float32) / 255.0
        return scores.astype(np.float32)

    def predict(self, x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        return (self.predict_proba(x) >= threshold).astype(np.int64)


class BatchScorer(_BucketedScorer):
    """Scaler-folded linear scorer: one ``fused_score`` launch per bucket.

    On the int8 wire the dequant scale folds into the weights as well
    (``codes·(s∘w′) = (codes∘s)·w′``), so the kernel scores the codes
    upcast to f32 with no extra device work; with no calibration given it
    is derived from the scaler (``derive_calibration``'s default range).

    ``ledger_spec`` makes the family ledger-widened: the weights span base
    + K velocity features, clients send base rows, and the ledger flush
    computes the velocity block on the device and scores the widened rows
    with the raw-space weights (on the int8 wire the calibration is sliced
    to the base columns and NOT folded into the weights: the flush
    dequantizes the codes explicitly). A base-width batch scored outside
    the flush (the split path, the worker, ``predict_single``) takes the
    null slot: the stamped null features folded into the intercept, exact
    for a linear family. A widened batch (the replay's, an evaluation's)
    skips the wire encode: its velocity columns are raw f32."""

    #: served model family — the ``scorer_served_family`` gauge label
    family = "linear"

    def __init__(
        self,
        params: LogisticParams,
        scaler: ScalerParams | None = None,
        min_bucket: int = 8,
        io_dtype: str = "float32",
        calibration: QuantCalibration | None = None,
        device: str | torch.device | None = None,
        ledger_spec=None,
    ):
        if io_dtype not in WIRES:
            raise ValueError(f"io_dtype must be float32|bfloat16|int8, got {io_dtype}")
        self.device = resolve_device(device)
        params = params.to(self.device)
        if scaler is not None:
            scaler = scaler.to(self.device)
        folded = fold_scaler_into_linear(params, scaler)
        self.coef = folded.coef.contiguous()
        # the scaler-folded weights before any quant fold: the explain leg
        # attributes raw-space rows with them
        self._raw_coef = self.coef
        self.intercept = folded.intercept.reshape(())
        self.n_features = int(self.coef.shape[0])
        self.ledger_spec = ledger_spec
        self.n_base_features = (
            ledger_spec.n_base if ledger_spec is not None else self.n_features
        )
        if ledger_spec is not None and ledger_spec.n_features != self.n_features:
            raise ValueError(
                f"ledger spec widens {ledger_spec.n_base} → "
                f"{ledger_spec.n_features} features but the params cover "
                f"{self.n_features}"
            )
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
        if io_dtype == "int8":
            if calibration is None:
                if scaler is None:
                    raise ValueError(
                        "int8 IO needs a stamped QuantCalibration or scaler "
                        "stats for calibration"
                    )
                calibration = derive_calibration(scaler)
            if ledger_spec is not None:
                # the wire carries the base columns only
                calibration = QuantCalibration(
                    scale=np.asarray(
                        calibration.scale[: self.n_base_features], np.float32
                    ),
                    sigma_range=calibration.sigma_range,
                )
            self._bind_calibration(calibration)
            if ledger_spec is None:
                self.coef = (self.coef * self._dequant_scale).contiguous()
        if ledger_spec is not None:
            # the null slot: entity-less rows score with the stamped null
            # features, which fold exactly into the intercept
            nf = torch.as_tensor(ledger_spec.null_features, device=self.device)
            self._null_intercept = self.intercept + torch.dot(
                nf, self._raw_coef[self.n_base_features:]
            )
            base = self._raw_coef[: self.n_base_features]
            self._null_coef = (
                base * self._dequant_scale if self._quant_scale is not None else base
            ).contiguous()

    def _prepare_host(self, x: np.ndarray):
        if self.ledger_spec is not None and x.shape[1] == self.n_features:
            return x  # a widened block: raw f32, never wire-encoded
        return super()._prepare_host(x)

    def fused_spec(self) -> FusedSpec:
        explain_args = (self._raw_coef, self._explain_mean)
        if self.ledger_spec is not None:
            return FusedSpec(
                _raw_score_linear, (self._raw_coef, self.intercept),
                dequant_scale=self._dequant_scale if self._quant_scale is not None else None,
                score_codes=False, explain_args=explain_args, ledger=self.ledger_spec,
            )
        if self._quant_scale is not None:
            return FusedSpec(
                _raw_score_linear, (self.coef, self.intercept),
                dequant_scale=self._dequant_scale, score_codes=True,
                explain_args=explain_args,
            )
        return FusedSpec(
            _raw_score_linear, (self.coef, self.intercept),
            explain_args=explain_args,
        )

    def _score_padded(self, x: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        if self.ledger_spec is None:
            args = (self.coef, self.intercept)
        elif x.shape[1] == self.n_base_features:
            args = (self._null_coef, self._null_intercept)
        else:
            args = (self._raw_coef, self.intercept)
        return _cast_scores(_raw_score_linear(args, x), out_dtype)


class GBTBatchScorer(_BucketedScorer):
    """Forest scorer over a :class:`~fraud_detection_tpu_torch.ops.gbt.
    GBTModel` whose bin edges are already in raw input space
    (``fold_scaler_into_gbt``), on the model's device. ``explainer`` is the
    family's ``TreeShapExplainer`` or a callable returning it: the first
    :meth:`fused_spec` resolves and pins it, so constructing the scorer
    never pays the background-table build.

    The bf16 wire bins the bf16-rounded values; the int8 wire needs the
    stamped calibration (the scaler is folded into the bin edges, so there
    is nothing to derive one from) and dequantizes explicitly."""

    family = "gbt"

    def __init__(self, model, min_bucket: int = 8, io_dtype: str = "float32",
                 calibration: QuantCalibration | None = None, explainer=None):
        if io_dtype not in WIRES:
            raise ValueError(f"io_dtype must be float32|bfloat16|int8, got {io_dtype}")
        self._model = model
        self.device = model.bin_edges.device
        self.n_features = int(model.bin_edges.shape[0])
        self.min_bucket = min_bucket
        self.io_dtype = io_dtype
        if io_dtype == "int8":
            if calibration is None:
                raise ValueError(
                    "int8 IO for the GBT family needs a stamped "
                    "QuantCalibration (quant_calibration.npz beside the "
                    "model — the scaler is folded into the bin edges, so "
                    "there is nothing to re-derive one from at serve time)"
                )
            self._bind_calibration(calibration)
        self._explainer = explainer

    def _resolve_explainer(self):
        if callable(self._explainer):
            self._explainer = self._explainer()
        return self._explainer

    def _score_padded(self, x: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        if self._quant_scale is not None and x.dtype == torch.int8:
            return _gbt_score_dequant(self._model, x, self._dequant_scale, out_dtype)
        return _cast_scores(_raw_score_gbt(self._model, x), out_dtype)

    def fused_spec(self) -> FusedSpec:
        if self._quant_scale is not None:
            return FusedSpec(
                _raw_score_gbt, self._model, dequant_scale=self._dequant_scale,
                score_codes=False, explain_args=self._resolve_explainer(),
            )
        return FusedSpec(_raw_score_gbt, self._model,
                         explain_args=self._resolve_explainer())
