"""Per-request latency decomposition for the micro-batched scoring path.

The port's own copy of the JAX package's ``telemetry/timeline.py``. On a
card the ``device_compute`` stage ends at ONE CUDA event a flush, recorded
after the flush's last launch and synchronised
(``service/microbatch._fence``).

A request's life inside the micro-batcher is six stages, stamped with
``time.perf_counter()`` at each boundary:

- ``enqueue``        submit (``MicroBatcher.score``) → collector pickup
- ``flush_wait``     collector pickup → the batch is handed to a flush task
- ``pad_bucket``     host-side ``np.stack`` + power-of-two bucket padding
                     (+ wire encode for bf16/int8 IO)
- ``device_compute`` h2d transfer + launches + execution, fenced with
                     ONE event per flush (never per row — the fence is the
                     flush's, every row shares it)
- ``d2h``            device→host readback of the score vector
- ``respond``        fence → the flush's futures resolved on the loop

Split by ownership, because the split is what keeps the telemetry cheap
enough for the hot path:

- :class:`RequestTimeline` is per request and carries only what differs per
  row — the enqueue/pickup stamps and the correlation id (two
  ``perf_counter`` calls on the request path);
- :class:`FlushInfo` is ONE shared object per flush holding everything
  every row of the flush has in common — the pad/compute/d2h/respond
  stamps, batch size, bucket, model version, drift flag. The flush loop
  stamps it once and stores one reference per row (``tl.flush = fi``)
  instead of ten per-row attribute writes.

A wall-clock anchor (``time_ns`` at request creation) lets a tracing
layer re-emit the stages as child spans with real timestamps
(:meth:`RequestTimeline.stage_spans_ns`, which
``service/tracing.emit_stage_spans`` reads under the ``predict`` and
``ingest.frame`` spans).
"""

from __future__ import annotations

import time

#: the six stages, in request order — the exported ``stage`` label values
#: and the flight-recorder schema.
STAGES = (
    "enqueue",
    "flush_wait",
    "pad_bucket",
    "device_compute",
    "d2h",
    "respond",
)


class FlushInfo:
    """Everything a flush's rows share: the flush-level stage stamps and
    the serving metadata. One instance per flush, referenced by every
    timeline that rode it."""

    __slots__ = (
        "t_flush_start",
        "t_padded",
        "t_synced",
        "t_fetched",
        "t_resolved",
        "batch_size",
        "bucket",
        "model_version",
        "model_source",
        "drift",
        "recorded_at",
        "shard",
    )

    def __init__(
        self,
        t_flush_start: float = 0.0,
        t_padded: float = 0.0,
        t_synced: float = 0.0,
        t_fetched: float = 0.0,
        batch_size: int = 0,
        bucket: int = 0,
        model_version: int | None = None,
        model_source: str | None = None,
        drift: bool = False,
        shard: int = 0,
    ):
        self.t_flush_start = t_flush_start
        self.t_padded = t_padded
        self.t_synced = t_synced
        self.t_fetched = t_fetched
        self.t_resolved = 0.0
        self.batch_size = batch_size
        self.bucket = bucket
        self.model_version = model_version
        self.model_source = model_source
        self.drift = drift
        self.recorded_at = 0.0
        # panopticon: the switchyard shard whose micro-batcher ran this
        # flush (0 on single-batcher serving) — every flight-recorder
        # record must attribute its flush to the shard that ran it
        self.shard = shard


class RequestTimeline:
    __slots__ = (
        "correlation_id",
        "wall_anchor_ns",
        "perf_anchor",
        "t_enqueued",
        "t_collected",
        "flush",
    )

    def __init__(self, correlation_id: str | None = None):
        now = time.perf_counter()
        self.correlation_id = correlation_id
        self.wall_anchor_ns = time.time_ns()
        self.perf_anchor = now
        self.t_enqueued = now
        self.t_collected = 0.0
        self.flush: FlushInfo | None = None

    # -- durations ---------------------------------------------------------
    def _bounds(self, fi: FlushInfo | None = None) -> list[tuple[str, float, float]]:
        if fi is None:
            fi = self.flush
        if fi is None:
            fi = _EMPTY_FLUSH
        return [
            ("enqueue", self.t_enqueued, self.t_collected),
            ("flush_wait", self.t_collected, fi.t_flush_start),
            ("pad_bucket", fi.t_flush_start, fi.t_padded),
            ("device_compute", fi.t_padded, fi.t_synced),
            ("d2h", fi.t_synced, fi.t_fetched),
            ("respond", fi.t_fetched, fi.t_resolved),
        ]

    def stages(self, fi: FlushInfo | None = None) -> dict[str, float]:
        """Stage name → duration in seconds (0.0 for unstamped stages).
        ``fi`` supplies the flush-level stamps when the per-row ref wasn't
        linked (the flight recorder carries the FlushInfo per entry; the
        per-row ref is only set when tracing needs it)."""
        out: dict[str, float] = {}
        for name, start, end in self._bounds(fi):
            out[name] = max(0.0, end - start) if (start and end) else 0.0
        return out

    def complete(self) -> bool:
        """True when every stage boundary was stamped."""
        return all(start and end for _, start, end in self._bounds())

    def stage_spans_ns(self) -> list[tuple[str, int, int]]:
        """(stage, start_ns, end_ns) wall-clock triples for OTEL child
        spans, skipping unstamped stages."""
        base = self.wall_anchor_ns
        anchor = self.perf_anchor
        out = []
        for name, start, end in self._bounds():
            if not (start and end) or end < start:
                continue
            out.append(
                (
                    name,
                    base + int((start - anchor) * 1e9),
                    base + int((end - anchor) * 1e9),
                )
            )
        return out

    def total_seconds(self, fi: FlushInfo | None = None) -> float:
        fi = fi if fi is not None else self.flush
        if fi is not None and fi.t_resolved and self.t_enqueued:
            return max(0.0, fi.t_resolved - self.t_enqueued)
        return 0.0

    def to_record(self, fi: FlushInfo | None = None) -> dict:
        """The flight-recorder dump row for this request."""
        fi = fi if fi is not None else self.flush
        return {
            "ts": fi.recorded_at if fi is not None else 0.0,
            "correlation_id": self.correlation_id,
            "batch_size": fi.batch_size if fi is not None else 0,
            "bucket": fi.bucket if fi is not None else 0,
            "model_version": fi.model_version if fi is not None else None,
            "model_source": fi.model_source if fi is not None else None,
            "drift": bool(fi.drift) if fi is not None else False,
            "shard": fi.shard if fi is not None else 0,
            "stages": self.stages(fi),
            "total_s": self.total_seconds(fi),
        }


_EMPTY_FLUSH = FlushInfo()
