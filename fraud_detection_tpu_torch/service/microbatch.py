"""Async micro-batching in front of the scorer.

Concurrent requests land in an asyncio queue; a collector drains up to
``max_batch`` rows or waits at most ``max_wait_ms``, then hands the batch
to a flush task, which runs the device work in an executor thread (so the
event loop keeps accepting requests) and resolves each request's future.

A flush stages the rows into a preallocated per-bucket staging slot
(``ops/scorer.StagingPool``; page-locked on a card, so the h2d copy runs
asynchronously), then either:

- **fused** (a watchtower is attached and ``SCORER_FUSED_FLUSH`` is on):
  scores, optional top-k reason codes and the drift-window fold in one
  flush (``monitor/drift.DriftMonitor.fused_flush``) — on the card the
  linear family scores through the ``fused_score`` CUDA kernel and the GBT
  family's reason codes come from the ``tree_shap`` CUDA kernel; or
- **split**: the score alone; the watchtower's ingest thread folds the
  window afterwards.

Either way the flush's one host sync is the device-to-host copy of its
outputs. Up to ``MAX_INFLIGHT`` flushes run at once, so the fetch of flush
N overlaps the staging of flush N+1. Admission is bounded
(``admit_max_rows``): at the bound :class:`AdmissionFull` is raised and the
HTTP edge sheds with 429 + ``Retry-After``.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ops import scorer as scorer_mod
from fraud_detection_tpu_torch.ops.scorer import (
    BatchScorer,
    _bucket,
    decode_explain_into,
    decode_scores_into,
)
from fraud_detection_tpu_torch.service import metrics

log = logging.getLogger("fraud_detection_tpu_torch.microbatch")

#: rows admitted but not yet collected, at most (0 = unbounded)
ADMIT_MAX_ROWS = 65536
#: the retry hint a shed admission carries (one flush window drains it)
ADMIT_RETRY_AFTER_S = 1.0
#: concurrently running flushes
MAX_INFLIGHT = 4


class AdmissionFull(RuntimeError):
    """The bounded admission queue is at capacity: the caller sheds this
    request with a retry hint (HTTP 429 + ``Retry-After``)."""

    def __init__(self, retry_after_s: float, queued_rows: int):
        self.retry_after_s = retry_after_s
        self.queued_rows = queued_rows
        super().__init__(
            f"admission queue full ({queued_rows} rows queued) — retry in "
            f"{retry_after_s:g}s"
        )


def fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """The flush's one host sync: device-to-host copies of its outputs,
    enqueued together, then one wait on the stream."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    dev = tensors[0].device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


class MicroBatcher:
    def __init__(
        self,
        scorer: BatchScorer,
        max_batch: int | None = None,
        max_wait_ms: float | None = None,
        watchtower=None,
        fused: bool | None = None,
        return_wire: str | None = None,
        explain: bool | None = None,
        explain_k: int | None = None,
        admit_max_rows: int = ADMIT_MAX_ROWS,
    ):
        self.scorer = scorer
        # on the fused path the drift window folds inside the flush; on the
        # split path each scored batch goes to watchtower.observe()
        self.watchtower = watchtower
        self.fused = fused if fused is not None else config.scorer_fused_flush()
        self.return_wire = (
            return_wire if return_wire is not None else config.scorer_return_wire()
        )
        if self.return_wire not in scorer_mod.RETURN_WIRES:
            raise ValueError(
                f"return wire must be one of {sorted(scorer_mod.RETURN_WIRES)},"
                f" got {self.return_wire!r}"
            )
        self._out_dtype = scorer_mod.RETURN_WIRES[self.return_wire]
        if explain is None:
            mode = config.scorer_explain()
            if mode not in ("off", "topk"):
                raise ValueError(f"SCORER_EXPLAIN must be off|topk, got {mode!r}")
            explain = mode == "topk"
        self.explain = explain
        self.explain_k = (
            explain_k if explain_k is not None else config.scorer_explain_k()
        )
        if self.explain and self.explain_k < 1:
            raise ValueError(f"SCORER_EXPLAIN_K must be >= 1, got {self.explain_k}")
        # starts at 1 (nothing demoted), so explain-off deployments never
        # read as a demotion
        self._explain_fused: bool | None = None
        metrics.scorer_explain_fused.set(1)
        self._family: str | None = None
        self.max_batch = max_batch or config.scorer_max_batch()
        self.max_wait = (
            max_wait_ms if max_wait_ms is not None else config.scorer_max_wait_ms()
        ) / 1000.0
        self.admit_max = admit_max_rows
        self._queued_rows = 0
        self._c_flush = {
            path: metrics.scorer_flushes.labels(path, "0")
            for path in ("fused", "split", "solo")
        }
        self._g_queue_depth = metrics.scorer_queue_depth.labels("0")
        self._g_device_calls = metrics.scorer_device_calls_per_flush.labels("0")
        self._g_admission_rows = metrics.scorer_admission_queue_rows.labels("0")
        self._queue: asyncio.Queue[tuple] = asyncio.Queue()
        self._collector: asyncio.Task | None = None
        self._starting = False
        self._inflight = asyncio.Semaphore(MAX_INFLIGHT)
        self._flushes: set[asyncio.Task] = set()

    async def start(self) -> None:
        """Warm the bucket ladder (off the event loop), then start the
        collector. Warming runs the flush the serving path will run — fused
        with the serving return wire and explain leg, or the plain score —
        once per bucket, so the kernel is built and the allocator's blocks
        are cached before the first request."""
        if self._starting or not (
            self._collector is None or self._collector.done()
        ):
            return
        self._starting = True
        try:
            def _warm() -> None:
                scorer = self.scorer
                top = _bucket(self.max_batch, scorer.min_bucket)
                scorer.warmup(top)
                target = self._fused_target(scorer)
                if target is None:
                    if self.explain:
                        self._note_explain_fused(False, scorer)
                    return
                drift, spec = target
                k = self._explain_k_for(scorer)
                b = scorer.min_bucket
                while b <= top:
                    drift.warm_fused(
                        scorer, b, out_dtype=self._out_dtype, explain_k=k
                    )
                    b *= 2

            await asyncio.get_running_loop().run_in_executor(None, _warm)
            self._collector = asyncio.create_task(self._run())
        finally:
            self._starting = False

    async def stop(self) -> None:
        if self._collector is not None:
            self._collector.cancel()
            try:
                await self._collector
            except asyncio.CancelledError:
                pass
            self._collector = None
        # let in-flight flushes finish resolving their waiters
        if self._flushes:
            await asyncio.gather(*self._flushes, return_exceptions=True)
        # fail anything still enqueued so no request awaits forever
        while not self._queue.empty():
            fut = self._queue.get_nowait()[1]
            if not fut.done():
                fut.set_exception(RuntimeError("scorer shutting down"))
        self._queued_rows = 0

    def _admit(self, n: int) -> None:
        """Bounded-admission gate (event loop only, so no lock)."""
        if self.admit_max and self._queued_rows + n > self.admit_max:
            raise AdmissionFull(ADMIT_RETRY_AFTER_S, self._queued_rows)
        self._queued_rows += n

    async def _submit(self, row: np.ndarray):
        self._admit(1)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((row, fut))
        return await fut

    async def score(self, row: np.ndarray) -> float:
        """Submit one feature row; returns P(fraud)."""
        res = await self._submit(row)
        return res[0] if isinstance(res, tuple) else res

    async def score_ex(self, row: np.ndarray):
        """Submit one feature row; returns ``(P(fraud), reasons)`` where
        ``reasons`` is ``(indices, values)`` — the top-k reason codes from
        the same flush as the score — or None when the flush carried no
        explain leg."""
        res = await self._submit(row)
        if isinstance(res, tuple):
            return res[0], (res[1], res[2])
        return res, None

    async def _run(self) -> None:
        batch: list[tuple] = []
        loop = asyncio.get_running_loop()
        try:
            while True:
                item = await self._queue.get()
                self._queued_rows -= 1
                batch = [item]
                self._g_queue_depth.set(self._queue.qsize())
                self._g_admission_rows.set(self._queued_rows)
                # greedy drain first (get_nowait ~1 µs), then wait out the
                # collection window for more rows
                deadline = loop.time() + self.max_wait
                while len(batch) < self.max_batch:
                    try:
                        nxt = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        timeout = deadline - loop.time()
                        if timeout <= 0:
                            break
                        try:
                            nxt = await asyncio.wait_for(self._queue.get(), timeout)
                        except asyncio.TimeoutError:
                            break
                    self._queued_rows -= 1
                    batch.append(nxt)
                # bounded pipeline: the semaphore caps in-flight flushes and
                # applies backpressure when the device can't keep up
                await self._inflight.acquire()
                task = asyncio.create_task(self._flush_one(batch))
                self._flushes.add(task)
                task.add_done_callback(self._flushes.discard)
                batch = []
        except asyncio.CancelledError:
            for item in batch:
                if not item[1].done():
                    item[1].set_exception(RuntimeError("scorer shutting down"))
            raise

    async def _flush_one(self, batch: list[tuple]) -> None:
        try:
            await self._flush(batch)
        finally:
            self._inflight.release()

    def _note_explain_fused(self, fused: bool, scorer) -> None:
        """Export + (on transition) log whether reason codes ride the
        fused flush."""
        if fused == self._explain_fused:
            return
        self._explain_fused = fused
        metrics.scorer_explain_fused.set(1 if fused else 0)
        if fused:
            log.info("serve-time reason codes ride the fused flush (k=%d)", self.explain_k)
        else:
            log.warning(
                "SCORER_EXPLAIN=topk but flushes run %s: responses ship "
                "WITHOUT reason codes; scorer_explain_fused=0 exported",
                "split (SCORER_FUSED_FLUSH=0)" if self.watchtower is not None
                else "without a watchtower (no monitor_profile.npz)",
            )

    def _note_family(self, scorer) -> None:
        """Latch the served family onto ``scorer_served_family``."""
        fam = scorer.family
        if fam == self._family:
            return
        prev, self._family = self._family, fam
        metrics.scorer_served_family.labels(fam).set(1)
        if prev is not None:
            metrics.scorer_served_family.labels(prev).set(0)

    def _explain_k_for(self, scorer) -> int:
        """The fused explain leg's k: 0 when explanation is off, else
        SCORER_EXPLAIN_K clamped to the feature count."""
        if not self.explain:
            return 0
        self._note_explain_fused(True, scorer)
        return min(self.explain_k, scorer.n_features)

    def _fused_target(self, scorer):
        """(drift_monitor, fused_spec) when this flush runs fused (a
        watchtower is attached and SCORER_FUSED_FLUSH is on), else None."""
        if not self.fused or self.watchtower is None:
            return None
        return self.watchtower.drift, scorer.fused_spec()

    def _flush_device(self, scorer, target, batch: list[tuple]):
        """The flush's device work, in an executor thread. Stages the rows
        into a pooled slot, runs the fused or split flush, and fetches the
        outputs with one host sync. Returns ``(probs, explain_out,
        device_calls, monitor_rows, monitor_scores, slot)``: ``probs`` and
        ``explain_out`` are views into the slot's decode buffers, so the
        caller releases the slot after resolving the waiters."""
        n = len(batch)
        self._note_family(scorer)
        staging = scorer.staging
        slot = staging.acquire(_bucket(n, scorer.min_bucket))
        explain_out = None
        try:
            hx = scorer.stage_rows(slot, [item[0] for item in batch])
            x_dev = scorer.to_device(hx)
            explain_k = 0
            if target is not None:
                drift, spec = target
                explain_k = self._explain_k_for(scorer)
                out = drift.fused_flush(
                    x_dev, scorer.to_device(slot.valid), n,
                    spec.score_args, spec.score_fn,
                    out_dtype=self._out_dtype,
                    explain_args=spec.explain_args if explain_k else None,
                    explain_k=explain_k,
                )
                device_calls = 1
                need_rows = False  # the window folded inside the flush
            else:
                if self.explain:
                    self._note_explain_fused(False, scorer)
                out = scorer._score_padded(x_dev)
                device_calls = 2 if self.watchtower is not None else 1
                need_rows = self.watchtower is not None
            host = fetch(*(out if isinstance(out, tuple) else (out,)))
            raw = host[0]
            # decode into the slot's scores buffer: the waiters read from it
            probs = decode_scores_into(raw, slot.scores)[:n]
            if explain_k:
                ei, ev = decode_explain_into(host[1], host[2], slot)
                explain_out = (ei[:n], ev[:n])
            monitor_rows = slot.f32[:n].copy() if need_rows else None
            monitor_scores = probs.copy() if need_rows else None
        except BaseException:
            staging.release(slot)
            raise
        return probs, explain_out, device_calls, monitor_rows, monitor_scores, slot

    async def _flush(self, batch: list[tuple]) -> None:
        n_rows = len(batch)
        scorer = self.scorer
        fused = False
        try:
            # everything that can fail stays inside this try: a raise before
            # the waiters resolve would leave clients awaiting forever
            metrics.microbatch_size.observe(n_rows)
            target = self._fused_target(scorer)
            fused = target is not None
            loop = asyncio.get_running_loop()
            (
                probs, explain_out, device_calls, monitor_rows,
                monitor_scores, slot,
            ) = await loop.run_in_executor(
                None, self._flush_device, scorer, target, batch
            )
            if explain_out is not None:
                metrics.scorer_explained_rows.inc(n_rows)
            self._g_device_calls.set(device_calls)
            self._c_flush[
                "fused" if fused
                else ("split" if self.watchtower is not None else "solo")
            ].inc()
        except Exception as e:  # resolve all waiters with the failure
            for item in batch:
                if not item[1].done():
                    item[1].set_exception(e)
            return
        try:
            for i, item in enumerate(batch):
                if explain_out is not None:
                    res = (
                        float(probs[i]),
                        explain_out[0][i].tolist(),
                        explain_out[1][i].tolist(),
                    )
                else:
                    res = float(probs[i])
                if not item[1].done():
                    item[1].set_result(res)
        finally:
            # the waiters' results are materialized above: recycle the slot
            scorer.staging.release(slot)
        if self.watchtower is not None:
            # waiters are resolved; a slow monitor never adds latency. Fused:
            # the window already folded in the flush, observe() only counts.
            # Split: observe() enqueues the drift update.
            try:
                self.watchtower.observe(monitor_rows, monitor_scores, drift_done=fused)
            except Exception:
                log.debug("watchtower observe failed", exc_info=True)
