"""Async micro-batching in front of the scorer.

Concurrent requests land in an asyncio queue; a collector drains up to
``max_batch`` rows or waits at most ``max_wait_ms``, then hands the batch
to a flush task, which runs the device work in an executor thread (so the
event loop keeps accepting requests) and resolves each request's future.
With ``SCORER_ADAPTIVE_WAIT`` the wait scales with an arrival-rate EWMA
(:meth:`MicroBatcher._effective_wait`): a lone request flushes at once.
Serving builds the batcher over the lifecycle's ``ModelSlot``: each flush
reads the slot once, so a hot swap lands between two flushes.

A queue item is either a single row (one ``/predict`` request) or an
ingest block (:class:`IngestBlock`): a frame's rows, parsed straight into
a pooled staging slot by the binary lane or ``/ingest/batch``, admitted as
ONE item with ONE future. The collector counts ROWS, not items: a block
fills the forming batch like that many requests, weighs that much in the
arrival EWMA, and a block that would overflow ``max_batch`` is carried to
the next batch (``max_batch`` stays a hard bound on the bucket).
Completion fans out by each item's row offset in the flush; a block's
scores and reason codes are copied back into the slot its frame was parsed
into.

A flush stages the items into a preallocated per-bucket staging slot
(``ops/scorer.StagingPool``; page-locked on a card, so the h2d copy runs
asynchronously) and encodes them on the scorer's h2d wire (f32, bf16 or
int8 codes), then either:

- **fused** (a watchtower is attached and ``SCORER_FUSED_FLUSH`` is on):
  scores, optional top-k reason codes and the drift-window fold in one
  flush (``monitor/drift.DriftMonitor.fused_flush``) — on the card the
  linear family scores through the ``fused_score`` CUDA kernel and the GBT
  family's reason codes come from the ``tree_shap`` CUDA kernel; on the
  int8 wire the flush dequantizes the codes for the histograms; or
- **split**: the score alone; the watchtower's ingest thread folds the
  window afterwards.

For a ledger-widened model (the watchtower's drift monitor holds the
entity table) the fused flush is the ledger flush: :meth:`MicroBatcher.
_stage_ledger` stages each item's entity columns — a ``/predict`` row's
``(slot, fingerprint, rel_ts)`` triple from the edge, an ingest block's
column triple — beside the rows, and entity-less rows take the null slot,
counted in ``ledger_null_entity_rows``. For the wide family the fused
flush is the wide flush: :meth:`MicroBatcher._stage_wide` stages each
item's entity fingerprint (0 for an entity-less row, which scores
base-only), and the flush hashes the crosses on the device. A wide model
served without the fused flush drops its crosses; ``scorer_wide_fused``
latches 0 then, loudly. A ledger model's flush that runs split (no fused
target, or a cross-width hot swap caught between its slot write and the
watchtower's rebind) scores every row through the null slot: its rows are
counted in ``ledger_null_entity_rows``, with one WARNING a served model.
The flush carries two fault points (``range/faults``): ``microbatch.flush``
at its top, and ``ledger.update`` once a ledger flush's entity columns are
staged, before they reach the device; while a plan is armed the ledger
flush re-encodes its staged rows after that point, so a mutation there
rides the wire.

Under the serving mesh (``MESH_FLUSH_DEVICES``) the watchtower's monitor is
a ``mesh/shardflush.MeshDriftMonitor``: the same flushes over per-shard
windows, and for the ledger flush each row staged in the segment of the
shard that owns its entity's slot (``ledger/placement``; a skewed batch
may bump its bucket, and the warm ladder extends to cover it). Under
``MESH_SHARDS`` several batchers sit behind the shard front
(``mesh/front``), each with its ``shard_id``: the ``shard`` label of its
scorer series and flight-recorder records.

With a lifeboat (``lifeboat/``, ``LIFEBOAT_DIR``) the ledger flush is
write-ahead: the flush's entity triples are journaled and the flush's
launches enqueued under the boat's ``flush_lock``, one atom, so a
snapshot cut never sees a flush whose record is not in the journal. A
split flush journals nothing: its rows never reach the table.

The flush's host sync is the device-to-host copy of its outputs. With
spyglass on (``SPYGLASS_ENABLED``, the default) every item may carry a
``RequestTimeline``: the flush stamps its six stages, ``device_compute``
ending at ONE CUDA event a flush, recorded after the flush's last launch
and synchronised (:func:`_fence`), then exports each stage to
``request_stage_duration_seconds`` and the flush to the flight recorder.
With spyglass off the flush records no event and stamps nothing. Right
after the fence the roofline (``telemetry/roofline``) pairs the fenced
``device_compute`` time with the flush the compile sentinel noted on the
same executor thread (``device_utilization_fraction``). The flush's device
part runs inside ``annotate("microbatch-score")``, a named range in a
device trace (``POST /admin/profile``). Up to
``SCORER_MAX_INFLIGHT`` flushes run at once, so the fetch of flush N
overlaps the staging of flush N+1. Admission is bounded
(``SCORER_ADMIT_MAX_ROWS``): at the bound :class:`AdmissionFull` is raised
and the edges shed — HTTP 429 + ``Retry-After``
(``SCORER_ADMIT_RETRY_AFTER_S``), a binary busy frame.
"""

from __future__ import annotations

import asyncio
import logging
import time

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
from fraud_detection_tpu_torch.range.faults import active_plan, fire
from fraud_detection_tpu_torch.service import metrics, tracing
from fraud_detection_tpu_torch.telemetry import roofline
from fraud_detection_tpu_torch.telemetry.compile_sentinel import expected_compiles
from fraud_detection_tpu_torch.telemetry.timeline import STAGES, FlushInfo
from fraud_detection_tpu_torch.utils.profiling import annotate

log = logging.getLogger("fraud_detection_tpu_torch.microbatch")

#: EWMA smoothing of the adaptive deadline's arrival rate (rows/s)
_RATE_ALPHA = 0.3

# bound stage observers, resolved once (a labels() lookup a flush adds up)
_OBSERVE_STAGE = {
    s: metrics.request_stage_duration.labels(s).observe for s in STAGES
}
#: admission check + queue put, stamped at submission
_OBSERVE_ADMIT = metrics.request_stage_duration.labels("admit").observe


class AdmissionFull(RuntimeError):
    """The bounded admission queue is at capacity: the caller sheds this
    request with a retry hint (HTTP 429 + ``Retry-After``, binary busy
    frame)."""

    def __init__(self, retry_after_s: float, queued_rows: int):
        self.retry_after_s = retry_after_s
        self.queued_rows = queued_rows
        super().__init__(
            f"admission queue full ({queued_rows} rows queued) — retry in "
            f"{retry_after_s:g}s"
        )


class IngestBlock:
    """One admitted ingest frame: ``slot.f32[:n]`` holds the staged rows
    (parsed straight off the wire into the pooled buffer); results decode
    back into the same slot's ``scores``/``ei``/``ev`` buffers. ``entity``
    is the ledger's ``(slots, fingerprints, timestamps)`` column triple
    (fingerprint 0: an entity-less row), or None: every row entity-less."""

    __slots__ = ("slot", "n", "entity")

    def __init__(self, slot, n: int, entity=None):
        self.slot = slot
        self.n = n
        self.entity = entity


def _item_rows(item) -> int:
    """Rows one queue item contributes: blocks carry a 2-D view."""
    rows = item[0]
    return rows.shape[0] if rows.ndim == 2 else 1


def _batch_rows(batch) -> int:
    return sum(map(_item_rows, batch))


def fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """The flush's host sync: device-to-host copies of its outputs,
    enqueued together, then one wait on the stream."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    dev = tensors[0].device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


def _fence(device: torch.device) -> None:
    """The flush's one telemetry fence: a CUDA event recorded after the
    flush's last launch, then waited on — the end of ``device_compute``.
    Nothing to wait for on the CPU, whose launches run synchronously."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


def _placement(batch: list[tuple], n_shards: int, min_bucket: int):
    """``ledger/placement.shard_placement`` of a batch's rows, row-major over
    the items (a block expanded; fingerprint 0 in a block's columns, or no
    entity at all: an entity-less row). Returns ``(bucket, positions)``."""
    from fraud_detection_tpu_torch.ledger.placement import shard_placement

    slots: list = []
    has: list = []
    for item in batch:
        rows, ent = item[0], item[3]
        if rows.ndim == 2:
            k = rows.shape[0]
            if ent is None:
                slots.extend([0] * k)
                has.extend([False] * k)
            else:
                slots.extend(np.asarray(ent[0]).tolist())
                has.extend((np.asarray(ent[1]) != 0).tolist())
        elif ent is None:
            slots.append(0)
            has.append(False)
        else:
            slots.append(ent[0])
            has.append(True)
    return shard_placement(
        np.asarray(slots, np.int64), np.asarray(has, bool), n_shards, min_bucket
    )


class MicroBatcher:
    def __init__(
        self,
        scorer: BatchScorer | None = None,
        max_batch: int | None = None,
        max_wait_ms: float | None = None,
        max_inflight: int | None = None,
        watchtower=None,
        recorder=None,
        telemetry: bool | None = None,
        fused: bool | None = None,
        return_wire: str | None = None,
        explain: bool | None = None,
        explain_k: int | None = None,
        admit_max_rows: int | None = None,
        slot=None,
        lifeboat=None,
        shard_id: int = 0,
    ):
        # either a fixed scorer (offline tools, tests) or the lifecycle's
        # ModelSlot (serving): with a slot every flush reads the slot once,
        # so a hot swap lands between batches — a batch in flight finishes
        # on the old model, the next scores on the new
        if scorer is None and slot is None:
            raise ValueError("MicroBatcher needs a scorer or a model slot")
        self.slot = slot
        self._scorer = scorer
        # the lifeboat (lifeboat/boat.Lifeboat): with a ledger model served
        # fused, each flush's entity triples are journaled under its flush
        # lock right before the flush's launches
        self.lifeboat = lifeboat
        # the scorer whose split ledger flushes were last warned about (one
        # WARNING a served model, not one a flush)
        self._split_ledger_scorer = None
        # on the fused path the drift window folds inside the flush; on the
        # split path each scored batch goes to watchtower.observe()
        self.watchtower = watchtower
        # the flight recorder (telemetry.FlightRecorder) completed request
        # timelines land in; /debug/flightrecorder reads it
        self.recorder = recorder
        self.telemetry = (
            telemetry if telemetry is not None else config.spyglass_enabled()
        )
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
        # scorer_wire_fused (JAX's WireFormatUnfused alert input) is a
        # constant 1 here: every wire of both families (f32, bf16, int8) has
        # a fused flush, so none demotes to the split path
        metrics.scorer_wire_fused.set(1)
        if self.fused and self.watchtower is not None:
            log.info("wire format %s runs the fused single-dispatch flush",
                     self.scorer.io_dtype)
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
        # the wide family's fusion latch, keyed on (fused, model version);
        # ("off",) while the served family is not wide
        self._wide_state: tuple | None = None
        metrics.scorer_wide_fused.set(1)
        self.adaptive_wait = config.scorer_adaptive_wait()
        self.max_batch = max_batch or config.scorer_max_batch()
        self.max_wait = (
            max_wait_ms if max_wait_ms is not None else config.scorer_max_wait_ms()
        ) / 1000.0
        self.admit_max = (
            admit_max_rows if admit_max_rows is not None
            else config.scorer_admit_max_rows()
        )
        self.admit_retry_after = config.scorer_admit_retry_after_s()
        self._queued_rows = 0
        self._carry: tuple | None = None  # a block deferred to the next batch
        self._rate = 0.0  # arrival rows/s EWMA, the adaptive deadline's input
        self._last_cycle: float | None = None
        # the serving mesh's shard this batcher is ("0" without a front):
        # the shard label of its scorer series and flight-recorder records
        self.shard_id = int(shard_id)
        self.rebind_shard_gauges()
        self._c_flush = self._bind_flush_counters()
        self._queue: asyncio.Queue[tuple] = asyncio.Queue()
        self._collector: asyncio.Task | None = None
        self._starting = False
        self._inflight = asyncio.Semaphore(
            max_inflight if max_inflight is not None else config.scorer_max_inflight()
        )
        self._flushes: set[asyncio.Task] = set()

    def _bind_flush_counters(self) -> dict:
        return {
            path: metrics.scorer_flushes.labels(path, str(self.shard_id))
            for path in ("fused", "split", "solo")
        }

    def set_shard_id(self, shard_id: int) -> None:
        """Take a shard identity (the shard front assigns them by index), so
        each shard writes its own per-shard series."""
        if int(shard_id) == self.shard_id:
            return
        self.shard_id = int(shard_id)
        self.rebind_shard_gauges()
        self._c_flush = self._bind_flush_counters()

    def rebind_shard_gauges(self) -> None:
        """(Re)bind this shard's per-shard gauge series: at construction and
        again on a revive, since a death or drain drops them from the
        registry (``metrics.drop_shard_gauges``)."""
        label = str(self.shard_id)
        self._g_queue_depth = metrics.scorer_queue_depth.labels(label)
        self._g_effective_wait = metrics.scorer_effective_wait.labels(label)
        self._g_device_calls = metrics.scorer_device_calls_per_flush.labels(label)
        self._g_admission_rows = metrics.scorer_admission_queue_rows.labels(label)

    @property
    def scorer(self) -> BatchScorer:
        """The scorer the next flush uses: the slot's model's, or the fixed
        one."""
        return self.slot.model.scorer if self.slot is not None else self._scorer

    def _served(self) -> tuple:
        """ONE read of what a flush serves: ``(scorer, source, version)``,
        pinned for the whole batch even if a promotion swaps the slot while
        it is in flight."""
        if self.slot is None:
            return self._scorer, None, None
        model, source, version = self.slot.get()
        return model.scorer, source, version

    async def start(self, warm: bool = True) -> None:
        """Warm the bucket ladder (off the event loop), then start the
        collector. Warming runs the flush the serving path will run — fused
        with the serving return wire and explain leg, or the plain score —
        once per bucket, so the kernel is built and the allocator's blocks
        are cached before the first request. It runs under the compile
        sentinel's expected mark (a deploy's warm-up must not read as a
        recompile storm), and with ``ROOFLINE_ENABLED`` it resolves the
        roofline's peaks first (the probes run here, never on a request).
        ``warm=False`` skips the ladder: the shard front passes it for
        shards 1..N-1, which share shard 0's scorer and monitor. A mesh
        ledger's ladder extends by the shard factor, the most a skewed
        batch's placement can bump its bucket (``ledger/placement``)."""
        if self._starting or not (
            self._collector is None or self._collector.done()
        ):
            return
        self._starting = True
        try:
            def _warm() -> None:
                with expected_compiles():
                    scorer = self.scorer
                    if config.roofline_enabled():
                        dev = getattr(scorer, "device", None)
                        roofline.ensure_peak(dev)
                        roofline.ensure_membw(dev)
                    top = _bucket(self.max_batch, scorer.min_bucket)
                    scorer.warmup(top)
                    target = self._fused_target(scorer)
                    if target is None:
                        if self.explain:
                            self._note_explain_fused(False, scorer)
                        return
                    drift, spec = target
                    k = self._explain_k_for(scorer)
                    if spec.ledger is not None and getattr(drift, "n_shards", 1) > 1:
                        top *= drift.n_shards
                    b = scorer.min_bucket
                    while b <= top:
                        drift.warm_fused(
                            scorer, b, out_dtype=self._out_dtype, explain_k=k
                        )
                        b *= 2

            if warm:
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
        if self._carry is not None:
            item, self._carry = self._carry, None
            if not item[1].done():
                item[1].set_exception(RuntimeError("scorer shutting down"))
        while not self._queue.empty():
            fut = self._queue.get_nowait()[1]
            if not fut.done():
                fut.set_exception(RuntimeError("scorer shutting down"))
        self._queued_rows = 0

    def _admit(self, n: int) -> None:
        """Bounded-admission gate (event loop only, so no lock)."""
        if self.admit_max and self._queued_rows + n > self.admit_max:
            raise AdmissionFull(self.admit_retry_after, self._queued_rows)
        self._queued_rows += n

    async def _submit(self, row: np.ndarray, timeline=None, entity=None):
        t0 = time.perf_counter() if timeline is not None else 0.0
        self._admit(1)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((row, fut, timeline, entity))
        if timeline is not None:
            _OBSERVE_ADMIT(time.perf_counter() - t0)
        return await fut

    async def score_block(self, block: IngestBlock, timeline=None) -> int:
        """Admit one pre-staged ingest block: the frame's rows ride ONE
        queue item with ONE future. On return the block slot's buffers hold
        the results — ``slot.scores[:n]`` the f32 probabilities and, when
        the explain leg rode the flush, ``slot.ei/ev[:n]`` the top-k reason
        codes. Returns the explain ``k`` (0: no reason codes)."""
        n = block.n
        if n < 1:
            raise ValueError("empty ingest block")
        if n > self.max_batch:
            raise ValueError(
                f"ingest block of {n} rows exceeds max_batch="
                f"{self.max_batch} — split the frame (INGEST_MAX_ROWS)"
            )
        t0 = time.perf_counter() if timeline is not None else 0.0
        self._admit(n)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put(
            (block.slot.f32[:n], fut, timeline, block.entity, block.slot)
        )
        if timeline is not None:
            _OBSERVE_ADMIT(time.perf_counter() - t0)
        return await fut

    async def score(self, row: np.ndarray, timeline=None, entity=None) -> float:
        """Submit one feature row; returns P(fraud). ``timeline`` (a
        ``RequestTimeline``) is stamped at every stage boundary. ``entity``
        is the ledger's ``(slot, fingerprint, rel_ts)`` triple from the
        edge (the wide family's ``(0, fingerprint, 0.0)``), or None: the
        row scores through the null slot (counted in
        ``ledger_null_entity_rows`` when the flush is the ledger's) or, for
        the wide family, base-only."""
        res = await self._submit(row, timeline, entity)
        return res[0] if isinstance(res, tuple) else res

    async def score_ex(self, row: np.ndarray, timeline=None, entity=None):
        """Submit one feature row; returns ``(P(fraud), reasons)`` where
        ``reasons`` is ``(indices, values)`` — the top-k reason codes from
        the same flush as the score — or None when the flush carried no
        explain leg. ``entity`` as in :meth:`score`."""
        res = await self._submit(row, timeline, entity)
        if isinstance(res, tuple):
            return res[0], (res[1], res[2])
        return res, None

    @staticmethod
    def _stamp_collected(item: tuple) -> tuple:
        tl = item[2]
        if tl is not None:
            tl.t_collected = time.perf_counter()
        return item

    def _effective_wait(self) -> float:
        """This cycle's collection deadline: ``max_wait``, or with the
        adaptive wait ``max_wait`` scaled by the share of ``max_batch`` the
        arrival EWMA expects within the window — 0 when it expects at most
        one row, the whole window when traffic would fill the batch."""
        if not self.adaptive_wait:
            w = self.max_wait
        else:
            expected_rows = self._rate * self.max_wait
            if expected_rows <= 1.0:
                w = 0.0
            else:
                w = self.max_wait * min(1.0, expected_rows / self.max_batch)
        self._g_effective_wait.set(w)
        return w

    async def _run(self) -> None:
        batch: list[tuple] = []
        loop = asyncio.get_running_loop()
        stamp = self._stamp_collected
        try:
            while True:
                if self._carry is not None:
                    # a block carried over from the last batch opens this one
                    item, self._carry = self._carry, None
                else:
                    item = await self._queue.get()
                n_rows = _item_rows(item)
                self._queued_rows -= n_rows
                batch = [stamp(item)]
                self._g_queue_depth.set(self._queue.qsize())
                self._g_admission_rows.set(self._queued_rows)
                # collect ROWS (a block weighs its rows): greedy drain first
                # (get_nowait ~1 µs), then wait out the collection window
                deadline = loop.time() + self._effective_wait()
                while n_rows < self.max_batch:
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
                    k = _item_rows(nxt)
                    if n_rows + k > self.max_batch:
                        # a block that would overflow the bucket ladder
                        # closes this batch and opens the next
                        self._carry = nxt
                        break
                    self._queued_rows -= k
                    batch.append(stamp(nxt))
                    n_rows += k
                # bounded pipeline: the semaphore caps in-flight flushes and
                # applies backpressure when the device can't keep up
                await self._inflight.acquire()
                task = asyncio.create_task(self._flush_one(batch))
                self._flushes.add(task)
                task.add_done_callback(self._flushes.discard)
                batch = []
                # arrival EWMA over collection cycles, stamped after the
                # semaphore: time blocked on in-flight flushes is the
                # device's, not the arrivals'
                now = loop.time()
                if self._last_cycle is not None:
                    dt = now - self._last_cycle
                    if dt > 0:
                        self._rate += _RATE_ALPHA * (n_rows / dt - self._rate)
                self._last_cycle = now
        except asyncio.CancelledError:
            if self._carry is not None:
                batch.append(self._carry)
                self._carry = None
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

    def _note_wide_fused(self, fused: bool, scorer, version) -> None:
        """Export (and, on a change, log) whether the served wide family's
        crosses ride the fused flush. Off it, every row scores base-only
        through the null fold: ``scorer_wide_fused`` latches 0 and a
        warning says so. On it, the model shards (the serving mesh's model
        axis: 1 for the single-device gather) and the table's occupancy a
        model shard are exported."""
        state = (fused, version)
        if state == self._wide_state:
            return
        self._wide_state = state
        metrics.scorer_wide_fused.set(1 if fused else 0)
        if not fused:
            log.warning(
                "WIDE family served WITHOUT the fused flush: hashed-cross "
                "contributions are dropped and every row scores base-only "
                "through the null fold. scorer_wide_fused=0 exported"
            )
            return
        drift = getattr(self.watchtower, "drift", None)
        n_model = int(getattr(drift, "n_model", 1) or 1)
        metrics.wide_model_shards.set(n_model)
        for s, frac in enumerate(scorer.table_occupancy(n_model)):
            metrics.wide_bucket_occupancy.labels(str(s)).set(frac)
        log.info("wide family rides the fused flush (%d model shard(s))", n_model)

    def _note_wide_off(self) -> None:
        """The served family is not wide: ``scorer_wide_fused`` reads 1, no
        model shards, no occupancy series."""
        if self._wide_state == ("off",):
            return
        self._wide_state = ("off",)
        metrics.scorer_wide_fused.set(1)
        metrics.wide_model_shards.set(0)
        metrics.wide_bucket_occupancy.clear()

    def _explain_k_for(self, scorer) -> int:
        """The fused explain leg's k: 0 when explanation is off, else
        SCORER_EXPLAIN_K clamped to the feature count."""
        if not self.explain:
            return 0
        self._note_explain_fused(True, scorer)
        return min(self.explain_k, scorer.n_features)

    def _fused_target(self, scorer):
        """(drift_monitor, fused_spec) when this flush runs fused (a
        watchtower is attached and SCORER_FUSED_FLUSH is on), else None.
        Also None while a cross-width hot swap is between its slot write and
        the watchtower's rebind (the monitor's width is not the scorer's, or
        a ledger champion's table is not bound yet): that flush scores
        split, through the scorer's base-width path, rather than failing
        its requests."""
        if not self.fused or self.watchtower is None:
            return None
        drift = self.watchtower.drift
        if drift.profile.n_features != scorer.n_features:
            return None
        spec = scorer.fused_spec()
        if spec.ledger is not None and drift.ledger is None:
            return None  # a ledger champion before its table is bound
        return drift, spec

    def _flush_device(self, scorer, target, batch: list[tuple],
                      telemetry: bool = False):
        """The flush's device work, in an executor thread. Stages the
        items into a pooled slot, runs the fused or split flush, and
        fetches the outputs with one host sync. Returns ``(probs,
        explain_out, device_calls, monitor_rows, monitor_scores,
        monitor_reasons, stamps, slot)``: ``probs`` and ``explain_out`` are
        views into the slot's decode buffers, so the caller releases the
        slot after resolving the waiters; ``stamps`` is ``(t_flush_start,
        t_padded, t_synced, t_fetched)`` with ``telemetry``, else None —
        the one fence of the flush is recorded only then."""
        # fraud-range injection point: a chaos plan adds device latency to,
        # or fails, this flush (disarmed: one global load)
        fire("microbatch.flush")
        n = _batch_rows(batch)
        self._note_family(scorer)
        staging = scorer.staging
        wide_on = target is not None and target[1].wide is not None
        ledger_on = (not wide_on and target is not None
                     and target[1].ledger is not None and target[0].ledger is not None)
        bucket, placement = _bucket(n, scorer.min_bucket), None
        if ledger_on and getattr(target[0], "n_shards", 1) > 1:
            # the sharded ledger flush: each row goes to the segment of the
            # shard that owns its entity's slot (a host-side permutation)
            bucket, placement = _placement(batch, target[0].n_shards, scorer.min_bucket)
        slot = staging.acquire(bucket)
        # the rows of the batch, in order, within the staged bucket
        rows_of = slice(None, n) if placement is None else placement
        explain_out = None
        try:
            with annotate("microbatch-score"):
                t_flush_start = time.perf_counter() if telemetry else 0.0
                if placement is None:
                    hx = scorer.stage_items(slot, batch)
                else:
                    hx = scorer.stage_items_placed(slot, batch, placement)
                ledger_rows = wide_rows = None
                n_null = 0
                if wide_on:
                    wide_rows = self._stage_wide(scorer, slot, batch)
                elif ledger_on:
                    ledger_rows, n_null = self._stage_ledger(scorer, slot, batch, placement)
                    if active_plan() is not None:
                        # a plan may have mutated the staged f32 rows at
                        # ledger.update: re-encode them so the poison rides
                        # the wire (disarmed, nothing is re-encoded)
                        hx = scorer._encode_slot(slot)
                t_padded = time.perf_counter() if telemetry else 0.0
                x_dev = scorer.to_device(hx)
                explain_k = 0
                if target is not None:
                    drift, spec = target
                    explain_k = self._explain_k_for(scorer)

                    def _launch():
                        return drift.fused_flush(
                            x_dev, scorer.to_device(slot.valid), n,
                            spec.score_args, spec.score_fn,
                            dequant_scale=spec.dequant_scale,
                            score_codes=spec.score_codes,
                            out_dtype=self._out_dtype,
                            explain_args=spec.explain_args if explain_k else None,
                            explain_k=explain_k,
                            ledger_rows=ledger_rows,
                            wide_args=spec.wide if wide_rows is not None else None,
                            wide_rows=wide_rows,
                        )

                    boat = self.lifeboat
                    if ledger_rows is not None and boat is not None:
                        # the write-ahead: the journal record and the flush's
                        # launches are one atom under the flush lock, so a
                        # snapshot cut never sees a flush whose triples are not
                        # in the journal
                        with boat.flush_lock:
                            boat.journal_staged(slot, hx, spec.dequant_scale, n)
                            out = _launch()
                    else:
                        out = _launch()
                    if n_null:
                        metrics.ledger_null_entity_rows.inc(n_null)
                    device_calls = 1
                    # the window folded inside the flush: rows only for a shadow
                    need_rows = self.watchtower.wants_rows()
                else:
                    if self.explain:
                        self._note_explain_fused(False, scorer)
                    if getattr(scorer, "ledger_spec", None) is not None:
                        self._note_split_ledger(scorer, n)
                    out = scorer._score_padded(x_dev)
                    device_calls = 2 if self.watchtower is not None else 1
                    need_rows = self.watchtower is not None
                outs = out if isinstance(out, tuple) else (out,)
                if telemetry:
                    _fence(outs[0].device)
                    t_synced = time.perf_counter()
                    # pair the fenced device_compute time with the flush the
                    # compile sentinel noted on this thread
                    roofline.note_device_time(t_synced - t_padded)
                host = fetch(*outs)
                # decode into the slot's scores buffer: the waiters read from it
                probs = decode_scores_into(host[0], slot.scores)[rows_of]
                if explain_k:
                    ei, ev = decode_explain_into(host[1], host[2], slot)
                    explain_out = (ei[rows_of], ev[rows_of])
                stamps = (
                    (t_flush_start, t_padded, t_synced, time.perf_counter())
                    if telemetry else None
                )
                monitor_rows = slot.f32[rows_of].copy() if need_rows else None
                monitor_scores = probs.copy() if need_rows else None
                # the champion's reason-code indices, for the shadow's divergence
                monitor_reasons = (
                    np.array(explain_out[0], np.int64)
                    if need_rows and explain_out is not None else None
                )
        except BaseException:
            staging.release(slot)
            raise
        return (probs, explain_out, device_calls, monitor_rows, monitor_scores,
                monitor_reasons, stamps, slot)

    def _note_split_ledger(self, scorer, n: int) -> None:
        """A ledger model's flush ran split: every row, entity-keyed or not,
        took the null slot and none reached the table. Count them in
        ``ledger_null_entity_rows``; WARN once a served model."""
        metrics.ledger_null_entity_rows.inc(n)
        if self._split_ledger_scorer is not scorer:
            self._split_ledger_scorer = scorer
            log.warning(
                "a ledger model's flush ran split (no fused ledger flush, or "
                "a hot swap between its slot write and the watchtower's "
                "rebind): its entity rows score through the null slot and "
                "never reach the table; counted in ledger_null_entity_rows"
            )

    @staticmethod
    def _stage_wide(scorer, slot, batch: list[tuple]):
        """Fill the slot's fingerprint and has-entity columns for the wide
        flush from the queue items' entity triples (a single row's
        ``(0, fingerprint, 0.0)``, a block's column triple; fingerprint 0
        or None: no entity, a zero cross block) and copy them to the
        device. Returns the ``(fp, has_entity)`` device pair."""
        slot.ensure_ledger()
        lf, lh = slot.lf, slot.lh
        lf[:] = 0
        lh[:] = 0.0
        pos: list[int] = []
        fvals: list[int] = []
        off = 0
        for item in batch:
            rows, ent = item[0], item[3]
            if rows.ndim == 2:
                k = rows.shape[0]
                if ent is not None:
                    sl = slice(off, off + k)
                    lf[sl] = ent[1]
                    lh[sl] = lf[sl] != 0
                off += k
                continue
            if ent is not None:
                pos.append(off)
                fvals.append(ent[1])
            off += 1
        if pos:
            lf[pos] = fvals
            lh[pos] = 1.0
        return scorer.to_device(lf), scorer.to_device(lh)

    @staticmethod
    def _stage_ledger(scorer, slot, batch: list[tuple], placement=None):
        """Fill the slot's ledger columns from the queue items' entity
        triples — a single row's ``(slot, fingerprint, rel_ts)``, a block's
        column triple (fingerprint 0 in it: an entity-less row) — and copy
        them to the device; with ``placement`` (the sharded ledger flush)
        row ``i``'s columns go to ``placement[i]``. An entity-less row
        (None) takes the null path: has_entity 0, counted. A triple whose
        time is not > 0 takes now on the table's origin-relative clock
        (``spec.rel_ts``): a raw epoch would anchor the slot ~1.7e9 s ahead
        and freeze its decay. Returns ``((slot_idx, fp, ts, has_entity) on
        the device, n_null)``."""
        slot.ensure_ledger()
        ls, lf, lt, lh = slot.ls, slot.lf, slot.lt, slot.lh
        for c in (ls, lf, lt, lh):
            c[:] = 0
        now = scorer.ledger_spec.rel_ts(time.time())
        n_null = 0
        # single rows collect into lists for one fancy-index assignment a
        # column; blocks copy their columns in bulk
        pos: list[int] = []
        vals: list[tuple] = []
        off = 0
        for item in batch:
            rows, ent = item[0], item[3]
            if rows.ndim == 2:
                k = rows.shape[0]
                if ent is None:
                    n_null += k
                else:
                    sl = slice(off, off + k) if placement is None else placement[off:off + k]
                    ls[sl], lf[sl], lt[sl] = ent
                    has = lf[sl] != 0
                    lh[sl] = has
                    n_null += k - int(has.sum())
                off += k
                continue
            if ent is None:
                n_null += 1
            else:
                s, fp, ts = ent
                pos.append(off if placement is None else placement[off])
                vals.append((s, fp, ts if ts and ts > 0 else now))
            off += 1
        if pos:
            s_v, f_v, t_v = zip(*vals)
            ls[pos], lf[pos], lt[pos], lh[pos] = s_v, f_v, t_v, 1.0
        # fraud-range injection point: the poison_entity_state campaign
        # corrupts one entity's staged rows here, before the columns reach
        # the device; the flush's poison clamp is the blast door under test
        fire("ledger.update", slot=slot, batch=batch, placement=placement)
        return tuple(scorer.to_device(c) for c in (ls, lf, lt, lh)), n_null

    async def _flush(self, batch: list[tuple]) -> None:
        n_rows = _batch_rows(batch)
        scorer, source, version = self._served()
        fused = False
        try:
            # everything that can fail stays inside this try: a raise before
            # the waiters resolve would leave clients awaiting forever
            metrics.microbatch_size.observe(n_rows)
            target = self._fused_target(scorer)
            fused = target is not None
            if getattr(scorer, "wide_spec", None) is None:
                self._note_wide_off()
            else:
                # off the fused flush a wide model drops its crosses
                self._note_wide_fused(fused, scorer, version)
            loop = asyncio.get_running_loop()
            (
                probs, explain_out, device_calls, monitor_rows,
                monitor_scores, monitor_reasons, stamps, slot,
            ) = await loop.run_in_executor(
                None, self._flush_device, scorer, target, batch, self.telemetry
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
        fi = None
        if stamps is not None:
            fi = FlushInfo(
                *stamps, batch_size=n_rows,
                bucket=_bucket(n_rows, scorer.min_bucket),
                model_version=version, model_source=source,
                drift=metrics.watchtower_drift_detected.get() != 0,
                shard=self.shard_id,
            )
        # fan out by row offset: a single row resolves with its float (or
        # (score, indices, values) with explain), a block by one bulk copy
        # into its ingest slot's buffers. Everything is materialized here,
        # before the flush slot recycles.
        eidx = evals = None
        explain_k = 0
        # link each row's timeline to the flush only when a tracer will read
        # it back (emit_stage_spans); the flight recorder gets the FlushInfo
        # through its entry instead
        link_timelines = fi is not None and tracing._tracer is not None
        if explain_out is not None:
            eidx, evals = explain_out
            explain_k = int(eidx.shape[1])
        try:
            off = 0
            for item in batch:
                f = item[1]
                rows = item[0]
                if rows.ndim == 2:
                    k = rows.shape[0]
                    out = item[4]  # the block's pooled ingest slot
                    np.copyto(out.scores[:k], probs[off:off + k], casting="unsafe")
                    if explain_k:
                        out.ensure_explain(explain_k)
                        np.copyto(out.ei[:k], eidx[off:off + k], casting="unsafe")
                        np.copyto(out.ev[:k], evals[off:off + k], casting="unsafe")
                    if not f.done():
                        f.set_result(explain_k)
                    off += k
                else:
                    if explain_k:
                        res = (
                            float(probs[off]),
                            eidx[off].tolist(),
                            evals[off].tolist(),
                        )
                    else:
                        res = float(probs[off])
                    if not f.done():
                        f.set_result(res)
                    off += 1
                if link_timelines and item[2] is not None:
                    item[2].flush = fi
        finally:
            scorer.staging.release(slot)
        if fi is not None:
            fi.t_resolved = time.perf_counter()
            self._export_flush(fi, batch)
        if self.watchtower is not None:
            # waiters are resolved; a slow monitor never adds latency. Fused:
            # the window already folded in the flush, observe() counts and
            # feeds the shadow. Split: observe() enqueues the drift update.
            try:
                self.watchtower.observe(monitor_rows, monitor_scores,
                                        drift_done=fused, reasons=monitor_reasons)
            except Exception:
                log.debug("watchtower observe failed", exc_info=True)

    #: at most this many (+1: the last row) per-row observations a flush for
    #: the row-level stages (enqueue, flush_wait), sampled evenly across the
    #: batch; timelines and flight-recorder records stay exact for every row
    ROW_STAGE_SAMPLES = 8

    def _export_flush(self, fi: FlushInfo, batch) -> None:
        """Per-flush stage export + flight-recorder append, after the
        waiters resolved."""
        obs = _OBSERVE_STAGE
        # flush-level stages: one observation a flush
        obs["pad_bucket"](max(0.0, fi.t_padded - fi.t_flush_start))
        obs["device_compute"](max(0.0, fi.t_synced - fi.t_padded))
        obs["d2h"](max(0.0, fi.t_fetched - fi.t_synced))
        obs["respond"](max(0.0, fi.t_resolved - fi.t_fetched))
        n = len(batch)
        step = -(-n // self.ROW_STAGE_SAMPLES)
        last = n - 1
        picks = list(range(0, n, step))
        if last % step:
            picks.append(last)
        for i in picks:
            tl = batch[i][2]
            if tl is not None:
                obs["enqueue"](max(0.0, tl.t_collected - tl.t_enqueued))
                obs["flush_wait"](max(0.0, fi.t_flush_start - tl.t_collected))
        if self.recorder is not None:
            try:
                # the batch goes in as it is; timelines are read at dump time
                self.recorder.record_flush_batch(fi, batch)
            except Exception:
                log.debug("flight recorder append failed", exc_info=True)
