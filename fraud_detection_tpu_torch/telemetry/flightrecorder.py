"""Always-on flight recorder: the last N scored requests, in memory.

The port's own copy of the JAX package's ``telemetry/flightrecorder.py``:
:class:`FlightRecorder`, one ring, and :class:`RecorderSet`, the serving
mesh's per-shard rings behind one merged view.

Post-incident forensics need the requests *around* the incident — by the
time an alert fires, the interesting traffic is gone from any sampled
tracing backend. The recorder keeps the last ``capacity`` per-request
records (timeline stages, batch size, bucket, model version, drift flag,
correlation id) that ``GET /debug/flightrecorder`` dumps on demand.

Lock-light by design, because the append sits on the micro-batch flush
loop: a whole flush lands as ONE deque entry — ``(FlushInfo, timelines)``,
both already built by the flush — so the hot-path cost is one lock, one
append, and an amortized eviction pop, *independent of batch size*. Row
dicts are materialized only at
dump time. ``dump`` snapshots under the same short lock; a dump racing a
flush is at worst one flush stale, which is fine for forensics.
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: dump-row schema (RequestTimeline.to_record for timeline entries).
FIELDS = (
    "ts",               # unix seconds at record time
    "correlation_id",
    "batch_size",       # rows in the flush this request rode
    "bucket",           # padded power-of-two bucket the flush compiled for
    "model_version",    # registry version serving the flush (None = local)
    "model_source",
    "drift",            # watchtower drift flag at flush time
    "shard",            # switchyard shard whose batcher ran the flush
    "stages",           # dict: the six timeline stage durations (seconds)
    "total_s",
)


class FlightRecorder:
    def __init__(self, capacity: int = 512):
        if capacity <= 0:
            raise ValueError("flight recorder capacity must be positive")
        self.capacity = capacity
        # entries: ("flush", FlushInfo, tuple[RequestTimeline]) or
        # ("row", FIELDS-tuple); _rows counts logical request records held
        self._entries: deque = deque()
        self._rows = 0
        self._n = 0  # total records ever written
        self._lock = threading.Lock()

    def record(self, rec: tuple) -> None:
        """Append one pre-built ``FIELDS`` tuple (offline tools/tests)."""
        with self._lock:
            self._entries.append(("row", rec))
            self._rows += 1
            self._n += 1
            self._evict()

    def record_flush(self, flush_info, timelines) -> None:
        """Append a whole flush in one shot — the flush's sequence of
        RequestTimelines lands as one entry."""
        if not timelines:
            return
        flush_info.recorded_at = time.time()
        k = len(timelines)
        with self._lock:
            self._entries.append(("flush", flush_info, timelines))
            self._rows += k
            self._n += k
            self._evict()

    def record_flush_batch(self, flush_info, batch) -> None:
        """THE hot-path entry point: append the micro-batcher's flush batch
        (``(row, future, timeline)`` triples) AS-IS — zero per-row work on
        the flush loop; timelines are extracted at dump time. The ring
        retains the batch triples (a few hundred KB at the default
        capacity) until evicted; rows/futures are never exposed in dumps.
        Rows without a timeline still count toward capacity (in serving,
        every scored request carries one)."""
        flush_info.recorded_at = time.time()
        k = len(batch)
        with self._lock:
            self._entries.append(("batch", flush_info, batch))
            self._rows += k
            self._n += k
            self._evict()

    def record_request(self, timeline, now: float | None = None) -> None:
        """Single-request convenience form of :meth:`record_flush`."""
        if timeline.flush is None:
            from fraud_detection_tpu_torch.telemetry.timeline import FlushInfo

            timeline.flush = FlushInfo()
        self.record_flush(timeline.flush, (timeline,))
        if now is not None:
            timeline.flush.recorded_at = now

    def _evict(self) -> None:
        # amortized: drop whole oldest entries while everything NEWER
        # already covers capacity (the newest entry alone may exceed it —
        # dump slices in that case)
        while len(self._entries) > 1:
            oldest = self._entries[0]
            size = 1 if oldest[0] == "row" else len(oldest[2])
            if self._rows - size < self.capacity:
                break
            self._entries.popleft()
            self._rows -= size

    @staticmethod
    def _entry_timelines(entry):
        """Newest-first timelines of a flush/batch entry."""
        if entry[0] == "batch":
            return [t[2] for t in reversed(entry[2]) if t[2] is not None]
        return list(reversed(entry[2]))

    def __len__(self) -> int:
        return min(self._rows, self.capacity)

    @property
    def total_recorded(self) -> int:
        return self._n

    def dump(self, limit: int | None = None) -> list[dict]:
        """Newest-first records as dicts (the /debug/flightrecorder body)."""
        with self._lock:
            snap = list(self._entries)
        count = self.capacity if limit is None else max(0, min(limit, self.capacity))
        out: list[dict] = []
        for entry in reversed(snap):
            if len(out) >= count:
                break
            if entry[0] == "row":
                out.append(dict(zip(FIELDS, entry[1])))
                continue
            fi = entry[1]
            for tl in self._entry_timelines(entry):
                if len(out) >= count:
                    break
                out.append(tl.to_record(fi))
        return out


class RecorderSet:
    """Per-shard flight-recorder rings behind one merged view.

    Under ``MESH_SHARDS > 1`` each shard's micro-batcher appends to its own
    ring, so the hot-path append never takes a lock another shard's flush
    contends on, and a dead shard's record survives however loud the
    survivors are. ``GET /debug/flightrecorder`` reads this wrapper: the
    rings' dumps merged newest first, every record carrying the ``shard``
    that ran its flush. It has the single ring's reading surface
    (``dump``, ``capacity``, ``total_recorded``)."""

    def __init__(self, recorders: list[FlightRecorder]):
        if not recorders:
            raise ValueError("RecorderSet needs at least one recorder")
        self.recorders = list(recorders)

    @property
    def capacity(self) -> int:
        return sum(r.capacity for r in self.recorders)

    @property
    def total_recorded(self) -> int:
        return sum(r.total_recorded for r in self.recorders)

    def __len__(self) -> int:
        return sum(len(r) for r in self.recorders)

    def dump(self, limit: int | None = None) -> list[dict]:
        """Newest-first merge of every ring (a stable sort by record time;
        each ring's dump is already newest first)."""
        count = self.capacity if limit is None else max(0, min(limit, self.capacity))
        rows: list[dict] = []
        for r in self.recorders:
            rows.extend(r.dump(count))
        rows.sort(key=lambda rec: rec.get("ts", 0.0), reverse=True)
        return rows[:count]
