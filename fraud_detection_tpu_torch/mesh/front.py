"""The shard front: route, balance, drain — a dead shard sheds load (the
JAX package's ``mesh/front.py``).

N replica shards (each one micro-batcher with its own flush pipeline) sit
behind one router. A request goes to the healthy shard with the fewest
rows in flight, which under light traffic also keeps buckets full on fewer
shards. An entity's rows prefer shard ``fingerprint mod N`` (sticky
routing) while that shard is healthy. A shard whose flushes fail
``MESH_SHARD_MAX_ERRORS`` times in a row is marked DEAD: the failed
request retries on another shard in the same call, so a dying shard costs
a retry, not an error. When no shard is healthy, the longest-dead shard
whose rest (``MESH_SHARD_REOPEN_S``) is over takes one half-open probe
request: a success revives it, a failure kills it again at once.

All shards share the lifecycle's ``ModelSlot`` and the watchtower's drift
monitor, so a promotion lands on every shard between its flushes and one
warm-up covers them all. ``drain()`` stops new picks while in-flight rows
finish; ``revive()`` re-admits (and calls ``on_revive``: the app asks the
lifeboat for a snapshot there).

Metrics: ``mesh_shards``, ``mesh_shards_healthy`` and the per-shard
``mesh_shard_healthy``, ``mesh_shard_inflight``, ``mesh_shard_rows`` and
``mesh_shard_errors`` (the inputs of
``monitoring/prometheus/rules/mesh-alerts.yml``). A shard turning DEAD or
DRAINING drops its per-shard scorer gauges (``metrics.drop_shard_gauges``)
so a dashboard never reads its last sample as live; a revive rebinds them.
Every routed attempt feeds the SLO engine under ``shard<N>``. Admission
backpressure (``AdmissionFull``) is flow control, not failure: it burns
neither the shard's error budget nor its SLO.
"""

from __future__ import annotations

import logging
import time

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.range.faults import fire
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.telemetry import slo

log = logging.getLogger("fraud_detection_tpu_torch.mesh")

HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"
#: a dead shard under its single half-open probe: out of the rotation, so
#: only the request that opened the probe rides it
HALF_OPEN = "half_open"


class NoHealthyShards(RuntimeError):
    """Every shard is dead or draining: the front cannot place the row."""


class ShardHandle:
    """One shard's batcher and its health bookkeeping."""

    def __init__(self, shard_id: int, batcher, max_consecutive_errors: int):
        self.shard_id = shard_id
        self.batcher = batcher
        self.state = HEALTHY
        self.inflight = 0
        self.rows_total = 0
        self.errors_total = 0
        self.consecutive_errors = 0
        self.dead_since: float | None = None
        # a shard revived by a half-open probe dies on its first failure
        self.probation = False
        self._max_errors = max_consecutive_errors
        label = str(shard_id)
        self._g_healthy = metrics.mesh_shard_healthy.labels(label)
        self._g_inflight = metrics.mesh_shard_inflight.labels(label)
        self._c_rows = metrics.mesh_shard_rows.labels(label)
        self._c_errors = metrics.mesh_shard_errors.labels(label)
        self._g_healthy.set(1)
        self._g_inflight.set(0)

    def note_ok(self, rows: int = 1) -> bool:
        """One success (``rows`` > 1 for an ingest block); True when it
        resolved a half-open probe, which revives the shard."""
        self.consecutive_errors = 0
        self.probation = False
        self.rows_total += rows
        self._c_rows.inc(rows)
        if self.state == HALF_OPEN:
            self.set_state(HEALTHY)
            return True
        return False

    def note_error(self, exc: BaseException) -> bool:
        """One failure; True when it crossed the death threshold (a shard on
        probation dies on its first)."""
        self.errors_total += 1
        self.consecutive_errors += 1
        self._c_errors.inc()
        if self.state in (HEALTHY, HALF_OPEN) and (
            self.probation or self.consecutive_errors >= self._max_errors
        ):
            self.set_state(DEAD)
            return True
        return False

    def set_state(self, state: str) -> None:
        prev = self.state
        self.state = state
        self.dead_since = time.monotonic() if state == DEAD else None
        if state != HEALTHY:
            self.probation = False
        self._g_healthy.set(1 if state == HEALTHY else 0)
        shard_label = str(getattr(self.batcher, "shard_id", self.shard_id))
        if state in (DEAD, DRAINING):
            metrics.drop_shard_gauges(shard_label)
        elif state == HEALTHY and prev != HEALTHY:
            rebind = getattr(self.batcher, "rebind_shard_gauges", None)
            if rebind is not None:
                rebind()

    def to_dict(self) -> dict:
        return {
            "shard": self.shard_id,
            "state": self.state,
            "inflight": self.inflight,
            "rows_total": self.rows_total,
            "errors_total": self.errors_total,
        }


class ShardFront:
    """Router over N shard batchers with one micro-batcher's surface
    (``start``/``stop``/``score``/``score_ex``/``score_block``), so the app
    puts it behind ``/predict``, ``/ingest/batch`` and the binary lane
    unchanged."""

    def __init__(
        self,
        batchers,
        max_consecutive_errors: int | None = None,
        reopen_after: float | None = None,
        on_revive=None,
    ):
        if not batchers:
            raise ValueError("ShardFront needs at least one shard batcher")
        # on_revive(shard_id): a shard rejoined the rotation (operator
        # revive, or a half-open probe resolving)
        self._on_revive = on_revive
        max_err = (
            max_consecutive_errors if max_consecutive_errors is not None
            else config.mesh_shard_max_errors()
        )
        self.reopen_after = (
            reopen_after if reopen_after is not None else config.mesh_shard_reopen_s()
        )
        # the front owns shard identity: distinct per-shard series even for
        # batchers built without a shard id
        for i, b in enumerate(batchers):
            setter = getattr(b, "set_shard_id", None)
            if setter is not None:
                setter(i)
        self.shards = [ShardHandle(i, b, max_err) for i, b in enumerate(batchers)]
        metrics.mesh_shards.set(len(self.shards))
        metrics.mesh_shards_healthy.set(len(self.shards))
        # the per-shard SLO series exist (at 0 burn) from the first scrape
        eng = slo.engine()
        if eng is not None:
            eng.declare_shards(len(self.shards))

    # -- the micro-batcher's surface -----------------------------------------
    @property
    def telemetry(self) -> bool:
        return self.shards[0].batcher.telemetry

    @property
    def explain(self) -> bool:
        """Serve-time reason codes configured: the shards share the setting,
        so shard 0 speaks for the front."""
        return bool(getattr(self.shards[0].batcher, "explain", False))

    async def start(self) -> None:
        # the shards share the slot's scorer and the watchtower's monitor,
        # so one bucket-ladder warm-up covers all: shard 0 warms
        for i, h in enumerate(self.shards):
            await h.batcher.start(warm=(i == 0))

    async def stop(self) -> None:
        for h in self.shards:
            await h.batcher.stop()

    # -- routing ------------------------------------------------------------
    def _healthy(self) -> list[ShardHandle]:
        return [h for h in self.shards if h.state == HEALTHY]

    def pick(self, exclude: set[int] | None = None, entity=None) -> ShardHandle:
        """The healthy shard with the fewest rows in flight, leaving out the
        shards this request already failed on (a fast-failing shard has the
        fewest). ``entity`` (the edge's ``(slot, fingerprint, ts)`` triple)
        prefers shard ``fingerprint mod N`` while it is healthy and not
        excluded: availability beats stickiness."""
        healthy = [h for h in self._healthy() if not exclude or h.shard_id not in exclude]
        if not healthy:
            probe = self._half_open_candidate(exclude)
            if probe is not None:
                return probe
            raise NoHealthyShards(
                f"all {len(self.shards)} shards dead, draining, or already "
                "tried by this request"
            )
        if entity is not None:
            preferred = self.shards[int(entity[1]) % len(self.shards)]
            if preferred in healthy:
                return preferred
        return min(healthy, key=lambda h: h.inflight)

    def _half_open_candidate(self, exclude: set[int] | None) -> ShardHandle | None:
        """With every shard down: the longest-dead shard whose rest is over
        goes HALF_OPEN and takes this one request (concurrent traffic keeps
        seeing NoHealthyShards). None when no shard has rested."""
        now = time.monotonic()
        rested = [
            h for h in self.shards
            if h.state == DEAD
            and (not exclude or h.shard_id not in exclude)
            and h.dead_since is not None
            and now - h.dead_since >= self.reopen_after
        ]
        if not rested:
            return None
        probe = min(rested, key=lambda h: h.dead_since)
        dead_for = now - probe.dead_since
        probe.set_state(HALF_OPEN)
        probe.probation = True
        log.warning("shard %d half-open probe after %.1fs dead", probe.shard_id, dead_for)
        return probe

    def _refresh_health_gauge(self) -> None:
        metrics.mesh_shards_healthy.set(len(self._healthy()))

    async def score(self, row, timeline=None, entity=None) -> float:
        """Route one row; a failing shard is retried elsewhere in the same
        call (at most once a shard), so the caller sees a score or one
        final error."""
        return await self._route("score", row, timeline, entity)

    async def score_ex(self, row, timeline=None, entity=None):
        """:meth:`score` through the explain surface: ``(score, reasons)``
        from whichever shard scored the row."""
        return await self._route("score_ex", row, timeline, entity)

    async def score_block(self, block, timeline=None):
        """Route one ingest block as a unit: the whole frame lands on ONE
        shard's forming bucket. A shard whose admission queue is full is
        not an error: the block tries the others and sheds
        (``AdmissionFull``) only when every healthy shard is full."""
        return await self._route("score_block", block, timeline, None)

    async def _route(self, method: str, row, timeline=None, entity=None):
        from fraud_detection_tpu_torch.service.microbatch import AdmissionFull

        last_exc: BaseException | None = None
        tried: set[int] = set()
        n_rows = row.n if method == "score_block" else 1
        for _ in range(len(self.shards)):
            try:
                h = self.pick(exclude=tried, entity=entity)
            except NoHealthyShards:
                if last_exc is not None:
                    raise last_exc
                raise
            tried.add(h.shard_id)
            h.inflight += n_rows
            h._g_inflight.set(h.inflight)
            t_attempt = time.perf_counter()
            try:
                # the fault point a drill fails a named shard's scoring at;
                # disarmed, one global load
                fire("mesh.shard_flush", shard=h.shard_id)
                if method == "score_block":
                    out = await h.batcher.score_block(row, timeline)
                else:
                    out = await getattr(h.batcher, method)(row, timeline, entity)
            except AdmissionFull as e:
                last_exc = e
                continue
            except Exception as e:
                last_exc = e
                slo.record_shard(h.shard_id, False)
                if h.note_error(e):
                    self._refresh_health_gauge()
                    log.error(
                        "shard %d marked dead after %d consecutive errors — "
                        "shedding load (%s)", h.shard_id, h.consecutive_errors, e,
                    )
                continue
            else:
                slo.record_shard(h.shard_id, True, time.perf_counter() - t_attempt)
                if h.note_ok(n_rows):
                    self._refresh_health_gauge()
                    log.warning("shard %d revived by half-open probe", h.shard_id)
                    self._notify_revive(h.shard_id)
                return out
            finally:
                h.inflight -= n_rows
                h._g_inflight.set(h.inflight)
        raise last_exc if last_exc is not None else NoHealthyShards("no healthy shards")

    # -- operations ---------------------------------------------------------
    def drain(self, shard_id: int) -> None:
        """Stop routing new rows to ``shard_id``; in-flight rows finish.
        Refuses (``ValueError``) to drain the last healthy shard: a drain
        that turned every request into NoHealthyShards would be a
        self-inflicted outage."""
        h = self.shards[shard_id]
        if h.state != HEALTHY:
            return
        if len(self._healthy()) <= 1:
            raise ValueError(
                f"refusing to drain shard {shard_id}: it is the last healthy "
                "shard — revive another shard first"
            )
        h.set_state(DRAINING)
        self._refresh_health_gauge()
        log.warning("shard %d draining", shard_id)

    def wait_drained(self, shard_id: int, timeout: float = 10.0) -> bool:
        """Block until a draining shard has no rows in flight (a poll, so an
        admin path can call it from a thread)."""
        deadline = time.monotonic() + timeout
        h = self.shards[shard_id]
        while h.inflight > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def revive(self, shard_id: int) -> None:
        """Re-admit a drained or dead shard with a full error budget."""
        h = self.shards[shard_id]
        h.consecutive_errors = 0
        h.probation = False
        h.set_state(HEALTHY)
        self._refresh_health_gauge()
        log.warning("shard %d revived", shard_id)
        self._notify_revive(shard_id)

    def _notify_revive(self, shard_id: int) -> None:
        if self._on_revive is None:
            return
        try:
            self._on_revive(shard_id)
        except Exception:
            log.debug("on_revive hook failed", exc_info=True)

    def status(self) -> dict:
        return {
            "shards": len(self.shards),
            "healthy": len(self._healthy()),
            "per_shard": [h.to_dict() for h in self.shards],
        }
