"""spyglass: the serving path's per-request stage timelines and the
flight recorder.

- :mod:`.timeline` — ``RequestTimeline`` carried through the
  micro-batcher; six stages (enqueue → flush_wait → pad_bucket →
  device_compute → d2h → respond) exported as
  ``request_stage_duration_seconds{stage}``;
- :mod:`.flightrecorder` — the ring of the last N request records behind
  ``GET /debug/flightrecorder``.

``SPYGLASS_ENABLED=0`` turns both off: the flush then stamps nothing and
adds no fence. The JAX package's compile sentinel, profiler, roofline and
device-memory gauges wait for ROADMAP item 13.
"""

from fraud_detection_tpu_torch.telemetry.flightrecorder import FlightRecorder  # noqa: F401
from fraud_detection_tpu_torch.telemetry.timeline import (  # noqa: F401
    STAGES,
    FlushInfo,
    RequestTimeline,
)
