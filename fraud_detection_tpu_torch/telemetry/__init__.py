"""spyglass and panopticon: the port's observability layer.

- :mod:`.timeline` — ``RequestTimeline`` carried through the
  micro-batcher; six stages (enqueue → flush_wait → pad_bucket →
  device_compute → d2h → respond) exported as
  ``request_stage_duration_seconds{stage}`` and, with tracing on, as child
  spans of the ``predict`` and ``ingest.frame`` spans;
- :mod:`.flightrecorder` — the ring of the last N request records behind
  ``GET /debug/flightrecorder`` (one ring a shard under the mesh's front,
  merged by ``RecorderSet``);
- :mod:`.compile_sentinel` — wraps the serving entrypoints, counts the
  kernel libraries their calls build or load
  (``xla_compiles_total{entrypoint}``) and raises ``xla_recompile_storm``
  on a jump;
- :mod:`.roofline` — each fused flush's shape-derived costs and the live
  ``device_utilization_fraction`` against the measured peaks;
- :mod:`.slo` — the lanes' availability and latency objectives behind
  ``GET /slo/status``;
- :mod:`.profiler` — duration-bounded, single-flight device traces for
  ``POST /admin/profile``;
- :mod:`.devicemem` — the card's memory watermark gauges, refreshed at
  scrape time.

``SPYGLASS_ENABLED=0`` turns the timelines and the recorder off: the flush
then stamps nothing and adds no fence (and the roofline, which divides by
the fenced time, sees no flush). ``SLO_ENABLED=0`` and ``ROOFLINE_ENABLED=0``
turn their layers off.
"""

from fraud_detection_tpu_torch.telemetry.compile_sentinel import (  # noqa: F401
    expected_compiles,
    install,
    instrument,
    refresh_storm_gauges,
    uninstall,
)
from fraud_detection_tpu_torch.telemetry.flightrecorder import (  # noqa: F401
    FlightRecorder,
    RecorderSet,
)
from fraud_detection_tpu_torch.telemetry.timeline import (  # noqa: F401
    STAGES,
    FlushInfo,
    RequestTimeline,
)
