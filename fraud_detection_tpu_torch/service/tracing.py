"""OpenTelemetry tracing, gated on availability and configuration.

The JAX package's ``service/tracing.py`` on the port: a TracerProvider with
an OTLP HTTP exporter and a BatchSpanProcessor when
``OTEL_EXPORTER_OTLP_ENDPOINT`` is set and the SDK imports; a no-op
otherwise, so the service never depends on the OTEL packages (imported
only inside :func:`setup_tracing`). Correlation ids ride apart from it
(the middleware and the task arguments) and work with or without OTEL.

- ``setup_tracing(force=True)`` clears the one-shot latch, so an endpoint
  configured after the first call, or a transient import failure, does not
  leave tracing off for the life of the process;
- :func:`current_traceparent` serializes the active span as a W3C
  ``traceparent`` that rides the task queue as the 4th task argument;
  ``span(..., traceparent=...)`` on the worker links its ``compute_shap``
  span to the originating request;
- :func:`emit_stage_spans` re-emits a completed
  :class:`~fraud_detection_tpu_torch.telemetry.timeline.RequestTimeline`
  as explicitly timestamped child spans of the current ``predict`` (or
  ``ingest.frame``) span.

The module talks to the tracer through a small duck-typed surface
(``start_as_current_span``, ``start_span(name, start_time=...)``), so a
stub tracer stands in where the SDK is not installed.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import re

from fraud_detection_tpu_torch import config

log = logging.getLogger("fraud_detection_tpu_torch.tracing")

_tracer = None
_initialized = False

#: the innermost span opened via :func:`span` — tracked here (not via the
#: OTEL context API) so traceparent serialization also works with stub
#: tracers in OTEL-free environments.
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "fraud_tracing_span", default=None
)

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def setup_tracing(service_name: str | None = None, force: bool = False) -> bool:
    """Initialize the tracer provider; returns True when real tracing is on.

    One-shot per process unless ``force=True``, which re-runs the whole
    init — the escape hatch for an endpoint that appears after first call
    or a transient import failure (previously either case latched tracing
    off forever).
    """
    global _tracer, _initialized
    if _initialized and not force:
        return _tracer is not None
    _initialized = True
    if force:
        _tracer = None
    endpoint = config.otel_endpoint()
    if not endpoint:
        return False
    try:
        from opentelemetry import trace
        from opentelemetry.exporter.otlp.proto.http.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor

        existing = trace.get_tracer_provider()
        if isinstance(existing, TracerProvider):
            # A real provider is already installed (a forced re-setup after
            # a successful one): reuse it — the global set_tracer_provider
            # is itself one-shot and would silently drop a replacement.
            _tracer = trace.get_tracer("fraud_detection_tpu_torch")
            return True
        provider = TracerProvider(
            resource=Resource.create(
                {"service.name": service_name or config.otel_service_name()}
            )
        )
        provider.add_span_processor(
            BatchSpanProcessor(OTLPSpanExporter(endpoint=f"{endpoint}/v1/traces"))
        )
        trace.set_tracer_provider(provider)
        _tracer = trace.get_tracer("fraud_detection_tpu_torch")
        log.info("OTEL tracing enabled → %s", endpoint)
        return True
    except Exception as e:  # no SDK or exporter here: tracing stays off
        log.warning("OTEL setup failed (%s); tracing disabled", e)
        return False


def _remote_parent_context(traceparent: str):
    """An OTEL Context carrying the remote parent, or None when the SDK is
    absent or the header is malformed (then the span simply isn't linked)."""
    parsed = parse_traceparent(traceparent)
    if parsed is None:
        return None
    trace_id, span_id, flags = parsed
    try:
        from opentelemetry import trace
        from opentelemetry.trace import (
            NonRecordingSpan,
            SpanContext,
            TraceFlags,
        )

        return trace.set_span_in_context(
            NonRecordingSpan(
                SpanContext(
                    trace_id=trace_id,
                    span_id=span_id,
                    is_remote=True,
                    trace_flags=TraceFlags(flags),
                )
            )
        )
    # no SDK, or a stub tracer: the span is not linked
    except Exception:  # lockcheck: ignore[silent-except] (the reason above)
        return None


@contextlib.contextmanager
def span(name: str, traceparent: str | None = None, **attributes):
    """Start a span when tracing is configured; no-op otherwise.

    ``traceparent`` (a W3C header string, e.g. from
    :func:`current_traceparent` carried through the task queue) makes the
    new span a child of that remote context, linking worker spans to the
    originating request.
    """
    if _tracer is None:
        yield None
        return
    kwargs = {}
    if traceparent:
        # the attribute records lineage even when the OTEL context API is
        # unavailable (stub tracers / API-less installs); the real remote
        # parent context rides alongside when it can be built
        attributes.setdefault("trace.parent", traceparent)
        ctx = _remote_parent_context(traceparent)
        if ctx is not None:
            kwargs["context"] = ctx
    with _tracer.start_as_current_span(name, **kwargs) as s:
        token = _current_span.set(s)
        try:
            for k, v in attributes.items():
                s.set_attribute(k, v)
            yield s
        finally:
            _current_span.reset(token)


def parse_traceparent(header: str) -> tuple[int, int, int] | None:
    """W3C traceparent → (trace_id, span_id, flags) ints; None if invalid."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    trace_id = int(m.group(1), 16)
    span_id = int(m.group(2), 16)
    if trace_id == 0 or span_id == 0:
        return None
    return trace_id, span_id, int(m.group(3), 16)


def format_traceparent(span_obj) -> str | None:
    """Serialize a span's context as a W3C traceparent header string."""
    try:
        ctx = span_obj.get_span_context()
        trace_id = int(ctx.trace_id)
        span_id = int(ctx.span_id)
        flags = int(getattr(ctx, "trace_flags", 1))
    # a span without a usable context serializes to None
    except Exception:  # lockcheck: ignore[silent-except] (the reason above)
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return f"00-{trace_id:032x}-{span_id:016x}-{flags:02x}"


def current_traceparent() -> str | None:
    """The active :func:`span`'s context as a traceparent string, or None
    when no span is open / tracing is off."""
    s = _current_span.get()
    if s is None:
        return None
    return format_traceparent(s)


def emit_stage_spans(timeline) -> int:
    """Re-emit a completed RequestTimeline's stages as explicitly-timestamped
    child spans of the current span. Returns how many spans were emitted
    (0 with tracing off). Must be called inside the parent ``span(...)``
    block so the children parent correctly."""
    if _tracer is None:
        return 0
    emitted = 0
    for stage, start_ns, end_ns in timeline.stage_spans_ns():
        try:
            s = _tracer.start_span(f"stage:{stage}", start_time=start_ns)
            s.set_attribute("stage", stage)
            s.set_attribute("duration_ms", (end_ns - start_ns) / 1e6)
            s.end(end_time=end_ns)
            emitted += 1
        except Exception:
            log.debug("stage span emit failed", exc_info=True)
            break
    return emitted
