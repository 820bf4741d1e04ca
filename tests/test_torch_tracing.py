"""The port's tracing (``service/tracing.py``) against the JAX package's:
``parse_traceparent``/``format_traceparent`` on a table of valid and
malformed headers; with one stub tracer design injected into both packages,
the ``predict`` span, its six stage spans (names and timestamps from one
timeline), the task's traceparent, the worker's linked ``compute_shap``
spans and the ``ingest.frame`` span of a traced frame; and
``setup_tracing`` off without an endpoint or without the SDK."""

import contextlib
import importlib.abc
import json
import os
import shutil
import sqlite3
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fraud_detection_tpu.service.tracing as jax_tracing
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.binlane import encode_frame as jax_encode_frame
from fraud_detection_tpu.service.http import Request as JaxRequest
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.service.worker import XaiWorker as JaxWorker
from fraud_detection_tpu.telemetry import compile_sentinel as jax_sentinel
from fraud_detection_tpu.telemetry import slo as jax_slo
from fraud_detection_tpu.telemetry.timeline import FlushInfo as JaxFlushInfo
from fraud_detection_tpu.telemetry.timeline import RequestTimeline as JaxTimeline
from fraud_detection_tpu_torch.service import tracing
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.binlane import encode_frame
from fraud_detection_tpu_torch.service.http import Request, TestClient
from fraud_detection_tpu_torch.service.worker import XaiWorker
from fraud_detection_tpu_torch.telemetry import STAGES, FlushInfo, RequestTimeline
from fraud_detection_tpu_torch.telemetry import compile_sentinel, slo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDR = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


class StubSpan:
    def __init__(self, name, trace_id, span_id, start_time=None):
        self.name = name
        self.attributes: dict = {}
        self.start_time = start_time
        self.end_time = None
        self._ctx = SimpleNamespace(trace_id=trace_id, span_id=span_id, trace_flags=1)

    def set_attribute(self, k, v):
        self.attributes[k] = v

    def get_span_context(self):
        return self._ctx

    def end(self, end_time=None):
        self.end_time = end_time

    def view(self):
        return (self.name, self.start_time, self.end_time, self.attributes)


class StubTracer:
    """The duck-typed tracer surface both packages talk to; records every
    span it hands out, with deterministic ids."""

    TRACE_ID = 0x0AF7651916CD43DD8448EB211C80319C

    def __init__(self):
        self.spans: list[StubSpan] = []

    def _new(self, name, start_time=None):
        s = StubSpan(name, self.TRACE_ID, len(self.spans) + 1, start_time=start_time)
        self.spans.append(s)
        return s

    @contextlib.contextmanager
    def start_as_current_span(self, name, **kw):
        yield self._new(name)

    def start_span(self, name, start_time=None, **kw):
        return self._new(name, start_time=start_time)

    def named(self, name):
        return [s for s in self.spans if s.name == name]


@pytest.fixture()
def stubs(monkeypatch):
    """(port stub, JAX stub): one fresh stub tracer in each package."""
    port, jax_stub = StubTracer(), StubTracer()
    monkeypatch.setattr(tracing, "_tracer", port)
    monkeypatch.setattr(tracing, "_initialized", True)
    monkeypatch.setattr(jax_tracing, "_tracer", jax_stub)
    monkeypatch.setattr(jax_tracing, "_initialized", True)
    return port, jax_stub


# -- traceparent helpers ------------------------------------------------------

HEADERS = [
    HDR,
    HDR.upper(),
    f"  {HDR}  ",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",  # zero trace
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",  # zero span
    "00-0af7651916cd43dd8448eb211c80319-b7ad6b7169203331-01",  # short trace
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-1",  # short flags
    "00-0af7651916cd43dd8448eb211c80319g-b7ad6b7169203331-01",  # not hex
    f"{HDR}-extra",
    "0-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "garbage", "", None, 17, b"00-aa", ["x"],
]


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_matches_jax(header):
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header)


@pytest.mark.parametrize("trace_id, span_id, flags", [
    (0x0AF7651916CD43DD8448EB211C80319C, 0xB7AD6B7169203331, 1),
    (1, 1, 0), (2 ** 128 - 1, 2 ** 64 - 1, 255), (0, 5, 1), (5, 0, 1),
])
def test_format_traceparent_matches_jax(trace_id, span_id, flags):
    s = StubSpan("s", trace_id, span_id)
    s._ctx.trace_flags = flags
    got = tracing.format_traceparent(s)
    assert got == jax_tracing.format_traceparent(s)
    if got is not None:
        assert tracing.parse_traceparent(got) == (trace_id, span_id, flags)
    assert tracing.format_traceparent(object()) is jax_tracing.format_traceparent(object()) is None


def test_current_traceparent_and_remote_link_match_jax(stubs):
    port, jax_stub = stubs
    assert tracing.current_traceparent() is jax_tracing.current_traceparent() is None
    with tracing.span("outer") as s, jax_tracing.span("outer") as js:
        assert tracing.current_traceparent() == jax_tracing.current_traceparent()
        assert tracing.parse_traceparent(tracing.current_traceparent())[0] == StubTracer.TRACE_ID
    assert s.view() == js.view()
    assert tracing.current_traceparent() is None
    with tracing.span("child", traceparent=HDR, correlation_id="c9") as s, \
            jax_tracing.span("child", traceparent=HDR, correlation_id="c9") as js:
        pass
    assert s.attributes == js.attributes == {"trace.parent": HDR, "correlation_id": "c9"}


# -- stage spans from one timeline ------------------------------------------

def _stamped(tl_cls, fi_cls, t, wall_ns):
    tl = tl_cls(correlation_id="c1")
    tl.wall_anchor_ns, tl.perf_anchor = wall_ns, t
    tl.t_enqueued = t + 0.0001
    tl.t_collected = t + 0.001
    tl.flush = fi_cls(t_flush_start=t + 0.002, t_padded=t + 0.003, t_synced=t + 0.007,
                      t_fetched=t + 0.008, batch_size=4, bucket=8)
    tl.flush.t_resolved = t + 0.009
    return tl


def test_six_stage_spans_match_jax_from_one_timeline(stubs):
    port, jax_stub = stubs
    t, wall = time.perf_counter(), time.time_ns()
    tl = _stamped(RequestTimeline, FlushInfo, t, wall)
    jtl = _stamped(JaxTimeline, JaxFlushInfo, t, wall)
    with tracing.span("predict", correlation_id="c1"):
        assert tracing.emit_stage_spans(tl) == 6
    with jax_tracing.span("predict", correlation_id="c1"):
        assert jax_tracing.emit_stage_spans(jtl) == 6
    assert [s.view() for s in port.spans] == [s.view() for s in jax_stub.spans]
    assert [s.name for s in port.spans[1:]] == [f"stage:{n}" for n in STAGES]
    for s in port.spans[1:]:
        assert s.end_time >= s.start_time >= wall
    # tracing off: nothing emitted
    tracing._tracer = None
    assert tracing.emit_stage_spans(tl) == 0


# -- the served path ------------------------------------------------------------

@pytest.fixture()
def served(tmp_path, monkeypatch):
    d = str(tmp_path / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    monkeypatch.setenv("MODEL_PATH", os.path.join(d, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("SCORER_MAX_BATCH", "16")
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("DEVICE_PEAK_FLOPS", "1e9")
    monkeypatch.setenv("DEVICE_PEAK_BYTES_PER_S", "1e9")
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    urls = {k: (f"sqlite:///{tmp_path}/{k}.db", f"sqlite:///{tmp_path}/{k}q.db")
            for k in ("port", "jax")}
    slo._reset_for_tests()
    jax_slo._reset_for_tests()
    yield urls
    compile_sentinel.uninstall()
    jax_sentinel.uninstall()
    slo._reset_for_tests()
    jax_slo._reset_for_tests()


def _task_args(broker_url, corr):
    conn = sqlite3.connect(broker_url[len("sqlite:///"):])
    try:
        (args,) = conn.execute(
            "SELECT args FROM tasks WHERE correlation_id=?", (corr,)).fetchone()
    finally:
        conn.close()
    return json.loads(args)


def test_predict_task_and_worker_spans_match_jax(served, stubs):
    port, jax_stub = stubs
    (pdb, pq), (jdb, jq) = served["port"], served["jax"]
    with TestClient(create_app(database_url=pdb, broker_url=pq)) as tc, \
            JaxClient(jax_create_app(database_url=jdb, broker_url=jq)) as jc:
        for c in (tc, jc):
            r = c.post("/predict", json={"features": [0.4] * 30},
                       headers={"X-Correlation-ID": "prop-1"})
            assert r.status_code == 200
    for stub in (port, jax_stub):
        (predict,) = stub.named("predict")
        assert predict.attributes == {"correlation_id": "prop-1"}
        stages = [s for s in stub.spans if s.name.startswith("stage:")]
        assert [s.name for s in stages] == [f"stage:{n}" for n in STAGES]
    assert [(s.name, sorted(s.attributes)) for s in port.spans] == \
        [(s.name, sorted(s.attributes)) for s in jax_stub.spans]
    args, jargs = _task_args(pq, "prop-1"), _task_args(jq, "prop-1")
    assert len(args) == len(jargs) == 4
    assert args[3] == jargs[3]  # the predict span's context, ids alike
    assert tracing.parse_traceparent(args[3])[0] == StubTracer.TRACE_ID
    n_before = (len(port.spans), len(jax_stub.spans))
    assert XaiWorker(broker_url=pq, database_url=pdb, device="cpu").run_once()
    assert JaxWorker(broker_url=jq, database_url=jdb).run_once()
    (shap,), (jshap,) = port.named("compute_shap"), jax_stub.named("compute_shap")
    assert shap.attributes == jshap.attributes == {
        "trace.parent": args[3], "correlation_id": "prop-1"}
    assert (len(port.spans) - n_before[0]) == (len(jax_stub.spans) - n_before[1]) == 1


def test_batched_worker_links_every_task(served, stubs):
    port, jax_stub = stubs
    (pdb, pq), (jdb, jq) = served["port"], served["jax"]
    with TestClient(create_app(database_url=pdb, broker_url=pq)) as tc, \
            JaxClient(jax_create_app(database_url=jdb, broker_url=jq)) as jc:
        for c in (tc, jc):
            for i in range(3):
                assert c.post("/predict", json={"features": [0.1 * i] * 30},
                              headers={"X-Correlation-ID": f"b-{i}"}).status_code == 200
    assert XaiWorker(broker_url=pq, database_url=pdb, device="cpu").run_batch() == 3
    assert JaxWorker(broker_url=jq, database_url=jdb).run_batch() == 3
    got = sorted((s.attributes["correlation_id"], s.attributes["trace.parent"])
                 for s in port.named("compute_shap"))
    want = sorted((s.attributes["correlation_id"], s.attributes["trace.parent"])
                  for s in jax_stub.named("compute_shap"))
    assert got == want and len(got) == 3
    for corr, tp in got:
        assert tp == _task_args(pq, corr)[3]


def _post_raw(client, request_cls, body, headers):
    req = request_cls("POST", "/ingest/batch", headers, body)

    async def go():
        await client.app.startup()
        return await client.app.dispatch(req)

    return client.loop.run_until_complete(go())


def test_traced_frame_opens_an_ingest_frame_span_like_jax(served, stubs):
    port, jax_stub = stubs
    (pdb, pq), (jdb, jq) = served["port"], served["jax"]
    rows = np.random.default_rng(3).standard_normal((5, 30)).astype(np.float32)
    frame = encode_frame(rows, length_prefix=False, traceparent=HDR)
    assert frame == jax_encode_frame(rows, length_prefix=False, traceparent=HDR)
    import msgpack

    body = msgpack.packb({"rows": rows.tolist()})
    with TestClient(create_app(database_url=pdb, broker_url=pq)) as tc, \
            JaxClient(jax_create_app(database_url=jdb, broker_url=jq)) as jc:
        for c, req_cls in ((tc, Request), (jc, JaxRequest)):
            r = _post_raw(c, req_cls, frame, {"content-type": "application/x-fraud-frame"})
            assert r.status_code == 200
            # the header's trace on a msgpack body; a malformed one is dropped
            r = _post_raw(c, req_cls, body, {
                "content-type": "application/msgpack", "traceparent": HDR})
            assert r.status_code == 200
            r = _post_raw(c, req_cls, body, {
                "content-type": "application/msgpack", "traceparent": "bogus"})
            assert r.status_code == 200
    for stub in (port, jax_stub):
        frames = stub.named("ingest.frame")
        assert [s.attributes for s in frames] == [
            {"trace.parent": HDR, "lane": "binary", "rows": 5},
            {"trace.parent": HDR, "lane": "msgpack", "rows": 5},
        ]
    assert [s.name for s in port.spans] == [s.name for s in jax_stub.spans]


# -- setup ------------------------------------------------------------------------

class _RefuseSdk(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith("opentelemetry.sdk") or name.startswith("opentelemetry.exporter"):
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


@pytest.mark.parametrize("endpoint", [None, "http://127.0.0.1:1"])
def test_setup_tracing_is_off_without_an_endpoint_or_the_sdk(endpoint, monkeypatch):
    for mod in (tracing, jax_tracing):
        monkeypatch.setattr(mod, "_initialized", False)
        monkeypatch.setattr(mod, "_tracer", None)
    if endpoint is None:
        monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    else:
        monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", endpoint)
        monkeypatch.setattr(sys, "meta_path", [_RefuseSdk()] + sys.meta_path)
        for name in [m for m in sys.modules if m.startswith(("opentelemetry.sdk",
                                                               "opentelemetry.exporter"))]:
            monkeypatch.delitem(sys.modules, name)
    assert tracing.setup_tracing() is False
    assert jax_tracing.setup_tracing() is False
    assert tracing.setup_tracing() is False  # latched: the same answer
    with tracing.span("anything", correlation_id="c") as s:
        assert s is None
    # force re-runs the init and drops a stale tracer
    tracing._tracer = StubTracer()
    assert tracing.setup_tracing() is True
    assert tracing.setup_tracing(force=True) is False and tracing._tracer is None
