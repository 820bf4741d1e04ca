"""The port's compile sentinel, device-memory gauges, profiler, ``annotate``
and JSON logs against the JAX package's (its ``test_telemetry.py`` cases):
the storm detector fed one ``(entrypoint, n, now)`` sequence in both
packages, ``expected_compiles`` never feeding it, a kernel-library load
inside a wrapped call counted under its entrypoint, ``install`` and
``uninstall``, the memory gauges on stubbed stats, ``POST /admin/profile``
on the CPU with the JAX app's answers, and the JSON log fields."""

import contextlib
import io
import json
import logging
import os
import shutil
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.service import metrics as jax_metrics
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.telemetry import compile_sentinel as jax_sentinel
from fraud_detection_tpu.telemetry import devicemem as jax_devicemem
from fraud_detection_tpu.utils.jsonlog import JsonFormatter as JaxJsonFormatter
from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import TestClient
from fraud_detection_tpu_torch.telemetry import compile_sentinel, devicemem, slo
from fraud_detection_tpu_torch.utils import profiling
from fraud_detection_tpu_torch.utils.jsonlog import JsonFormatter

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_gauge(gauge, *labels) -> float:
    return (gauge.labels(*labels) if labels else gauge)._value.get()


def _jax_counter(counter, *labels) -> float:
    return counter.labels(*labels)._value.get()


@pytest.fixture()
def fresh_sentinels():
    """Both packages' storm windows emptied, before and after."""
    jax_sentinel._reset_for_tests()
    compile_sentinel._reset_for_tests()
    yield
    jax_sentinel._reset_for_tests()
    compile_sentinel._reset_for_tests()


# -- the series ---------------------------------------------------------------

#: the telemetry series of JAX ``service/metrics.py:457-560``, by attribute
SERIES = ["xla_compiles", "xla_compile_duration", "xla_recompile_storm",
          "device_memory_bytes_in_use", "device_memory_bytes_limit",
          "device_memory_peak_bytes_in_use", "device_profiles", "device_profile_active",
          "slo_burn_rate", "slo_error_budget_remaining", "slo_requests",
          "device_utilization_fraction", "device_peak_flops_estimate", "device_program_flops"]


@pytest.mark.parametrize("attr", SERIES)
def test_each_series_has_the_jax_name_labels_help_and_buckets(attr):
    ours, theirs = getattr(metrics, attr), getattr(jax_metrics, attr)
    assert ours.name == theirs._name
    assert ours.kind == type(theirs).__name__.lower()
    assert ours.labelnames == tuple(theirs._labelnames)
    assert ours.documentation == theirs._documentation
    if ours.kind == "histogram":
        assert list(ours.buckets) == list(theirs._upper_bounds)
    assert ours in metrics.REGISTRY


# -- the storm detector -------------------------------------------------------

#: (entrypoint, compiles, seconds after t0): four inside the window (a
#: storm at threshold 3), a lull past it, one more, then a burst on another
#: entrypoint
STORM_SEQUENCE = [
    ("unit.a", 1, 0.00), ("unit.a", 1, 0.01), ("unit.b", 2, 0.02),
    ("unit.a", 1, 0.03), ("unit.a", 1, 0.04), ("unit.a", 0, 60.0),
    ("unit.a", 1, 61.0), ("unit.b", 3, 61.5), ("unit.b", 0, 75.0),
]


def test_storm_detector_matches_jax_on_one_sequence(fresh_sentinels, monkeypatch):
    monkeypatch.setenv("RECOMPILE_STORM_WINDOW_S", "10")
    monkeypatch.setenv("RECOMPILE_STORM_THRESHOLD", "3")
    t0 = 5000.0
    seen = []
    for ep, n, dt in STORM_SEQUENCE:
        compile_sentinel._note_compiles(ep, n, now=t0 + dt)
        jax_sentinel._note_compiles(ep, n, now=t0 + dt)
        for e in ("unit.a", "unit.b"):
            got = metrics.xla_recompile_storm.get(e)
            assert got == _jax_gauge(jax_metrics.xla_recompile_storm, e), (ep, dt, e)
        seen.append(metrics.xla_recompile_storm.get("unit.a"))
    assert seen[:6] == [0, 0, 0, 1, 1, 0]  # raised inside the window, cleared past it
    # refill both, then the scrape-time prune clears both with no new event
    for k in range(4):
        compile_sentinel._note_compiles("unit.c", 1, now=t0 + 100 + k * 0.01)
        jax_sentinel._note_compiles("unit.c", 1, now=t0 + 100 + k * 0.01)
    assert metrics.xla_recompile_storm.get("unit.c") == 1
    assert _jax_gauge(jax_metrics.xla_recompile_storm, "unit.c") == 1
    monkeypatch.setattr(compile_sentinel.time, "monotonic", lambda: t0 + 200.0)
    monkeypatch.setattr(jax_sentinel.time, "monotonic", lambda: t0 + 200.0)
    compile_sentinel.refresh_storm_gauges()
    jax_sentinel.refresh_storm_gauges()
    assert metrics.xla_recompile_storm.get("unit.c") == 0
    assert _jax_gauge(jax_metrics.xla_recompile_storm, "unit.c") == 0


def _fake_load(name="fake", seconds=0.25):
    """What ``kernels.build_kernels`` appends for a library it loads."""
    kernels.LOAD_EVENTS.append((name, seconds, threading.get_ident()))


def test_expected_compiles_never_feed_the_storm_detector(fresh_sentinels):
    """Twenty loads under the expected mark count in ``xla_compiles_total``
    and leave the storm gauge at 0 — as twenty jit compiles do in JAX."""
    wrapped = compile_sentinel.instrument("unit.warm", lambda: _fake_load())
    f = jax.jit(lambda x: x - 1.0)
    jwrapped = jax_sentinel.instrument("unit.warm", f)
    before = metrics.xla_compiles.get("unit.warm")
    jbefore = _jax_counter(jax_metrics.xla_compiles, "unit.warm")
    with compile_sentinel.expected_compiles(), jax_sentinel.expected_compiles():
        for n in range(1, 21):
            wrapped()
            jwrapped(jnp.ones((n,), jnp.float32))
    assert metrics.xla_compiles.get("unit.warm") - before == 20
    assert _jax_counter(jax_metrics.xla_compiles, "unit.warm") - jbefore == 20
    assert metrics.xla_recompile_storm.get("unit.warm") == 0
    assert _jax_gauge(jax_metrics.xla_recompile_storm, "unit.warm") == 0
    assert "unit.warm" not in compile_sentinel._storm_windows
    # unmarked, the same twenty loads storm (default threshold 8)
    for _ in range(20):
        wrapped()
    assert metrics.xla_recompile_storm.get("unit.warm") == 1


def test_a_load_inside_a_wrapped_call_counts_under_its_entrypoint(
        fresh_sentinels, monkeypatch, tmp_path):
    """The real build-and-load path (``kernels._lib`` → ``build_kernels``,
    the library already built): the load inside a wrapped call counts once,
    under the innermost wrapped call, with its seconds; a load on another
    thread during the call, and a call that loads nothing, count nothing."""
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_lib_path", lambda name: lib)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: SimpleNamespace(path=path))
    monkeypatch.setattr(kernels, "_bind", lambda name, handle, signatures=None: handle)
    inner = compile_sentinel.instrument("unit.inner", lambda: kernels._lib("fused_score"))
    outer = compile_sentinel.instrument("unit.outer", lambda: inner())
    c_in, c_out = (metrics.xla_compiles.get(e) for e in ("unit.inner", "unit.outer"))
    dur = metrics.xla_compile_duration.labels("unit.inner")
    n0 = dur.count
    outer()
    assert metrics.xla_compiles.get("unit.inner") - c_in == 1
    assert metrics.xla_compiles.get("unit.outer") - c_out == 0
    assert dur.count - n0 == 1 and dur.value >= 0.0
    outer()  # loaded: a hit
    assert metrics.xla_compiles.get("unit.inner") - c_in == 1

    started, release = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(10)

    t = threading.Thread(target=compile_sentinel.instrument("unit.idle", slow))
    c_idle = metrics.xla_compiles.get("unit.idle")
    t.start()
    started.wait(10)
    _fake_load()  # this thread's load, during the other thread's call
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert metrics.xla_compiles.get("unit.idle") == c_idle


def test_install_wraps_the_port_bindings_and_uninstall_restores(fresh_sentinels):
    import fraud_detection_tpu_torch.monitor.drift as drift_mod
    import fraud_detection_tpu_torch.ops.scorer as scorer_mod

    compile_sentinel.uninstall()
    orig_score, orig_flush = scorer_mod._raw_score_linear, drift_mod._fused_flush
    orig_kernel = kernels.fused_score
    model = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu")
    x = np.random.default_rng(5).standard_normal((17, 30)).astype(np.float32)
    want = model.scorer.predict_proba(x)
    try:
        bindings = compile_sentinel.install()
        assert len(bindings) == sum(len(b) for b in compile_sentinel.WRAP_TARGETS.values())
        assert "fraud_detection_tpu_torch.ops.kernels.fused_score" in bindings
        assert scorer_mod._raw_score_linear is not orig_score
        assert scorer_mod._raw_score_linear._spyglass_entrypoint == "scorer"
        assert scorer_mod._raw_score_linear.__wrapped__ is orig_score
        assert drift_mod._fused_flush._spyglass_entrypoint == "fastlane.flush"
        assert kernels.fused_score.__wrapped__ is orig_kernel
        np.testing.assert_array_equal(model.scorer.predict_proba(x), want)
        assert compile_sentinel.install() == []  # idempotent
    finally:
        compile_sentinel.uninstall()
    assert scorer_mod._raw_score_linear is orig_score
    assert drift_mod._fused_flush is orig_flush
    assert kernels.fused_score is orig_kernel


# -- device memory ------------------------------------------------------------

def test_devicemem_on_stubbed_stats_gives_jax_gauges(monkeypatch):
    monkeypatch.setattr(devicemem, "_peak_seen", 0)
    monkeypatch.setattr(jax_devicemem, "_peak_seen", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 1000, "allocated_bytes.all.peak": 2500})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (6000, 8000))
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction", lambda dev: 0.5)
    fake = SimpleNamespace(memory_stats=lambda: {
        "bytes_in_use": 1000, "bytes_limit": 4000, "peak_bytes_in_use": 2500})
    monkeypatch.setattr(jax, "local_devices", lambda: [fake])
    got = devicemem.refresh("cuda:0")
    assert got == jax_devicemem.refresh() == {
        "bytes_in_use": 1000, "bytes_limit": 4000, "peak_bytes_in_use": 2500}
    for g, jg in ((metrics.device_memory_bytes_in_use, jax_metrics.device_memory_bytes_in_use),
                  (metrics.device_memory_bytes_limit, jax_metrics.device_memory_bytes_limit),
                  (metrics.device_memory_peak_bytes_in_use,
                   jax_metrics.device_memory_peak_bytes_in_use)):
        assert g.get() == _jax_gauge(jg)


def test_devicemem_is_none_on_the_cpu_as_jax_without_stats(monkeypatch):
    assert devicemem.refresh("cpu") is None
    monkeypatch.setenv("DEVICE", "cpu")
    assert devicemem.refresh() is None
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [SimpleNamespace(memory_stats=lambda: None)])
    assert jax_devicemem.refresh() is None


# -- /admin/profile on the CPU ------------------------------------------------

@pytest.fixture()
def both_apps(tmp_path, monkeypatch):
    d = str(tmp_path / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    monkeypatch.setenv("MODEL_PATH", os.path.join(d, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("SCORER_MAX_BATCH", "16")
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("DEVICE_PEAK_FLOPS", "1e9")
    monkeypatch.setenv("DEVICE_PEAK_BYTES_PER_S", "1e9")
    monkeypatch.setenv("DEVICE_PROFILE_DIR", str(tmp_path / "traces"))
    slo._reset_for_tests()
    port = create_app(database_url=f"sqlite:///{tmp_path}/p.db",
                      broker_url=f"sqlite:///{tmp_path}/pq.db")
    jax_app = jax_create_app(database_url=f"sqlite:///{tmp_path}/j.db",
                             broker_url=f"sqlite:///{tmp_path}/jq.db")
    with TestClient(port) as tc, JaxClient(jax_app) as jc:
        yield tc, jc
    compile_sentinel.uninstall()
    jax_sentinel.uninstall()
    slo._reset_for_tests()


def test_admin_profile_writes_a_trace_and_answers_as_jax(both_apps, monkeypatch):
    tc, jc = both_apps
    r = tc.post("/admin/profile", json={"duration_s": 0.05})
    assert r.status_code == 200, r.text
    body = r.json()
    assert body["duration_s"] == 0.05 and os.path.isdir(body["trace_dir"])
    with open(body["trace_file"]) as f:
        assert json.load(f)["traceEvents"]
    assert "Perfetto" in body["hint"] and "tensorboard" not in body["hint"]
    assert body["device_memory"] is None  # the CPU has no memory stats
    assert metrics.device_profile_active.get() == 0
    assert jc.post("/admin/profile", json={"duration_s": 0.05}).status_code == 200
    # single-flight: a capture in flight turns a second request away
    for c in (tc, jc):
        prof = c.app.state["profiler"]
        assert prof._lock.acquire(blocking=False)
        try:
            assert c.post("/admin/profile", json={}).status_code == 409
        finally:
            prof._lock.release()
    # the duration bound, and a body that is not an object
    for bad in ({"duration_s": config.device_profile_max_s() + 1}, {"duration_s": 0},
                {"duration_s": "soon"}, [1]):
        assert tc.post("/admin/profile", json=bad).status_code == \
            jc.post("/admin/profile", json=bad).status_code == 422
    # the admin gate
    monkeypatch.setenv("ADMIN_TOKEN", "sekret")
    for headers in ({}, {"X-Admin-Token": "wrong"}, {"Authorization": "Bearer nope"}):
        assert tc.post("/admin/profile", json={}, headers=headers).status_code == \
            jc.post("/admin/profile", json={}, headers=headers).status_code == 401
    ok = {"duration_s": 0.05}
    assert tc.post("/admin/profile", json=ok,
                   headers={"X-Admin-Token": "sekret"}).status_code == 200
    assert tc.post("/admin/profile", json=ok,
                   headers={"Authorization": "Bearer sekret"}).status_code == 200


def test_a_failing_profiler_answers_5xx(both_apps, monkeypatch):
    tc, _ = both_apps

    def broken(log_dir):
        raise RuntimeError("profiler unavailable here")

    monkeypatch.setattr(profiling, "_start", broken)
    r = tc.post("/admin/profile", json={"duration_s": 0.05})
    assert r.status_code >= 500
    assert metrics.device_profile_active.get() == 0
    assert not tc.app.state["profiler"].busy


# -- annotate -----------------------------------------------------------------

def test_annotate_is_the_shared_null_outside_a_trace_and_live_inside(tmp_path):
    null = profiling.annotate("idle")
    assert null is profiling.annotate("other") and isinstance(null, profiling._NullAnnotation)
    with profiling.device_trace(str(tmp_path / "t")):
        cm = profiling.annotate("inside")
        assert not isinstance(cm, profiling._NullAnnotation)
        with cm:
            torch.ones(4).sum()
    assert isinstance(profiling.annotate("idle2"), profiling._NullAnnotation)
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "inside" in names
    # a torch.profiler.profile the caller started itself
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cm = profiling.annotate("raw-region")
        assert not isinstance(cm, profiling._NullAnnotation)
        with cm:
            torch.ones(4).sum()
    assert isinstance(profiling.annotate("idle3"), profiling._NullAnnotation)


def test_device_trace_sees_another_threads_ranges(tmp_path):
    """The micro-batcher's executor thread annotates; a capture started on
    a request thread must see its ranges."""
    stop = threading.Event()

    def flushes():
        while not stop.is_set():
            with profiling.annotate("microbatch-score"):
                torch.ones(64).sum()
            stop.wait(0.002)

    with profiling.device_trace(str(tmp_path / "t")):
        t = threading.Thread(target=flushes)
        t.start()
        stop.wait(0.2)
        stop.set()
        t.join(10)
    assert not t.is_alive()
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "microbatch-score" in names


def test_device_trace_never_raises_out_of_a_profiler_failure(tmp_path, monkeypatch):
    def broken(log_dir):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(profiling, "_start", broken)
    with profiling.device_trace(str(tmp_path / "t")) as d:
        assert d == str(tmp_path / "t")
    assert profiling.save_device_memory_profile(str(tmp_path / "m.pickle")) is False


# -- JSON logs ----------------------------------------------------------------

def test_json_log_lines_parse_to_the_jax_fields():
    record = logging.LogRecord("fraud.api", logging.WARNING, __file__, 7,
                               "scored %d rows", (3,), None)
    record.correlation_id = "c-1"
    record.rows = np.int64(3)  # not JSON: both repr it
    record._private = "hidden"
    got = json.loads(JsonFormatter().format(record))
    want = json.loads(JaxJsonFormatter().format(record))
    assert got == want
    assert got["message"] == "scored 3 rows" and got["correlation_id"] == "c-1"
    assert "_private" not in got and got["level"] == "WARNING"
    try:
        raise ValueError("boom")
    except ValueError:
        import sys

        record.exc_info = sys.exc_info()
    assert json.loads(JsonFormatter().format(record))["exc"] == \
        json.loads(JaxJsonFormatter().format(record))["exc"]


def test_setup_json_logging_replaces_the_formatter_once(monkeypatch):
    from fraud_detection_tpu_torch.utils.jsonlog import setup_json_logging

    stream = io.StringIO()
    logger = logging.getLogger("fraud_detection_tpu_torch.test_jsonlog")
    handler = logging.StreamHandler(stream)
    logger.addHandler(handler)
    try:
        setup_json_logging(root="fraud_detection_tpu_torch.test_jsonlog")
        setup_json_logging(root="fraud_detection_tpu_torch.test_jsonlog")
        assert len(logger.handlers) == 1 and logger.propagate is False
        logger.info("hello", extra={"correlation_id": "z"})
        line = json.loads(stream.getvalue().strip())
        assert line["message"] == "hello" and line["correlation_id"] == "z"
    finally:
        logger.removeHandler(handler)
        logger.propagate = True
        with contextlib.suppress(Exception):
            logger.setLevel(logging.NOTSET)
