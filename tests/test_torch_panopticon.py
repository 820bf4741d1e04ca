"""The port's SLO engine (``telemetry/slo.py``), the binary lane's trace
propagation and the roofline (``telemetry/roofline.py``) against the JAX
package's — the single-shard cases of its ``test_panopticon.py``: the burn
rates, budgets and ``fast_burn`` on one event sequence and clock, the lane
gauges from the declaration, injected 503s moving the json lane in both
apps, the frame's traceparent, a traced socket frame's spans,
``classify_program`` and ``audit`` on a grid with pinned peaks, the
utilization gauge of a warmed fused flush on the CPU, and the
shape-derived costs against a hand count."""

import asyncio
import contextlib
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import fraud_detection_tpu.service.tracing as jax_tracing
from fraud_detection_tpu.service import metrics as jax_metrics
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.telemetry import compile_sentinel as jax_sentinel
from fraud_detection_tpu.telemetry import roofline as jax_roofline
from fraud_detection_tpu.telemetry import slo as jax_slo
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.monitor import drift
from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile
from fraud_detection_tpu_torch.monitor.watchtower import Watchtower
from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear
from fraud_detection_tpu_torch.service import binlane, metrics, tracing
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import TestClient
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher
from fraud_detection_tpu_torch.telemetry import compile_sentinel, roofline, slo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 30
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


@pytest.fixture(scope="module")
def data():
    return (np.random.default_rng(11).standard_normal((1024, D)) * 1.2).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    return FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu")


@pytest.fixture()
def fresh_slo():
    slo._reset_for_tests()
    jax_slo._reset_for_tests()
    yield
    slo._reset_for_tests()
    jax_slo._reset_for_tests()


@pytest.fixture()
def fresh_roofline():
    roofline._reset_for_tests()
    jax_roofline._reset_for_tests()
    yield
    roofline._reset_for_tests()
    jax_roofline._reset_for_tests()


def _engines(clock, **kw):
    now = lambda: clock["t"]  # noqa: E731
    return (slo.SLOEngine(now_fn=now, **kw), jax_slo.SLOEngine(now_fn=now, **kw))


# -- the SLO engine -------------------------------------------------------------

def test_slo_burn_rate_math_and_windows_match_jax(fresh_slo):
    """Burn = (bad/total)/(1 − objective) a window; old evidence drains out
    of the short windows and stays in the long one — equal, snapshot for
    snapshot, to the JAX engine fed the same events on the same clock."""
    clock = {"t": 1000.0}
    eng, jeng = _engines(clock, windows={"5m": 300.0, "1h": 3600.0, "6h": 21600.0},
                         bucket_s=10.0)
    rng = np.random.default_rng(2)
    for step in range(40):
        for _ in range(int(rng.integers(0, 30))):
            lane = ("json", "binary")[int(rng.integers(0, 2))]
            ok = bool(rng.random() > 0.1)
            dur = (None, 0.01, 0.3)[int(rng.integers(0, 3))]  # None: no latency
            for e in (eng, jeng):
                e.record(lane, ok, dur)
        clock["t"] += float(rng.choice([1.0, 45.0, 400.0]))
        assert eng.snapshot() == jeng.snapshot(), step
    snap = eng.snapshot()["availability:json"]
    assert snap["objective"] == pytest.approx(0.999)
    # the exact JAX case: 90 good + 10 bad → burn 100 on every window
    clock["t"] += 30000.0
    eng2, jeng2 = _engines(clock)
    for i in range(100):
        eng2.record("json", i % 10 != 0)
        jeng2.record("json", i % 10 != 0)
    s = eng2.snapshot()["availability:json"]
    assert s == jeng2.snapshot()["availability:json"]
    assert s["burn_rate"]["5m"] == pytest.approx(100.0)
    assert s["budget_remaining"] == pytest.approx(-99.0)
    clock["t"] += 600.0
    for e in (eng2, jeng2):
        for _ in range(50):
            e.record("json", True)
    s = eng2.snapshot()["availability:json"]
    assert s == jeng2.snapshot()["availability:json"]
    assert s["burn_rate"]["5m"] == 0.0 and s["burn_rate"]["6h"] > 0.0


def test_slo_latency_objective_counts_slow_requests_like_jax(fresh_slo):
    clock = {"t": 50.0}
    eng, jeng = _engines(clock, latency_threshold_s=0.1)
    for e in (eng, jeng):
        for _ in range(90):
            e.record("binary", True, 0.01)
        for _ in range(10):
            e.record("binary", True, 0.5)  # over the threshold: slow, not bad
    snap = eng.snapshot()
    assert snap == jeng.snapshot()
    assert snap["availability:binary"]["burn_rate"]["5m"] == 0.0
    assert snap["latency:binary"]["burn_rate"]["5m"] == pytest.approx(10.0)
    for e in (eng, jeng):  # a failed request never double-bills latency
        e.record("binary", False, 9.9)
    assert eng.snapshot() == jeng.snapshot()
    assert eng.snapshot()["latency:binary"]["window_bad"] == 10


def test_slo_fast_burn_and_objective_override_like_jax(fresh_slo, monkeypatch):
    monkeypatch.setenv("SLO_AVAILABILITY_OBJECTIVE_JSON", "0.9")
    clock = {"t": 0.0}
    eng, jeng = _engines(clock)
    for e in (eng, jeng):
        for _ in range(10):
            e.record("json", False)
    snap = eng.snapshot()["availability:json"]
    assert snap == jeng.snapshot()["availability:json"]
    assert snap["objective"] == pytest.approx(0.9)
    assert snap["burn_rate"]["5m"] == pytest.approx(10.0)
    assert eng.fast_burn("json") is jeng.fast_burn("json") is False  # 10 < 14.4
    monkeypatch.setenv("SLO_FAST_BURN", "5")
    assert eng.fast_burn("json") is jeng.fast_burn("json") is True
    assert eng.fast_burn("msgpack") is jeng.fast_burn("msgpack") is False


def test_slo_gauges_exist_per_lane_from_the_declaration(fresh_slo):
    eng, jeng = slo.SLOEngine(), jax_slo.SLOEngine()
    for e in (eng, jeng):
        e.declare_lanes()
        e.export_gauges()
    text = metrics.render().decode()
    from prometheus_client import generate_latest

    jtext = generate_latest(jax_metrics.registry).decode()
    for lane in ("json", "msgpack", "binary"):
        for series in (f'slo_burn_rate{{slo="availability:{lane}",window="5m"}}',
                       f'slo_error_budget_remaining{{slo="availability:{lane}"}}',
                       f'slo_burn_rate{{slo="latency:{lane}",window="6h"}}'):
            assert series in text and series in jtext, series
    assert eng.snapshot() == jeng.snapshot()


def test_injected_503s_move_the_json_lane_slo_in_both_apps(fresh_slo, tmp_path, monkeypatch):
    """A model-less deployment answers 503 on /predict: the json lane's
    availability burn rises and its budget drops, in both apps."""
    monkeypatch.setenv("REQUIRE_REGISTRY_MODEL", "1")
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DEVICE", "cpu")
    apps = (
        TestClient(create_app(database_url=f"sqlite:///{tmp_path}/p.db",
                              broker_url=f"sqlite:///{tmp_path}/pq.db")),
        JaxClient(jax_create_app(database_url=f"sqlite:///{tmp_path}/j.db",
                                 broker_url=f"sqlite:///{tmp_path}/jq.db")),
    )
    bodies = []
    try:
        for c in apps:
            body = c.get("/slo/status").json()
            assert body["enabled"] is True
            avail = body["slos"]["availability:json"]
            assert avail["burn_rate"]["5m"] == 0.0
            before = avail["budget_remaining"]
            for _ in range(5):
                assert c.post("/predict", json={"features": [0.1] * D}).status_code == 503
            # unservable before the row is parsed: a sixth 503
            assert c.post("/predict", json={"features": [0.1]}).status_code == 503
            body = c.get("/slo/status").json()
            avail = body["slos"]["availability:json"]
            assert avail["burn_rate"]["5m"] > 0.0 and avail["budget_remaining"] < before
            text = c.get("/metrics").body.decode()
            line = next(ln for ln in text.splitlines() if ln.startswith(
                'slo_burn_rate{slo="availability:json",window="5m"}'))
            assert float(line.rsplit(" ", 1)[1]) > 0.0
            bodies.append(body)
    finally:
        for c in apps:
            c.close()
        compile_sentinel.uninstall()
        jax_sentinel.uninstall()
    port, jax_body = bodies
    assert set(port) == set(jax_body)
    assert port["slos"]["availability:json"]["total_bad"] == \
        jax_body["slos"]["availability:json"]["total_bad"] == 6
    assert {k: port[k] for k in ("latency_threshold_s", "windows", "fast_burn_threshold",
                                  "slow_burn_threshold")} == \
        {k: jax_body[k] for k in ("latency_threshold_s", "windows", "fast_burn_threshold",
                                  "slow_burn_threshold")}
    assert set(port["roofline"]) == set(jax_body["roofline"])


def test_slo_disabled_answers_like_jax(fresh_slo, tmp_path, monkeypatch):
    monkeypatch.setenv("SLO_ENABLED", "0")
    monkeypatch.setenv("REQUIRE_REGISTRY_MODEL", "1")
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DEVICE", "cpu")
    assert slo.engine() is None
    slo.record_lane("json", False)  # a no-op, as in JAX
    with TestClient(create_app(database_url=f"sqlite:///{tmp_path}/p.db",
                               broker_url=f"sqlite:///{tmp_path}/pq.db")) as tc, \
            JaxClient(jax_create_app(database_url=f"sqlite:///{tmp_path}/j.db",
                                     broker_url=f"sqlite:///{tmp_path}/jq.db")) as jc:
        assert tc.get("/slo/status").json() == jc.get("/slo/status").json() == {
            "enabled": False, "slos": {}}
    compile_sentinel.uninstall()
    jax_sentinel.uninstall()


# -- the binary lane's trace propagation ---------------------------------------------

def test_frame_traceparent_roundtrip_and_malformed_degrades(model, data):
    scorer = model.scorer
    body = binlane.encode_frame(data[:5], length_prefix=False, traceparent=TRACEPARENT)
    slot, n, _, tp = binlane.decode_frame_body(scorer, body, max_rows=64)
    try:
        assert n == 5 and tp == TRACEPARENT
    finally:
        scorer.staging.release(slot)
    bad = bytearray(body)
    bad[-binlane.TRACE_LEN:] = b"not-a-traceparent".ljust(binlane.TRACE_LEN, b"\0")
    slot, n, _, tp = binlane.decode_frame_body(scorer, bytes(bad), max_rows=64)
    try:
        assert n == 5 and tp is None
    finally:
        scorer.staging.release(slot)


class _StubSpan:
    def __init__(self, name, span_id, start_time=None):
        self.name = name
        self.attributes = {}
        self._ctx = type("Ctx", (), {"trace_id": 0xABC, "span_id": span_id,
                                     "trace_flags": 1})()

    def set_attribute(self, k, v):
        self.attributes[k] = v

    def get_span_context(self):
        return self._ctx

    def end(self, end_time=None):
        pass


class _StubTracer:
    def __init__(self):
        self.spans = []

    def _new(self, name, start_time=None):
        s = _StubSpan(name, len(self.spans) + 1, start_time)
        self.spans.append(s)
        return s

    @contextlib.contextmanager
    def start_as_current_span(self, name, **kw):
        yield self._new(name)

    def start_span(self, name, start_time=None, **kw):
        return self._new(name, start_time)


class _LoopThread:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def call(self, coro, timeout=60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._t.join(timeout=5.0)


def test_socket_frame_with_traceparent_links_server_spans(fresh_slo, model, data, monkeypatch):
    """A socket-lane frame carrying a traceparent opens an ``ingest.frame``
    span linked to the client's trace with the stages as children, and the
    binary lane's SLO counts it good — as in JAX's lane."""
    stub = _StubTracer()
    monkeypatch.setattr(tracing, "_tracer", stub)
    monkeypatch.setattr(tracing, "_initialized", True)
    scorer = model.scorer
    lt = _LoopThread()
    mb = MicroBatcher(scorer, max_batch=128, max_wait_ms=1.0, telemetry=True,
                      fused=False, explain=False)
    lt.call(mb.start())
    srv = binlane.BinaryIngestServer(mb, scorer_fn=lambda: scorer, host="127.0.0.1",
                                     port=0, max_rows=128, stall_timeout=2.0)
    srv.start(lt.loop)
    try:
        with binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
            scores, _ = cli.score_batch(data[:8], traceparent=TRACEPARENT)
            assert scores.shape == (8,)
        deadline = time.monotonic() + 5.0
        frames = []
        while time.monotonic() < deadline and not frames:
            frames = [s for s in stub.spans if s.name == "ingest.frame"]
            time.sleep(0.02)
        assert frames, "no ingest.frame span emitted"
        assert frames[0].attributes == {"trace.parent": TRACEPARENT, "lane": "binary",
                                        "rows": 8}
        assert {s.name for s in stub.spans if s.name.startswith("stage:")} >= {
            "stage:device_compute", "stage:respond"}
        snap = slo.engine().snapshot()["availability:binary"]
        assert snap["total_good"] >= 1 and snap["total_bad"] == 0
    finally:
        srv.stop()
        lt.call(mb.stop())
        lt.close()


# -- the roofline ---------------------------------------------------------------

def _small_flush_args(n=8, d=4, fb=5, sb=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    window = drift.init_window(d, fb, sb)
    x = torch.randn(n, d, generator=g)
    valid = torch.ones(n)
    fe = torch.sort(torch.randn(d, fb - 1, generator=g), dim=1).values
    se = torch.linspace(0.1, 0.9, sb - 1)
    return (window, x, valid, 1.0, fe, se, (torch.randn(d, generator=g), torch.tensor(-1.0)))


def test_roofline_capture_and_utilization_unit(fresh_roofline, monkeypatch):
    monkeypatch.setenv("DEVICE_PEAK_FLOPS", "1e9")
    assert roofline.ensure_peak() == pytest.approx(1e9)
    assert metrics.device_peak_flops_estimate.get() == pytest.approx(1e9)
    wrapped = compile_sentinel.instrument("fastlane.flush", drift._fused_flush)
    args = _small_flush_args()
    wrapped(*args, score_fn=_raw_score_linear)  # the first dispatch of (entrypoint, 8)
    want = roofline.flush_cost(8, 4, feature_bins=5, score_bins=6)
    assert roofline.snapshot()["programs"]["fastlane.flush@8"] == {
        "flops": want[0], "bytes": want[1]}
    assert metrics.device_program_flops.get("fastlane.flush") == want[0]
    wrapped(*args, score_fn=_raw_score_linear)
    roofline.note_device_time(0.01)
    util = metrics.device_utilization_fraction.get("fastlane.flush")
    assert util == pytest.approx(want[0] / 0.01 / 1e9)
    # the EWMA: a second flush moves it a fifth of the way
    wrapped(*args, score_fn=_raw_score_linear)
    roofline.note_device_time(0.02)
    assert metrics.device_utilization_fraction.get("fastlane.flush") == pytest.approx(
        util + 0.2 * (want[0] / 0.02 / 1e9 - util))
    # a dequant scale relabels the int8 wire's call as JAX does
    wrapped(*args, score_fn=_raw_score_linear, dequant_scale=torch.ones(4))
    assert "quickwire.flush@8" in roofline.snapshot()["programs"]
    # the pairing is one-shot and per thread
    roofline.note_device_time(0.01)
    roofline.note_device_time(0.01)
    assert roofline.snapshot()["utilization"]["fastlane.flush"] == pytest.approx(
        util + 0.2 * (want[0] / 0.02 / 1e9 - util))


def test_roofline_off_notes_nothing(fresh_roofline, monkeypatch):
    monkeypatch.setenv("ROOFLINE_ENABLED", "0")
    wrapped = compile_sentinel.instrument("fastlane.flush", drift._fused_flush)
    wrapped(*_small_flush_args(), score_fn=_raw_score_linear)
    roofline.note_device_time(0.01)
    assert roofline.snapshot()["programs"] == {} and roofline.snapshot()["utilization"] == {}


def test_roofline_exports_utilization_for_a_warmed_fused_flush(
        fresh_slo, fresh_roofline, model, data, monkeypatch):
    """The acceptance bar on the CPU: under fused traffic the warmed flush
    exports a finite, nonzero utilization against pinned peaks."""
    monkeypatch.setenv("DEVICE_PEAK_FLOPS", "1e10")
    monkeypatch.setenv("DEVICE_PEAK_BYTES_PER_S", "1e10")
    compile_sentinel.install()
    scorer = model.scorer
    profile = build_baseline_profile(data, scorer.predict_proba(data),
                                     feature_names=model.feature_names, device="cpu")
    wt = Watchtower(profile, device="cpu")
    try:
        async def run():
            mb = MicroBatcher(scorer, watchtower=wt, max_batch=64, max_wait_ms=1.0,
                              telemetry=True, fused=True, explain=True, explain_k=3)
            await mb.start()
            try:
                await asyncio.gather(*(mb.score_ex(data[i]) for i in range(96)))
            finally:
                await mb.stop()

        asyncio.run(run())
        util = metrics.device_utilization_fraction.get("lantern.flush")
        assert np.isfinite(util) and util > 0.0
        snap = roofline.snapshot()
        assert snap["peak_flops"] == pytest.approx(1e10)
        assert snap["peak_bytes_per_s"] == pytest.approx(1e10)
        progs = {k: v for k, v in snap["programs"].items() if k.startswith("lantern.flush@")}
        assert progs  # every warmed bucket's costs, taken at its first dispatch
        for key, cost in progs.items():
            b = int(key.split("@")[1])
            assert (cost["flops"], cost["bytes"]) == roofline.flush_cost(
                b, D, feature_bins=profile.feature_edges.shape[1] + 1,
                score_bins=profile.score_edges.shape[0] + 1, explain_k=3)
        rep = roofline.audit()
        assert rep["programs"].keys() == snap["programs"].keys()
        assert any(p["verdict"] != "unmeasured" for p in rep["programs"].values())
    finally:
        wt.drain()
        wt.close()
        compile_sentinel.uninstall()


@pytest.mark.parametrize("flops, nbytes, seconds", [
    (1e9, 1e9, 1.0), (1e9, 1e9, 1e-2), (1e11, 1e9, None), (0.0, 0.0, 1.0),
    (5e8, 2e9, 0.5), (3e10, 1e8, 0.03), (2e9, 2e8, 1e-3), (1e9, 1e8, None),
])
@pytest.mark.parametrize("peak, bw", [(1e12, 1e11), (6.7e13, 3.35e12)])
def test_classify_program_matches_jax(flops, nbytes, seconds, peak, bw):
    got = roofline.classify_program(flops, nbytes, seconds, peak_flops=peak,
                                    peak_bytes_per_s=bw)
    assert got == jax_roofline.classify_program(flops, nbytes, seconds, peak_flops=peak,
                                                peak_bytes_per_s=bw)
    assert got["verdict"] in ("kernel-candidate", "compiler-wins", "unmeasured")
    assert roofline.KERNEL_CANDIDATE_SLACK == jax_roofline.KERNEL_CANDIDATE_SLACK == 0.6


def test_audit_matches_jax_on_pinned_peaks(fresh_roofline, monkeypatch):
    monkeypatch.setenv("DEVICE_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DEVICE_PEAK_BYTES_PER_S", "1e11")
    costs = {("x.flush", 1024): {"flops": 1e9, "bytes": 1e9},
             ("cold.flush", 256): {"flops": 1e9, "bytes": 1e8},
             ("y.flush", 64): {"flops": 4e7, "bytes": 1e6}}
    util = {"x.flush": 1e-3, "y.flush": 0.5}
    for mod in (roofline, jax_roofline):
        with mod._lock:
            mod._costs.update(costs)
            mod._util.update(util)
    rep = roofline.audit()
    assert rep == jax_roofline.audit()
    assert rep["programs"]["x.flush@1024"]["verdict"] == "kernel-candidate"
    assert rep["programs"]["cold.flush@256"]["verdict"] == "unmeasured"
    assert roofline.ensure_membw() == jax_roofline.ensure_membw() == pytest.approx(1e11)


def test_the_probes_measure_on_the_cpu_at_a_small_size(fresh_roofline):
    assert roofline.peak_flops_probe("cpu", n=64, reps=2) > 0.0
    assert roofline.membw_probe("cpu", elems=1 << 16, reps=2) > 0.0
    assert roofline.ensure_peak("cpu", n=64) > 0.0
    assert roofline.snapshot()["peak_flops"] == metrics.device_peak_flops_estimate.get()


# -- shape-derived costs against a hand count -----------------------------------------

def test_flush_costs_equal_a_hand_count():
    # the linear flush with explain: n 8, d 30, 10 feature bins, 20 score
    # bins, k 3, f32 rows and return wire
    ops = (2 * 8 * 30 + 4 * 8          # the score: a multiply-add an element, 4 a row
           + 8 * 30                    # linear SHAP: one an element
           + 8 * 30 * 10 + 8 * 20      # the histograms: compares and adds
           + 2 * (30 * 10 + 20 + 1))   # the window's decay fold
    nbytes = (4 * 8 * 30 + 4 * 8       # rows, valid mask
              + 4 * 30 + 4             # coef, intercept
              + 4 * 30                 # background mean
              + 8 * 3 * (1 + 4)        # reason codes: u8 index, f32 value
              + 2 * 4 * (30 * 10 + 20 + 1)         # the window read and written
              + 4 * (30 * 9 + 19)      # the edges
              + 4 * 8)                 # scores
    assert roofline.flush_cost(8, 30, feature_bins=10, score_bins=20, explain_k=3) == (
        float(ops), float(nbytes))
    # the forest on the int8 wire with TreeSHAP: n 1024, 100 trees of depth
    # 5 over 256 bins, k 3, a u8 return wire
    n, t, dep = 1024, 100, 5
    ops = (n * 30                            # dequant
           + n * t * (dep + 1) + 4 * n       # the walk and the sigmoid
           + 2 * n * t * 32 * dep            # TreeSHAP: L·D compares and adds
           + n * 30 * 10 + n * 20 + 2 * (30 * 10 + 20 + 1))
    nbytes = (n * 30 + 4 * n + 4 * 30        # codes, valid, scale
              + t * (8 * 31 + 4 * 32) + 4 * 30 * 255 + 4   # the forest and its edges
              + n * 3 * (1 + 2)              # u8 index, f16 value
              + 2 * 4 * (30 * 10 + 20 + 1) + 4 * (30 * 9 + 19)
              + n)                           # u8 scores
    assert roofline.flush_cost(n, 30, feature_bins=10, score_bins=20, elem_bytes=1,
                               out_bytes=1, explain_k=3, forest=(t, dep, 256),
                               dequant=True) == (float(ops), float(nbytes))
    # the kernels' shared terms
    assert roofline.fused_score_cost(1024, 30) == (2 * 1024 * 30 + 4 * 1024,
                                                   4 * 1024 * 30 + 4 * 30 + 4 + 4 * 1024)
    assert roofline.tree_shap_ops(1024, 100, 5) == 2 * 1024 * 100 * 32 * 5


def test_program_cost_reads_a_flush_call():
    args = _small_flush_args(n=16, d=4, fb=5, sb=6)
    assert roofline.program_cost("fastlane.flush", args, {"score_fn": None}) == \
        roofline.flush_cost(16, 4, feature_bins=5, score_bins=6)
    kw = {"explain_k": 2, "out_dtype": torch.float16, "dequant_scale": torch.ones(4)}
    codes = args[1].to(torch.int8)
    got = roofline.program_cost("lantern.flush", (args[0], codes) + args[2:], kw)
    assert got == roofline.flush_cost(16, 4, feature_bins=5, score_bins=6, elem_bytes=1,
                                      out_bytes=2, explain_k=2, dequant=True)
