"""spyglass on the port — ``telemetry/timeline.py``, ``FlightRecorder``
and ``GET /debug/flightrecorder`` — against the JAX package's
``telemetry`` (its ``test_telemetry.py`` cases): the six stages from the
same stamps, the ring wrapping and dumping newest first, concurrent
records, a scored request recorded with six populated stages, the disabled
body, and the flush's one fence (none with ``SPYGLASS_ENABLED=0``)."""

import asyncio
import os
import re
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.telemetry import FlightRecorder as JaxRecorder
from fraud_detection_tpu.telemetry import STAGES as JAX_STAGES
from fraud_detection_tpu.telemetry import RequestTimeline as JaxTimeline
from fraud_detection_tpu.telemetry.timeline import FlushInfo as JaxFlushInfo
from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.service import metrics, microbatch
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import TestClient
from fraud_detection_tpu_torch.service.microbatch import MicroBatcher
from fraud_detection_tpu_torch.telemetry import (
    STAGES,
    FlightRecorder,
    FlushInfo,
    RequestTimeline,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stamped(tl_cls, fi_cls, t):
    tl = tl_cls(correlation_id="c1")
    tl.t_enqueued = t
    tl.t_collected = t + 0.001
    tl.flush = fi_cls(t_flush_start=t + 0.002, t_padded=t + 0.003, t_synced=t + 0.007,
                      t_fetched=t + 0.008, batch_size=4, bucket=8)
    tl.flush.t_resolved = t + 0.009
    return tl


def test_timeline_stages_and_spans_match_jax():
    assert STAGES == JAX_STAGES
    t = time.perf_counter()
    tl = _stamped(RequestTimeline, FlushInfo, t)
    jtl = _stamped(JaxTimeline, JaxFlushInfo, t)
    stages = tl.stages()
    assert tuple(stages) == STAGES and tl.complete()
    assert stages == jtl.stages()
    assert abs(stages["device_compute"] - 0.004) < 1e-9
    assert tl.total_seconds() == jtl.total_seconds()
    assert abs(tl.total_seconds() - 0.009) < 1e-9
    spans = tl.stage_spans_ns()
    assert [s[0] for s in spans] == list(STAGES)
    for (_, _, prev_end), (_, nxt_start, _) in zip(spans, spans[1:]):
        assert abs(prev_end - nxt_start) <= 1
    rec, jrec = tl.to_record(), jtl.to_record()
    assert set(rec) == set(jrec)
    assert {k: rec[k] for k in rec if k != "ts"} == {k: jrec[k] for k in jrec if k != "ts"}


def test_timeline_incomplete_stages_read_zero():
    tl = RequestTimeline()
    assert not tl.complete()
    assert set(tl.stages().values()) == {0.0}
    assert tl.stage_spans_ns() == []


def test_flightrecorder_ring_wraps_and_dumps_newest_first_like_jax():
    rec, jrec = FlightRecorder(capacity=4), JaxRecorder(capacity=4)
    for i in range(10):
        row = (float(i), f"c{i}", 1, 8, None, None, False, 0, {}, 0.0)
        rec.record(row)
        jrec.record(row)
    assert len(rec) == len(jrec) == 4
    assert rec.total_recorded == jrec.total_recorded == 10
    assert rec.dump() == jrec.dump()
    assert [r["correlation_id"] for r in rec.dump()] == ["c9", "c8", "c7", "c6"]
    assert rec.dump(limit=2)[0]["ts"] == 9.0


def test_flightrecorder_flush_batches_wrap_like_jax():
    """Whole flushes land as one entry each; the dump reads timelines out
    of the batch items newest first, as the JAX recorder does."""
    rec, jrec = FlightRecorder(capacity=5), JaxRecorder(capacity=5)
    t = time.perf_counter()
    for f in range(4):
        batch, jbatch = [], []
        for r in range(3):
            tl = _stamped(RequestTimeline, FlushInfo, t + f)
            jtl = _stamped(JaxTimeline, JaxFlushInfo, t + f)
            tl.correlation_id = jtl.correlation_id = f"f{f}r{r}"
            batch.append((None, None, tl, None))
            jbatch.append((None, None, jtl, None))
        rec.record_flush_batch(tl.flush, batch)
        jrec.record_flush_batch(jtl.flush, jbatch)
    got, want = rec.dump(), jrec.dump()
    assert [r["correlation_id"] for r in got] == [r["correlation_id"] for r in want]
    assert [r["correlation_id"] for r in got][:3] == ["f3r2", "f3r1", "f3r0"]
    assert len(got) == 5 and rec.total_recorded == 12


def test_flightrecorder_concurrent_records():
    rec = FlightRecorder(capacity=64)

    def spam(k):
        for i in range(200):
            rec.record((time.time(), f"t{k}-{i}", 1, 8, None, None, False, 0, {}, 0.0))

    threads = [threading.Thread(target=spam, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert rec.total_recorded == 800
    assert len(rec.dump()) == 64


def test_flightrecorder_refuses_zero_capacity():
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


@pytest.fixture()
def serving_env(tmp_path, monkeypatch):
    d = str(tmp_path / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    monkeypatch.setenv("MODEL_PATH", os.path.join(d, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DATABASE_URL", f"sqlite:///{tmp_path}/fraud.db")
    monkeypatch.setenv("CELERY_BROKER_URL", f"sqlite:///{tmp_path}/taskq.db")
    monkeypatch.setenv("SCORER_MAX_BATCH", "16")
    monkeypatch.setenv("DEVICE", "cpu")
    # the flush records the process-wide drift gauge, which a drift test
    # run earlier in this process may have left at 1; this app has seen no
    # drift
    monkeypatch.setattr(metrics.watchtower_drift_detected._children[()], "value", 0.0)
    return tmp_path


def test_flightrecorder_endpoint_returns_all_six_stages(serving_env):
    with TestClient(create_app()) as tc:
        r = tc.post("/predict", json={"features": [0.3] * 30},
                    headers={"X-Correlation-ID": "fr-1"})
        assert r.status_code == 200
        body = tc.get("/debug/flightrecorder").json()
        assert body["enabled"] is True and body["shards"] == 1
        assert body["capacity"] == config.flightrecorder_capacity()
        rec = next(r_ for r_ in body["records"] if r_["correlation_id"] == "fr-1")
        assert set(rec["stages"]) == set(STAGES)
        for stage, seconds in rec["stages"].items():
            assert seconds > 0.0, f"stage {stage} not populated: {rec}"
        assert rec["batch_size"] >= 1 and rec["bucket"] >= rec["batch_size"]
        assert rec["total_s"] > 0 and rec["drift"] is False
        assert rec["model_source"].startswith("native:")
        text = tc.get("/metrics").text
        for stage in STAGES + ("parse", "admit"):
            m = re.search(
                rf'request_stage_duration_seconds_count{{stage="{stage}"}} (\d+)', text)
            assert m and int(float(m.group(1))) >= 1, stage


def test_debug_body_keys_match_jax(serving_env):
    jax_app = jax_create_app(database_url=f"sqlite:///{serving_env}/j.db",
                             broker_url=f"sqlite:///{serving_env}/jq.db")
    with JaxClient(jax_app) as jc, TestClient(create_app()) as tc:
        for c in (jc, tc):
            assert c.post("/predict", json={"features": [0.1] * 30},
                          headers={"X-Correlation-ID": "k"}).status_code == 200
        jb, tb = jc.get("/debug/flightrecorder").json(), tc.get("/debug/flightrecorder").json()
        assert set(tb) == set(jb) and tb["shards"] == jb["shards"] == 1
        assert set(tb["records"][0]) == set(jb["records"][0])
        assert set(tb["records"][0]["stages"]) == set(jb["records"][0]["stages"])
        tc.app.state["flightrecorder"] = None
        jc.app.state["flightrecorder"] = None
        assert tc.get("/debug/flightrecorder").json() == \
            jc.get("/debug/flightrecorder").json()


def test_spyglass_disabled_serves_without_stamps(serving_env, monkeypatch):
    monkeypatch.setenv("SPYGLASS_ENABLED", "0")
    fences = []
    monkeypatch.setattr(microbatch, "_fence", lambda dev: fences.append(dev))
    with TestClient(create_app()) as tc:
        r = tc.post("/predict", json={"features": [0.1] * 30})
        assert r.status_code == 200
        assert tc.app.state["batcher"].telemetry is False
        body = tc.get("/debug/flightrecorder").json()
        assert body["enabled"] is False and body["records"] == []
    assert fences == []


def _batcher(telemetry):
    model = FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu")
    return MicroBatcher(model.scorer, max_batch=16, max_wait_ms=1.0,
                        telemetry=telemetry, fused=False, explain=False)


@pytest.mark.parametrize("telemetry", [True, False])
def test_one_fence_a_flush_and_none_when_off(telemetry, monkeypatch):
    """Every flush fences once with spyglass on, never with it off, and
    its stamps are ordered."""
    fences = []
    monkeypatch.setattr(microbatch, "_fence", lambda dev: fences.append(dev))
    mb = _batcher(telemetry)
    x = np.random.default_rng(0).standard_normal((40, 30)).astype(np.float32)
    n_flushes0 = metrics.microbatch_size._children[()].count

    async def go():
        await mb.start()
        try:
            for lo in range(0, 40, 10):
                await asyncio.gather(*(mb.score(x[i]) for i in range(lo, lo + 10)))
        finally:
            await mb.stop()

    asyncio.run(go())
    flushes = metrics.microbatch_size._children[()].count - n_flushes0
    assert flushes >= 4
    assert len(fences) == (flushes if telemetry else 0)
    res = mb._flush_device(mb.scorer, None, [(x[i], None) for i in range(5)], telemetry)
    mb.scorer.staging.release(res[-1])
    stamps = res[-2]
    if telemetry:
        assert list(stamps) == sorted(stamps) and stamps[0] > 0
    else:
        assert stamps is None
