"""The binary ingest lane and ``POST /ingest/batch`` on the port, against
the JAX package's ``service/binlane.py``: frames and responses byte-equal
between the two encoders and decoded by either package, the JAX lane's
fuzz cases (oversized, poisoned, mis-sized, truncated and stalled frames),
the micro-batcher counting block rows (one flush a full block, ``max_batch``
a hard bound, rows in ``microbatch_size`` and admission), socket scores
bitwise the port's ``/predict`` with no staging allocation in steady
state, and the slice as a whole: one app per package on the committed
``models/model.npz``, the same 256 rows through ``/ingest/batch``."""

import asyncio
import os
import shutil
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu.service import binlane as jax_binlane
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import Request as JaxRequest
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.service.microbatch import IngestBlock as JaxBlock
from fraud_detection_tpu.service.microbatch import MicroBatcher as JaxBatcher
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.ops.scorer import _bucket
from fraud_detection_tpu_torch.service import binlane, metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import Request, TestClient
from fraud_detection_tpu_torch.service.microbatch import (
    AdmissionFull,
    IngestBlock,
    MicroBatcher,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 30


@pytest.fixture(scope="module")
def data():
    x = np.loadtxt(os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
                   skiprows=1, max_rows=2048, dtype=np.float32)
    return np.ascontiguousarray(x[:, :D])


@pytest.fixture(scope="module")
def model():
    return FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu")


@pytest.fixture(scope="module")
def scorer(model):
    return model.scorer


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel.load(os.path.join(ROOT, "models"))


class _LoopThread:
    """A background event loop the sync test code schedules batcher work
    onto, the shape the HTTP server gives the lane."""

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


def _lane(scorer, model=None, telemetry=False, max_batch=128, **kw):
    lt = _LoopThread()
    mb = MicroBatcher(scorer, max_batch=max_batch, max_wait_ms=1.0,
                      telemetry=telemetry, fused=False, explain=False, **kw)
    lt.call(mb.start())
    srv = binlane.BinaryIngestServer(mb, scorer_fn=lambda: scorer, model=model,
                                     host="127.0.0.1", port=0, max_rows=max_batch,
                                     stall_timeout=0.4)
    srv.start(lt.loop)
    return lt, mb, srv


def _close(lt, mb, srv):
    srv.stop()
    lt.call(mb.stop())
    lt.close()
    assert not srv._threads and not srv._accept_thread.is_alive()


@pytest.fixture()
def lane(scorer, model):
    lt, mb, srv = _lane(scorer, model)
    yield lt, mb, srv
    _close(lt, mb, srv)


# -- the wire contract against the JAX package --------------------------------


FRAME_CASES = {
    "f32": {},
    "f32_no_prefix": {"length_prefix": False},
    "entities_ts": {"entity_fps": np.arange(1, 6, dtype=np.uint32) * 977,
                    "timestamps": np.linspace(1e9, 1e9 + 4, 5)},
    "trace": {"traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"},
    "int8": {"layout": 2},
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frames_are_byte_equal_to_jax(case, data, model):
    kw = dict(FRAME_CASES[case])
    if kw.get("layout") == 2:
        kw["scale"] = binlane.ingest_dequant_scale(model)
    rows = data[:5]
    assert binlane.encode_frame(rows, **kw) == jax_binlane.encode_frame(rows, **kw)


def test_each_package_decodes_the_others_frames(data, scorer, jax_model):
    rows = data[:11]
    jax_frame = jax_binlane.encode_frame(rows, length_prefix=False)
    slot, n, entity, trace = binlane.decode_frame_body(scorer, jax_frame, max_rows=64)
    try:
        assert (n, entity, trace) == (11, None, None)
        assert slot.f32[:11].tobytes() == rows.tobytes()
    finally:
        scorer.staging.release(slot)
    port_frame = binlane.encode_frame(rows, length_prefix=False)
    jscorer = jax_model.scorer
    jslot, jn, _, _ = jax_binlane.decode_frame_body(jscorer, port_frame, max_rows=64)
    try:
        assert jn == 11 and jslot.f32[:11].tobytes() == rows.tobytes()
    finally:
        jscorer.staging.release(jslot)


def test_int8_dequant_scale_and_decode_match_jax(data, model, scorer, jax_model):
    scale = binlane.ingest_dequant_scale(model)
    np.testing.assert_array_equal(scale, jax_binlane.ingest_dequant_scale(jax_model))
    body = binlane.encode_frame(data[:9], scale=scale, layout=2, length_prefix=False)
    slot, n, _, _ = binlane.decode_frame_body(scorer, body, 64, dequant=scale)
    jslot, _, _, _ = jax_binlane.decode_frame_body(jax_model.scorer, body, 64,
                                                   dequant=scale)
    try:
        assert slot.f32[:9].tobytes() == jslot.f32[:9].tobytes()
    finally:
        scorer.staging.release(slot)
        jax_model.scorer.staging.release(jslot)


@pytest.mark.parametrize("ek", [0, 3])
def test_responses_decode_across_packages(ek, scorer):
    slot = scorer.staging.acquire(8)
    try:
        slot.scores[:5] = np.linspace(0.1, 0.9, 5, dtype=np.float32)
        if ek:
            slot.ensure_explain(ek)
            slot.ei[:5] = np.arange(15).reshape(5, 3)
            slot.ev[:5] = np.linspace(-1, 1, 15, dtype=np.float32).reshape(5, 3)
        body = binlane.encode_response_body(slot, 5, ek)
        for decode in (binlane.decode_response_body, jax_binlane.decode_response_body):
            scores, reasons = decode(body)
            assert scores.tobytes() == slot.scores[:5].tobytes()
            if ek:
                assert reasons[0].tolist() == slot.ei[:5].tolist()
                assert reasons[1].tobytes() == slot.ev[:5].tobytes()
            else:
                assert reasons is None
    finally:
        scorer.staging.release(slot)
    for status, msg, retry in ((1, "bad", 0.0), (2, "busy", 1.5), (3, "down", 4.0)):
        assert binlane.error_frame(status, msg, retry) == \
            jax_binlane.error_frame(status, msg, retry)


def test_header_checks_match_jax(data, scorer, jax_model):
    body = binlane.encode_frame(data[:4], length_prefix=False)
    bad = {
        "magic": b"\xde\xad" + body[2:],
        "version": body[:2] + b"\x63" + body[3:],
        "layout": body[:3] + b"\x07" + body[4:],
        "flags": body[:6] + b"\x80" + body[7:],
        "size": body[:-4],
        "rows": binlane.encode_frame(data[:65], length_prefix=False),
        "width": binlane.encode_frame(data[:4, :29], length_prefix=False),
    }
    for kind, b in bad.items():
        with pytest.raises(binlane.FrameError) as pe:
            binlane.decode_frame_body(scorer, b, max_rows=64)
        with pytest.raises(jax_binlane.FrameError) as je:
            jax_binlane.decode_frame_body(jax_model.scorer, b, max_rows=64)
        assert pe.value.kind == je.value.kind == kind
        assert str(pe.value) == str(je.value)


def test_block_from_arrays_matches_frame_decode(scorer, data):
    rows = data[:11]
    slot_a, n_a, ent_a = binlane.block_from_arrays(scorer, rows, max_rows=64)
    slot_b, n_b, ent_b, _ = binlane.decode_frame_body(
        scorer, binlane.encode_frame(rows, length_prefix=False), max_rows=64)
    try:
        assert n_a == n_b == 11 and ent_a is None and ent_b is None
        assert slot_a.f32[:11].tobytes() == slot_b.f32[:11].tobytes()
    finally:
        scorer.staging.release(slot_a)
        scorer.staging.release(slot_b)
    bad = rows.copy()
    bad[0, 0] = np.inf
    with pytest.raises(binlane.FrameError, match="non-finite"):
        binlane.block_from_arrays(scorer, bad, max_rows=64)


# -- the socket lane ----------------------------------------------------------


def test_socket_scores_bitwise_predict_and_zero_alloc(lane, scorer, data):
    _, _, srv = lane
    rows = data[:64]
    ref = scorer.predict_proba(rows).astype(np.float32)
    with binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
        assert cli.d == D and cli.scale is not None
        scores, reasons = cli.score_batch(rows)
        assert reasons is None and scores.tobytes() == ref.tobytes()
        for _ in range(3):  # settle the pool
            cli.score_batch(rows)
        before = scorer.staging.allocations
        for _ in range(16):
            s, _ = cli.score_batch(rows)
            assert s.tobytes() == ref.tobytes()
        assert scorer.staging.allocations == before


def test_jax_client_talks_to_the_port_lane(lane, scorer, data):
    _, _, srv = lane
    rows = data[:32]
    with jax_binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
        scores, _ = cli.score_batch(rows)
        assert scores.tobytes() == scorer.predict_proba(rows).astype(np.float32).tobytes()
        q, _ = cli.score_batch(rows, layout=jax_binlane.LAYOUT_INT8)
        assert np.abs(q - scores).max() <= 5e-2


def _drain_hello(sock):
    hdr = b""
    while len(hdr) < 4:
        hdr += sock.recv(4 - len(hdr))
    (ln,) = struct.unpack(">I", hdr)
    got = b""
    while len(got) < ln:
        got += sock.recv(ln - len(got))


def test_fuzz_oversized_length_closes_connection(lane, data):
    _, _, srv = lane
    cli = binlane.BinLaneClient("127.0.0.1", srv.port)
    cli.sock.sendall(binlane._HDR.pack(1 << 30))
    status, _, _, _ = cli._read_response()
    assert status == binlane.ST_BAD_FRAME
    with pytest.raises(Exception):
        cli.score_batch(data[:4])  # the connection is gone
    cli.close()


def test_fuzz_poison_payload_rejected_not_scored(lane, scorer, data):
    _, _, srv = lane
    rows = data[:8]
    ref = scorer.predict_proba(rows).astype(np.float32)
    with binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
        for poison in (np.nan, np.inf, -np.inf):
            bad = rows.copy()
            bad[2, 11] = poison
            with pytest.raises(binlane.FrameError, match="non-finite"):
                cli.score_batch(bad)
        scores, _ = cli.score_batch(rows)
        assert scores.tobytes() == ref.tobytes()


def test_fuzz_width_mismatch_and_bad_flags(lane, data):
    _, _, srv = lane
    with binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
        with pytest.raises(binlane.FrameError, match="wide"):
            cli.score_batch(np.zeros((4, D - 3), np.float32))
        payload = binlane._FRAME.pack(binlane.MAGIC, binlane.VERSION,
                                      binlane.LAYOUT_F32, D, 0x80, 4) + b"\0" * (4 * D * 4)
        cli.sock.sendall(binlane._HDR.pack(len(payload)) + payload)
        status, _, _, _ = cli._read_response()
        assert status == binlane.ST_BAD_FRAME
        scores, _ = cli.score_batch(data[:4])
        assert scores.shape == (4,)


def test_fuzz_truncated_frame_drops_peer_not_worker(lane, scorer, data):
    _, _, srv = lane
    full = binlane.encode_frame(data[:32])
    s1 = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
    _drain_hello(s1)
    s1.sendall(full[: len(full) // 2])  # disconnect mid-payload
    s1.close()
    s2 = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
    _drain_hello(s2)
    s2.sendall(full[:40])  # stall past the 0.4 s stall timeout
    time.sleep(1.0)
    assert s2.recv(4096) == b""  # dropped, no response, no wedge
    s2.close()
    with binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
        scores, _ = cli.score_batch(data[:8])
        assert scores.tobytes() == scorer.predict_proba(data[:8]).astype(np.float32).tobytes()


def test_max_rows_clamped_to_flush_ceiling(scorer):
    mb = MicroBatcher(scorer, max_batch=64, max_wait_ms=1.0, telemetry=False)
    srv = binlane.BinaryIngestServer(mb, scorer_fn=lambda: scorer, host="127.0.0.1",
                                     port=0, max_rows=1 << 20)
    assert srv.max_rows == 64 == binlane.batcher_max_batch(mb)


# -- the micro-batcher counts rows ------------------------------------------


def test_mixed_singles_and_blocks_share_one_ladder(scorer, data, jax_model):
    """Blocks and single rows share the forming bucket; each item resolves
    from its offset; a block that would overflow max_batch is carried to
    the next batch. The JAX batcher, given the same items, agrees."""

    async def drive(mb, stg, block_cls):
        slots, futs = [], []
        off = 0
        for k in (6, 5, 12):  # 6 + 5 fit one bucket of 16; 12 carries over
            slot = stg.acquire(_bucket(k, 8))
            slot.f32[:k] = data[off:off + k]
            slots.append((slot, k, off))
            futs.append(asyncio.ensure_future(mb.score_block(block_cls(slot, k))))
            off += k
        singles = [asyncio.ensure_future(mb.score(data[off + i])) for i in range(3)]
        await asyncio.gather(*futs, *singles)
        out = [(slot.scores[:k].copy(), o, k) for slot, k, o in slots]
        for slot, _, _ in slots:
            stg.release(slot)
        return out, [s.result() for s in singles]

    lt = _LoopThread()
    mb = MicroBatcher(scorer, max_batch=16, max_wait_ms=5.0, telemetry=False,
                      fused=False, explain=False)
    jmb = JaxBatcher(scorer=jax_model.scorer, max_batch=16, max_wait_ms=5.0,
                     telemetry=False, explain=False)
    lt.call(mb.start())
    lt.call(jmb.start())
    try:
        flushes0 = metrics.scorer_flushes.labels("solo", "0").value
        size0 = metrics.microbatch_size._children[()].value
        blocks, singles = lt.call(drive(mb, scorer.staging, IngestBlock))
        assert metrics.microbatch_size._children[()].value - size0 == 26
        assert metrics.scorer_flushes.labels("solo", "0").value - flushes0 >= 2
        jblocks, jsingles = lt.call(drive(jmb, jax_model.scorer.staging, JaxBlock))
    finally:
        lt.call(mb.stop())
        lt.call(jmb.stop())
        lt.close()
    ref = scorer.predict_proba(data[:64]).astype(np.float32)
    for (scores, off, k), (jscores, _, _) in zip(blocks, jblocks):
        assert scores.tobytes() == ref[off:off + k].tobytes()
        np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-6)
    for i, (s, js) in enumerate(zip(singles, jsingles)):
        assert np.float32(s).tobytes() == ref[23 + i:24 + i].tobytes()
        assert s == pytest.approx(js, abs=1e-6)


def test_a_full_block_is_one_flush_counted_in_rows(scorer, data):
    """A max_batch-row block rides one flush of max_batch rows: one flush,
    microbatch_size observes its rows (not 1), and admission counts its
    rows until the collector picks it up."""
    lt = _LoopThread()
    mb = MicroBatcher(scorer, max_batch=64, max_wait_ms=20.0, telemetry=False,
                      fused=False, explain=False)
    lt.call(mb.start())
    try:
        hist = metrics.microbatch_size._children[()]
        count0, sum0 = hist.count, hist.value
        slot = scorer.staging.acquire(64)
        slot.f32[:64] = data[:64]
        assert lt.call(mb.score_block(IngestBlock(slot, 64))) == 0
        assert (hist.count - count0, hist.value - sum0) == (1, 64)
        assert slot.scores[:64].tobytes() == \
            scorer.predict_proba(data[:64]).astype(np.float32).tobytes()
        scorer.staging.release(slot)

        async def admitted_rows():
            blk = scorer.staging.acquire(16)
            blk.f32[:10] = data[:10]
            mb.admit_max = 12
            try:
                fut = asyncio.ensure_future(mb.score_block(IngestBlock(blk, 10)))
                await asyncio.sleep(0)  # queued, not yet collected
                queued = mb._queued_rows
                with pytest.raises(AdmissionFull):
                    mb._admit(3)  # 10 + 3 rows > 12
                await fut
                return queued
            finally:
                mb.admit_max = 0
                scorer.staging.release(blk)

        assert lt.call(admitted_rows()) == 10
    finally:
        lt.call(mb.stop())
        lt.close()


def test_block_larger_than_max_batch_rejected(scorer, data):
    lt = _LoopThread()
    mb = MicroBatcher(scorer, max_batch=8, max_wait_ms=1.0, telemetry=False,
                      fused=False, explain=False)
    lt.call(mb.start())
    try:
        slot = scorer.staging.acquire(16)
        slot.f32[:12] = data[:12]
        with pytest.raises(ValueError, match="exceeds max_batch"):
            lt.call(mb.score_block(IngestBlock(slot, 12)))
        scorer.staging.release(slot)
    finally:
        lt.call(mb.stop())
        lt.close()


def test_admission_bound_sheds_with_retry_hint(scorer, data, monkeypatch):
    monkeypatch.setenv("SCORER_ADMIT_RETRY_AFTER_S", "2.5")
    lt = _LoopThread()
    mb = MicroBatcher(scorer, max_batch=8, max_wait_ms=200.0, telemetry=False,
                      admit_max_rows=8, fused=False, explain=False)
    lt.call(mb.start())
    try:
        async def overfill():
            slot = scorer.staging.acquire(8)
            mb._queued_rows = 8  # a backlog at the bound
            try:
                slot.f32[:8] = data[:8]
                with pytest.raises(AdmissionFull) as ei:
                    await mb.score_block(IngestBlock(slot, 8))
                assert ei.value.retry_after_s == 2.5
                with pytest.raises(AdmissionFull):
                    await mb.score(data[9])
            finally:
                mb._queued_rows = 0
                scorer.staging.release(slot)

        lt.call(overfill())
    finally:
        lt.call(mb.stop())
        lt.close()


def test_socket_busy_frame_carries_the_retry_hint(scorer, data, monkeypatch):
    monkeypatch.setenv("SCORER_ADMIT_RETRY_AFTER_S", "3")
    lt, mb, srv = _lane(scorer, admit_max_rows=64)
    try:
        mb._queued_rows = 64
        with binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
            with pytest.raises(binlane.LaneBusy) as ei:
                cli.score_batch(data[:4])
            assert ei.value.status == binlane.ST_BUSY and ei.value.retry_after_s == 3.0
            mb._queued_rows = 0
            assert cli.score_batch(data[:4])[0].shape == (4,)
    finally:
        mb._queued_rows = 0
        _close(lt, mb, srv)


# -- the HTTP lane and the slice as a whole ----------------------------------


@pytest.fixture(scope="module")
def served_dir(tmp_path_factory, data, jax_model):
    """models/ plus a drift baseline, so both apps flush fused with
    reason codes."""
    d = str(tmp_path_factory.mktemp("ingest") / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    scores = np.asarray(jax_model.scorer.predict_proba(data))
    save_profile(d, build_baseline_profile(data, scores,
                                           feature_names=jax_model.feature_names))
    return d


@pytest.fixture()
def serving_env(served_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_PATH", os.path.join(served_dir, "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/mlruns")
    monkeypatch.setenv("DATABASE_URL", f"sqlite:///{tmp_path}/port_fraud.db")
    monkeypatch.setenv("CELERY_BROKER_URL", f"sqlite:///{tmp_path}/port_taskq.db")
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("SCORER_MAX_BATCH", "64")
    monkeypatch.setenv("DEVICE", "cpu")
    return served_dir


def _post_raw(client, request_cls, path, body, ctype):
    req = request_cls("POST", path, {"content-type": ctype}, body)

    async def go():
        await client.app.startup()
        return await client.app.dispatch(req)

    return client.loop.run_until_complete(go())


def test_http_frame_lane_bitwise_matches_predict(serving_env, data):
    rows = data[:12]
    bin_rows0 = metrics.ingest_rows.labels("binary").value
    json_req0 = metrics.ingest_requests.labels("json").value
    with TestClient(create_app()) as tc:
        r = _post_raw(tc, Request, "/ingest/batch",
                      binlane.encode_frame(rows, length_prefix=False),
                      "application/x-fraud-frame")
        assert r.status_code == 200, r.body
        assert r.headers["content-type"] == "application/x-fraud-frame"
        scores, reasons = binlane.decode_response_body(r.body)
        assert reasons is not None and reasons[0].shape == (12, 3)
        names = tc.app.state["model"].feature_names
        for i in (0, 5, 11):
            jr = tc.post("/predict", json={"features": rows[i].tolist()})
            assert jr.status_code == 200
            body = jr.json()
            assert np.float32(body["score"]).tobytes() == scores[i:i + 1].tobytes()
            assert [c["feature"] for c in body["reason_codes"]] == \
                [names[j] for j in reasons[0][i]]
        assert metrics.ingest_rows.labels("binary").value - bin_rows0 == 12
        assert metrics.ingest_requests.labels("json").value - json_req0 == 3
        assert 'ingest_rows_total{lane="binary"}' in tc.get("/metrics").text


def test_http_lane_rejects_malformed_and_unknown_types(serving_env, data):
    with TestClient(create_app()) as tc:
        r = _post_raw(tc, Request, "/ingest/batch", b"\x00\x01",
                      "application/x-fraud-frame")
        assert r.status_code == 422
        bad = data[:4].copy()
        bad[1, 2] = np.nan
        r = _post_raw(tc, Request, "/ingest/batch",
                      binlane.encode_frame(bad, length_prefix=False),
                      "application/x-fraud-frame")
        assert r.status_code == 422 and "non-finite" in r.json()["detail"]
        r = _post_raw(tc, Request, "/ingest/batch",
                      binlane.encode_frame(data[:65], length_prefix=False),
                      "application/x-fraud-frame")
        assert r.status_code == 422 and "INGEST_MAX_ROWS" in r.json()["detail"]
        r = _post_raw(tc, Request, "/ingest/batch", b"{}", "application/json")
        assert r.status_code == 415


def test_http_msgpack_lane(serving_env, data, monkeypatch):
    msgpack = pytest.importorskip("msgpack")
    rows = data[:9]
    with TestClient(create_app()) as tc:
        r = _post_raw(tc, Request, "/ingest/batch",
                      msgpack.packb({"rows": rows.tolist()}), "application/msgpack")
        assert r.status_code == 200, r.body
        out = msgpack.unpackb(r.body)
        assert out["n"] == 9 and len(out["scores"]) == 9
        assert len(out["reason_idx"]) == 9
        r = _post_raw(tc, Request, "/ingest/batch", b"\xc1garbage",
                      "application/msgpack")
        assert r.status_code == 422


def test_http_msgpack_absent_answers_415(serving_env, data, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "msgpack", None)  # import raises
    with TestClient(create_app()) as tc:
        r = _post_raw(tc, Request, "/ingest/batch", b"\x80", "application/msgpack")
        assert r.status_code == 415


def test_http_admission_full_answers_429(serving_env, data):
    frame = binlane.encode_frame(data[:8], length_prefix=False)
    with TestClient(create_app()) as tc:
        tc.get("/status")  # startup
        batcher = tc.app.state["batcher"]
        batcher._queued_rows = batcher.admit_max
        try:
            r = _post_raw(tc, Request, "/ingest/batch", frame, "application/x-fraud-frame")
            assert r.status_code == 429 and int(r.headers["retry-after"]) >= 1
            jr = tc.post("/predict", json={"features": data[0].tolist()})
            assert jr.status_code == 429 and int(jr.headers["retry-after"]) >= 1
        finally:
            batcher._queued_rows = 0
        r = _post_raw(tc, Request, "/ingest/batch", frame, "application/x-fraud-frame")
        assert r.status_code == 200


def test_the_slice_two_apps_ingest_the_same_256_rows(serving_env, tmp_path, data):
    """One app per package on the committed model: the same 256 rows
    through /ingest/batch (frames of 64, the served max_batch) answer
    scores within 1e-6 and equal reason codes."""
    jax_app = jax_create_app(database_url=f"sqlite:///{tmp_path}/fraud.db",
                             broker_url=f"sqlite:///{tmp_path}/taskq.db")
    rows = data[256:512]
    with JaxClient(jax_app) as jc, TestClient(create_app()) as tc:
        got_s, got_r, want_s, want_r = [], [], [], []
        for lo in range(0, 256, 64):
            frame = binlane.encode_frame(rows[lo:lo + 64], length_prefix=False)
            tr = _post_raw(tc, Request, "/ingest/batch", frame, "application/x-fraud-frame")
            jr = _post_raw(jc, JaxRequest, "/ingest/batch", frame,
                           "application/x-fraud-frame")
            assert tr.status_code == jr.status_code == 200
            s, r = binlane.decode_response_body(tr.body)
            js, jrr = jax_binlane.decode_response_body(jr.body)
            got_s.append(s), got_r.append(r), want_s.append(js), want_r.append(jrr)
        np.testing.assert_allclose(np.concatenate(got_s), np.concatenate(want_s),
                                   rtol=0, atol=1e-6)
        for (gi, gv), (wi, wv) in zip(got_r, want_r):
            assert gi.tolist() == wi.tolist()
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
        assert tc.get("/monitor/status").json()["drift"]["rows_seen"] == \
            jc.get("/monitor/status").json()["drift"]["rows_seen"] == 256


def test_app_starts_and_stops_the_socket_lane(serving_env, data, monkeypatch):
    """INGEST_PORT > 0 starts the lane beside the app (its scores bitwise
    the served scorer's, with reason codes); shutdown joins every lane
    thread."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("INGEST_PORT", str(port))
    monkeypatch.setenv("INGEST_HOST", "127.0.0.1")
    app = create_app()
    lt = _LoopThread()
    try:
        lt.call(app.startup())
        lane = app.state["binlane"]
        assert lane is not None and lane.port == port
        with binlane.BinLaneClient("127.0.0.1", port) as cli:
            scores, reasons = cli.score_batch(data[:16])
        assert reasons is not None and reasons[0].shape == (16, 3)
        ref = app.state["model"].scorer.predict_proba(data[:16]).astype(np.float32)
        np.testing.assert_array_equal(scores, ref)
        lt.call(app.shutdown())
    finally:
        lt.close()
    assert app.state["binlane"] is None
    assert not lane._threads and not lane._accept_thread.is_alive()


@pytest.fixture(scope="module")
def gbt_model(tmp_path_factory, data):
    """A small forest fitted by the JAX package (scaler folded, 64-row
    background), loaded by the port on the CPU."""
    from fraud_detection_tpu.models.gbt import FraudGBTModel as JaxGBT
    from fraud_detection_tpu.ops.gbt import GBTConfig, gbt_fit
    from fraud_detection_tpu.ops.scaler import scaler_fit, scaler_transform
    from fraud_detection_tpu_torch.models import load_any_model

    scaler = scaler_fit(data)
    xs = np.asarray(scaler_transform(scaler, data))
    w = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    y = (xs @ w > 1.0).astype(np.int32)
    names = [f"f{i}" for i in range(D)]
    d = str(tmp_path_factory.mktemp("lane_gbt") / "models")
    JaxGBT(gbt_fit(xs, y, GBTConfig(n_trees=10, max_depth=4, n_bins=32)), names,
           scaler=scaler, background=data[:64]).save(d)
    return load_any_model(d, device="cpu")


@pytest.mark.parametrize("family", ["logistic", "gbt"])
def test_socket_frames_with_reason_codes_bitwise_score_ex(family, model, gbt_model, data):
    """Both families, fused with explain: a frame's scores are bitwise the
    per-row score_ex scores of the same batcher (other buckets), and its
    reason codes are the same indices and values."""
    from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile as pbp
    from fraud_detection_tpu_torch.monitor.watchtower import Watchtower

    m = model if family == "logistic" else gbt_model
    sc = m.scorer
    profile = pbp(data, sc.predict_proba(data), feature_names=m.feature_names,
                  device="cpu")
    wt = Watchtower(profile, device="cpu")
    lt = _LoopThread()
    mb = MicroBatcher(sc, max_batch=64, max_wait_ms=1.0, watchtower=wt, fused=True,
                      explain=True, explain_k=3)
    lt.call(mb.start())
    srv = binlane.BinaryIngestServer(mb, scorer_fn=lambda: sc, model=m,
                                     host="127.0.0.1", port=0, stall_timeout=0.4)
    srv.start(lt.loop)
    try:
        rows = data[100:148]
        with binlane.BinLaneClient("127.0.0.1", srv.port) as cli:
            scores, (idx, vals) = cli.score_batch(rows)
        for i in range(0, 48, 7):
            s, (ri, rv) = lt.call(mb.score_ex(rows[i]))
            assert np.float32(s).tobytes() == scores[i:i + 1].tobytes()
            assert [int(j) for j in ri] == idx[i].tolist()
            np.testing.assert_array_equal(np.asarray(rv, np.float32), vals[i])
    finally:
        srv.stop()
        lt.call(mb.stop())
        wt.close()
        lt.close()
