"""The serving settings the port reads as the JAX package does:
``SCORER_WIRE``, ``WATCHTOWER_ENABLED``,
``WATCHTOWER_{PSI,KS,ECE,DISAGREE}_THRESHOLD``, ``SCORER_ADMIT_MAX_ROWS``,
``SCORER_ADMIT_RETRY_AFTER_S``, ``SCORER_MAX_INFLIGHT``,
``SCORER_ADAPTIVE_WAIT``, the ingest lane's ``INGEST_*``, the shadow's
``MLFLOW_SHADOW_STAGE`` and ``WATCHTOWER_SHADOW_SAMPLE``,
``WATCHTOWER_RETRAIN_TRIGGER``, ``SPYGLASS_ENABLED`` and
``FLIGHTRECORDER_CAPACITY``, the lifeboat's ``LIFEBOAT_DIR``,
``LIFEBOAT_SNAPSHOT_S``, ``LIFEBOAT_SNAPSHOT_FLUSHES``, ``LIFEBOAT_KEEP``
(at least 1) and ``LIFEBOAT_FSYNC_S``, the network store tier's
``FRAUD_STORE_TOKEN``, ``PGUSER`` and ``PGPASSWORD``, the telemetry
layer's ``OTEL_*``, ``DEVICE_PROFILE_*``, ``RECOMPILE_STORM_*``, ``SLO_*``
(with the per-series objective overrides), ``ROOFLINE_ENABLED`` and
``DEVICE_PEAK_*``, ``ADMIN_TOKEN``, and the lifecycle
store's default beside each broker scheme (``NATIVE_CSV``, which JAX reads
in its loader, is compared in ``test_torch_native_csv.py``). Each is set on both
packages with ``monkeypatch`` and the results compared: the readers, the thresholds and
the flags ``/monitor/status`` raises, monitoring off, the admission bound
and its 429, the in-flight bound and the adaptive deadline."""

import asyncio
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from fraud_detection_tpu import config as jax_config
from fraud_detection_tpu.models.logistic import FraudLogisticModel as JaxModel
from fraud_detection_tpu.monitor import watchtower as jax_wt
from fraud_detection_tpu.monitor.baseline import build_baseline_profile, save_profile
from fraud_detection_tpu.service.app import create_app as jax_create_app
from fraud_detection_tpu.service.http import TestClient as JaxClient
from fraud_detection_tpu.service.microbatch import AdmissionFull as JaxAdmissionFull
from fraud_detection_tpu.service.microbatch import MicroBatcher as JaxBatcher
from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.monitor import watchtower as port_wt
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import Request, TestClient
from fraud_detection_tpu_torch.service.microbatch import AdmissionFull, MicroBatcher

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (variable, a value other than the default, the reader both packages name)
SETTINGS = [
    ("SCORER_WIRE", "INT8", "scorer_wire"),
    ("WATCHTOWER_ENABLED", "0", "watchtower_enabled"),
    ("WATCHTOWER_ENABLED", "yes", "watchtower_enabled"),
    ("WATCHTOWER_PSI_THRESHOLD", "0.35", "watchtower_psi_threshold"),
    ("WATCHTOWER_KS_THRESHOLD", "0.25", "watchtower_ks_threshold"),
    ("WATCHTOWER_ECE_THRESHOLD", "0.07", "watchtower_ece_threshold"),
    ("WATCHTOWER_DISAGREE_THRESHOLD", "0.11", "watchtower_disagree_threshold"),
    ("SCORER_ADMIT_MAX_ROWS", "17", "scorer_admit_max_rows"),
    ("SCORER_ADMIT_RETRY_AFTER_S", "3.5", "scorer_admit_retry_after_s"),
    ("SCORER_MAX_INFLIGHT", "9", "scorer_max_inflight"),
    ("SCORER_ADAPTIVE_WAIT", "1", "scorer_adaptive_wait"),
    ("SCORER_ADAPTIVE_WAIT", "off", "scorer_adaptive_wait"),
    ("INGEST_PORT", "9123", "ingest_port"),
    ("INGEST_HOST", "127.0.0.1", "ingest_host"),
    ("INGEST_MAX_ROWS", "256", "ingest_max_rows"),
    ("INGEST_MAX_FRAME_BYTES", "65536", "ingest_max_frame"),
    ("INGEST_STALL_TIMEOUT_S", "0.25", "ingest_stall_timeout_s"),
    ("MLFLOW_SHADOW_STAGE", "canary", "shadow_stage"),
    ("WATCHTOWER_SHADOW_SAMPLE", "0.6", "watchtower_shadow_sample"),
    ("WATCHTOWER_RETRAIN_TRIGGER", "1", "watchtower_retrain_trigger"),
    ("WATCHTOWER_RETRAIN_TRIGGER", "yes", "watchtower_retrain_trigger"),
    ("WATCHTOWER_RETRAIN_TRIGGER", "0", "watchtower_retrain_trigger"),
    ("SPYGLASS_ENABLED", "0", "spyglass_enabled"),
    ("SPYGLASS_ENABLED", "off", "spyglass_enabled"),
    ("FLIGHTRECORDER_CAPACITY", "7", "flightrecorder_capacity"),
    ("LIFEBOAT_DIR", "/srv/lifeboat", "lifeboat_dir"),
    ("LIFEBOAT_SNAPSHOT_S", "42.5", "lifeboat_snapshot_s"),
    ("LIFEBOAT_SNAPSHOT_FLUSHES", "32", "lifeboat_snapshot_flushes"),
    ("LIFEBOAT_KEEP", "2", "lifeboat_keep"),
    ("LIFEBOAT_KEEP", "0", "lifeboat_keep"),
    ("LIFEBOAT_FSYNC_S", "0", "lifeboat_fsync_s"),
    ("FRAUD_STORE_TOKEN", "s3cret", "store_token"),
    ("CELERY_BROKER_URL", "sentinel://s1:26379,s2:26379/m1", "broker_url"),
    ("DATABASE_URL", "postgresql://fraud@db:5432/fraud", "database_url"),
    ("OTEL_EXPORTER_OTLP_ENDPOINT", "http://collector:4318", "otel_endpoint"),
    ("OTEL_SERVICE_NAME", "fraud-edge", "otel_service_name"),
    ("DEVICE_PROFILE_DIR", "/srv/traces", "device_profile_dir"),
    ("DEVICE_PROFILE_DEFAULT_S", "2.5", "device_profile_default_s"),
    ("DEVICE_PROFILE_MAX_S", "12", "device_profile_max_s"),
    ("RECOMPILE_STORM_WINDOW_S", "120", "recompile_storm_window_s"),
    ("RECOMPILE_STORM_THRESHOLD", "4", "recompile_storm_threshold"),
    ("SLO_ENABLED", "0", "slo_enabled"),
    ("SLO_ENABLED", "yes", "slo_enabled"),
    ("SLO_AVAILABILITY_OBJECTIVE", "0.995", "slo_availability_objective"),
    ("SLO_LATENCY_OBJECTIVE", "0.95", "slo_latency_objective"),
    ("SLO_LATENCY_P99_MS", "120", "slo_latency_threshold_s"),
    ("SLO_FAST_BURN", "10", "slo_fast_burn"),
    ("SLO_SLOW_BURN", "3", "slo_slow_burn"),
    ("ROOFLINE_ENABLED", "0", "roofline_enabled"),
    ("ROOFLINE_ENABLED", "on", "roofline_enabled"),
    ("DEVICE_PEAK_FLOPS", "6.7e13", "device_peak_flops"),
    ("DEVICE_PEAK_BYTES_PER_S", "3.35e12", "device_peak_bytes_per_s"),
    ("ADMIN_TOKEN", "s3cret", "admin_token"),
    ("MESH_SHARDS", "4", "mesh_shards"),
    ("MESH_FLUSH_DEVICES", "8", "mesh_flush_devices"),
    ("MESH_FLUSH_DEVICES", "6", "mesh_flush_devices"),
    ("MESH_MODEL_DEVICES", "2", "mesh_model_devices"),
    ("MESH_SHARD_MAX_ERRORS", "5", "mesh_shard_max_errors"),
    ("MESH_SHARD_REOPEN_S", "0.5", "mesh_shard_reopen_s"),
    ("MESH_RETRAIN", "1", "mesh_retrain"),
    ("LONGHAUL_HOSTS", "4", "longhaul_hosts"),
    ("LONGHAUL_DIRECTORY", "10.0.0.5:7301", "longhaul_directory"),
    ("LONGHAUL_HOST_ID", "host-7", "longhaul_host_id"),
    ("LONGHAUL_DATA_DIR", "/srv/longhaul", "longhaul_data_dir"),
    ("LONGHAUL_HEARTBEAT_S", "0.25", "longhaul_heartbeat_s"),
    ("LONGHAUL_DEAD_AFTER_S", "1.5", "longhaul_dead_after_s"),
    ("LONGHAUL_RETRY_AFTER_S", "2.5", "longhaul_retry_after_s"),
    ("LONGHAUL_PROBATION_S", "0.5", "longhaul_probation_s"),
]


@pytest.mark.parametrize("var, value, reader", SETTINGS)
def test_readers_match_jax(var, value, reader, monkeypatch):
    monkeypatch.delenv(var, raising=False)
    assert getattr(config, reader)() == getattr(jax_config, reader)()  # the default
    monkeypatch.setenv(var, value)
    got = getattr(config, reader)()
    assert got == getattr(jax_config, reader)()
    assert type(got) is type(getattr(jax_config, reader)())


@pytest.mark.parametrize("var, value", [
    ("SLO_AVAILABILITY_OBJECTIVE_JSON", "0.9"), ("SLO_AVAILABILITY_OBJECTIVE_SHARD", "0.99"),
    ("SLO_LATENCY_OBJECTIVE_BINARY", "0.8"), ("SLO_LATENCY_OBJECTIVE_MSGPACK", ""),
])
def test_slo_objective_overrides_match_jax(var, value, monkeypatch):
    """A per-series objective wins over the global one for its lane (every
    shard for ``_SHARD``), in both packages."""
    monkeypatch.setenv("SLO_AVAILABILITY_OBJECTIVE", "0.995")
    monkeypatch.setenv(var, value)
    for series in (None, "json", "msgpack", "binary", "shard0", "shard12"):
        for reader in ("slo_availability_objective", "slo_latency_objective"):
            assert getattr(config, reader)(series) == getattr(jax_config, reader)(series)


@pytest.mark.parametrize("var, value", [("PGUSER", "env-user"), ("PGPASSWORD", "env pw"),
                                        ("PGUSER", "")])
def test_pg_environment_matches_jax(var, value, monkeypatch):
    """``PGUSER``/``PGPASSWORD`` fill what a PostgreSQL URL leaves out, in
    both packages' ``parse_dsn``."""
    from fraud_detection_tpu.service.pgwire import parse_dsn as jax_parse_dsn
    from fraud_detection_tpu_torch.service.pgwire import parse_dsn

    monkeypatch.delenv(var, raising=False)
    dsns = ("postgresql://h/d", "postgresql://u@h/d", "postgresql://u:p@h:5433/d")
    assert [parse_dsn(d) for d in dsns] == [jax_parse_dsn(d) for d in dsns]
    monkeypatch.setenv(var, value)
    assert [parse_dsn(d) for d in dsns] == [jax_parse_dsn(d) for d in dsns]


@pytest.mark.parametrize("broker", ["sqlite:////tmp/q.db", "postgresql://u@h/d",
                                    "fraud://h:7600", "sentinel://s:26379/m1"])
def test_lifecycle_db_url_beside_each_broker_matches_jax(broker, monkeypatch):
    """Unset ``LIFECYCLE_DB_URL``: a SQL broker holds the lifecycle tables,
    a store-tier broker falls back to the local file, in both packages."""
    monkeypatch.delenv("LIFECYCLE_DB_URL", raising=False)
    monkeypatch.delenv("LONGHAUL_HOSTS", raising=False)
    assert config.lifecycle_db_url(broker) == jax_config.lifecycle_db_url(broker)
    monkeypatch.setenv("CELERY_BROKER_URL", broker)
    assert config.lifecycle_db_url() == jax_config.lifecycle_db_url()
    monkeypatch.setenv("LIFECYCLE_DB_URL", "postgresql://x@y/z")
    assert config.lifecycle_db_url(broker) == jax_config.lifecycle_db_url(broker)


THRESHOLD_VARS = {
    "WATCHTOWER_PSI_THRESHOLD": "0.31",
    "WATCHTOWER_KS_THRESHOLD": "0.27",
    "WATCHTOWER_ECE_THRESHOLD": "0.03",
    "WATCHTOWER_DISAGREE_THRESHOLD": "0.09",
    "WATCHTOWER_MIN_ROWS": "100",
}


def test_thresholds_from_config_match_jax(monkeypatch):
    for var, value in THRESHOLD_VARS.items():
        monkeypatch.setenv(var, value)
    got, want = port_wt.Thresholds.from_config(), jax_wt.Thresholds.from_config()
    assert (got.psi, got.ks, got.ece, got.disagree, got.min_rows) == (
        want.psi, want.ks, want.ece, want.disagree, want.min_rows
    ) == (0.31, 0.27, 0.03, 0.09, 100)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """models/ plus a monitor_profile.npz built from 2000 real rows."""
    d = str(tmp_path_factory.mktemp("settings") / "models")
    shutil.copytree(os.path.join(ROOT, "models"), d)
    data = np.loadtxt(
        os.path.join(ROOT, "data", "creditcard.csv"), delimiter=",",
        skiprows=1, max_rows=2000, dtype=np.float32,
    )
    x = data[:, :30]
    m = JaxModel.load(d)
    save_profile(d, build_baseline_profile(x, np.asarray(m.scorer.predict_proba(x)),
                                           feature_names=m.feature_names))
    return d, x


@pytest.fixture()
def serving_env(model_dir, tmp_path, monkeypatch):
    d, x = model_dir
    for key, value in dict(
        DEVICE="cpu", MODEL_PATH=os.path.join(d, "logistic_model.joblib"),
        MLFLOW_TRACKING_URI=f"file:{tmp_path}/mlruns", SCORER_MAX_BATCH="64",
        DATABASE_URL=f"sqlite:///{tmp_path}/port_fraud.db",
        CELERY_BROKER_URL=f"sqlite:///{tmp_path}/port_taskq.db",
        WATCHTOWER_MIN_ROWS="16",
    ).items():
        monkeypatch.setenv(key, value)
    return d, x


def _jax_app(tmp_path):
    return jax_create_app(database_url=f"sqlite:///{tmp_path}/fraud.db",
                          broker_url=f"sqlite:///{tmp_path}/taskq.db")


@pytest.mark.parametrize("psi, ks, drifting", [("0.0001", "0.0001", True),
                                                ("1000", "2", False)])
def test_monitor_status_flags_follow_the_thresholds(serving_env, tmp_path, monkeypatch,
                                                    psi, ks, drifting):
    """A shifted stream of 32 rows through each app: with near-zero PSI/KS
    thresholds every drift flag is raised, with thresholds out of reach
    none is (the defaults would flag this stream) — the same flags,
    status and thresholds in both apps."""
    d, x = serving_env
    monkeypatch.setenv("WATCHTOWER_PSI_THRESHOLD", psi)
    monkeypatch.setenv("WATCHTOWER_KS_THRESHOLD", ks)
    monkeypatch.setenv("WATCHTOWER_ECE_THRESHOLD", "0.02")
    monkeypatch.setenv("WATCHTOWER_DISAGREE_THRESHOLD", "0.5")
    rows = x[:32].copy()
    rows[:, 1:6] += 4.0
    with JaxClient(_jax_app(tmp_path)) as jc, TestClient(create_app()) as tc:
        for r in rows:
            body = {"features": r.tolist()}
            assert jc.post("/predict", json=body).status_code == 200
            assert tc.post("/predict", json=body).status_code == 200
        js, ts = jc.get("/monitor/status").json(), tc.get("/monitor/status").json()
    assert ts["status"] == js["status"] == ("drift" if drifting else "ok")
    assert ts["flags"] == js["flags"]
    assert ts["flags"]["feature_psi"] is drifting and ts["flags"]["score_ks"] is drifting
    assert ts["thresholds"] == js["thresholds"] == {
        "psi": float(psi), "ks": float(ks), "ece": 0.02, "disagree": 0.5, "min_rows": 16,
    }


@pytest.mark.parametrize("enabled, with_profile, want_level", [
    ("0", True, None), ("1", False, logging.WARNING), (None, False, logging.INFO),
    ("1", True, None), (None, True, None),
])
def test_build_watchtower_follows_watchtower_enabled(model_dir, tmp_path, monkeypatch, caplog,
                                                     enabled, with_profile, want_level):
    """``WATCHTOWER_ENABLED=0`` turns monitoring off even with a profile;
    without a profile ``=1`` logs at WARNING and unset at INFO; both
    packages alike."""
    d = model_dir[0]
    if not with_profile:
        d = str(tmp_path / "bare")
        shutil.copytree(model_dir[0], d)
        os.remove(os.path.join(d, "monitor_profile.npz"))
    if enabled is None:
        monkeypatch.delenv("WATCHTOWER_ENABLED", raising=False)
    else:
        monkeypatch.setenv("WATCHTOWER_ENABLED", enabled)
    caplog.set_level(logging.DEBUG)
    port_model = FraudLogisticModel.load(d, device="cpu")
    got = port_wt.build_watchtower(port_model, f"native:{d}", device="cpu")
    want = jax_wt.build_watchtower(JaxModel.load(d), f"native:{d}")
    try:
        assert (got is None) == (want is None) == (enabled == "0" or not with_profile)
        for pkg in ("fraud_detection_tpu.watchtower", "fraud_detection_tpu_torch.watchtower"):
            levels = [r.levelno for r in caplog.records
                      if r.name == pkg and "serving unmonitored" in r.getMessage()]
            assert levels == ([] if want_level is None else [want_level]), pkg
    finally:
        for wt in (got, want):
            if wt is not None:
                wt.close()


def _batchers(monkeypatch, **env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port = MicroBatcher(FraudLogisticModel.load(os.path.join(ROOT, "models"), device="cpu").scorer,
                        max_batch=8)
    jax = JaxBatcher(JaxModel.load(os.path.join(ROOT, "models")).scorer, max_batch=8)
    return port, jax


def test_admission_bound_and_retry_hint_match_jax(monkeypatch):
    port, jax = _batchers(monkeypatch, SCORER_ADMIT_MAX_ROWS="3", SCORER_ADMIT_RETRY_AFTER_S="7.5")
    assert port.admit_max == jax.admit_max == 3
    for b, exc in ((port, AdmissionFull), (jax, JaxAdmissionFull)):
        b._admit(3)
        with pytest.raises(exc) as e:
            b._admit(1)
        assert e.value.retry_after_s == 7.5 and e.value.queued_rows == 3
    assert str(AdmissionFull(7.5, 3)) == str(JaxAdmissionFull(7.5, 3))
    port, jax = _batchers(monkeypatch, SCORER_ADMIT_MAX_ROWS="0")
    port._admit(10**6)
    jax._admit(10**6)  # 0 disables the bound in both


def test_admission_bound_answers_429_with_retry_after(serving_env, monkeypatch):
    """Eight concurrent ``/predict`` against a bound of 3 rows: the rows
    past the bound answer 429 with the configured ``Retry-After``."""
    d, x = serving_env
    monkeypatch.setenv("SCORER_ADMIT_MAX_ROWS", "3")
    monkeypatch.setenv("SCORER_ADMIT_RETRY_AFTER_S", "4")
    with TestClient(create_app()) as tc:
        assert tc.get("/health").status_code == 200
        reqs = [Request("POST", "/predict", {"content-type": "application/json"},
                        ('{"features": %s}' % x[i].tolist()).encode()) for i in range(8)]

        async def burst():
            return await asyncio.gather(*(tc.app.dispatch(r) for r in reqs))

        res = tc.loop.run_until_complete(burst())
    codes = sorted(r.status_code for r in res)
    assert codes == [200] * 3 + [429] * 5
    assert all(r.headers["retry-after"] == "4" for r in res if r.status_code == 429)


def test_inflight_semaphore_size_matches_jax(monkeypatch):
    port, jax = _batchers(monkeypatch, SCORER_MAX_INFLIGHT="6")
    assert port._inflight._value == jax._inflight._value == 6
    port = MicroBatcher(port.scorer, max_batch=8, max_inflight=2)
    assert port._inflight._value == 2


def _arrivals(batcher, waves) -> list[float]:
    """Drive ``batcher``'s collector with ``waves`` of requests (a wave's
    requests arrive together, then the clock runs ``gap`` seconds), flushes
    stubbed to answer 0.0 at once; returns ``_effective_wait()`` after each
    wave."""
    async def flush_one(batch):
        for item in batch:
            item[1].set_result(0.0)
        batcher._inflight.release()

    batcher._flush_one = flush_one
    row = np.zeros(30, np.float32)

    async def go():
        collector = asyncio.create_task(batcher._run())
        waits = []
        for n, gap in waves:
            await asyncio.gather(*(batcher.score(row) for _ in range(n)))
            await asyncio.sleep(gap)
            waits.append(batcher._effective_wait())
        collector.cancel()
        try:
            await collector
        except asyncio.CancelledError:
            pass
        return waits

    return asyncio.run(go())


def test_adaptive_wait_matches_jax(monkeypatch):
    """``SCORER_ADAPTIVE_WAIT=1`` with a 50 ms window: lone requests 100 ms
    apart flush at once (deadline 0), then a saturating burst scales the
    deadline up to the whole window — in both packages; with the setting
    off the deadline is always the window."""
    waves = [(1, 0.1), (1, 0.1), (1, 0.1)] + [(64, 0.0)] * 4
    monkeypatch.setenv("SCORER_MAX_WAIT_MS", "50")
    port, jax = _batchers(monkeypatch, SCORER_ADAPTIVE_WAIT="1")
    assert port.adaptive_wait is jax.adaptive_wait is True
    got, want = _arrivals(port, waves), _arrivals(jax, waves)
    assert got[:3] == want[:3] == [0.0, 0.0, 0.0]
    assert got[-1] == want[-1] == pytest.approx(0.05)
    for rate in (0.0, 10.0, 30.0, 100.0, 1000.0, 5000.0, 1e6):  # both ends and between
        port._rate = jax._rate = rate
        assert port._effective_wait() == jax._effective_wait()
    port._rate = 200.0  # 10 rows expected in the window: 10/8 of a batch, capped
    assert port._effective_wait() == pytest.approx(0.05)
    port._rate = 100.0  # 5 rows expected: 5/8 of the window
    assert port._effective_wait() == pytest.approx(0.05 * 5 / 8)
    port, jax = _batchers(monkeypatch, SCORER_ADAPTIVE_WAIT="0")
    assert port._effective_wait() == jax._effective_wait() == pytest.approx(0.05)
