"""The port's tracking server and HTTP client against the JAX package's:
the run lifecycle, the registry gate and resolve, and serving from the HTTP
registry, each with the port's client on the port's server, the port's
client on the JAX server and the JAX client on the port's server (one
wire). Path traversal is refused, and the port's ``train``,
``validate_auc``, app and worker reach a registry over HTTP. On the CPU."""

import asyncio
import http.client
import io
import os
import tarfile
import threading

import numpy as np
import pytest
import torch

from fraud_detection_tpu.service.http import _handle_connection as jax_handle_connection
from fraud_detection_tpu.service.loading import load_production_model as jax_load
from fraud_detection_tpu.tracking import TrackingClient as JaxTrackingClient
from fraud_detection_tpu.tracking.server import create_app as jax_create_server
from fraud_detection_tpu_torch.data.synthetic import generate_synthetic_data
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.ops.logistic import LogisticParams
from fraud_detection_tpu_torch.ops.scaler import scaler_fit
from fraud_detection_tpu_torch.service.http import _handle_connection
from fraud_detection_tpu_torch.service.loading import load_production_model
from fraud_detection_tpu_torch.tracking import FileTrackingClient, TrackingClient
from fraud_detection_tpu_torch.tracking.http_client import HttpTrackingClient
from fraud_detection_tpu_torch.tracking.server import create_app, tar_bytes, untar_bytes

torch.set_num_threads(1)

NAMES = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount"]
SERVERS = {"port": (create_app, _handle_connection),
           "jax": (jax_create_server, jax_handle_connection)}
CLIENTS = {"port": TrackingClient, "jax": JaxTrackingClient}
#: (client, server): each package's client on the other's server, and the port alone
COMBOS = [("port", "port"), ("port", "jax"), ("jax", "port")]


class _ThreadedServer:
    """A package's tracking server on 127.0.0.1, port 0, in a daemon
    thread's event loop."""

    def __init__(self, app, handle):
        self.app, self.handle = app, handle
        self.loop = asyncio.new_event_loop()
        self.port = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def start():
            self._server = await asyncio.start_server(
                lambda r, w: self.handle(self.app, r, w), "127.0.0.1", 0)
            self.port = self._server.sockets[0].getsockname()[1]
            self._ready.set()

        self.loop.run_until_complete(start())
        self.loop.run_forever()
        self._server.close()
        self.loop.run_until_complete(self._server.wait_closed())
        self.loop.close()

    def __enter__(self):
        self._thread.start()
        assert self._ready.wait(10), "server never came up"
        return self

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAUD_REGISTRY_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("DEVICE", "cpu")
    for knob in ("MLFLOW_MODEL_NAME", "MLFLOW_MODEL_STAGE", "MLFLOW_EXPERIMENT",
                 "MLFLOW_AUC_THRESHOLD", "REQUIRE_REGISTRY_MODEL"):
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def _serve(kind, root):
    make, handle = SERVERS[kind]
    return _ThreadedServer(make(str(root)), handle)


def _model(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 30)).astype(np.float32) * 2 + 1
    params = LogisticParams(coef=torch.from_numpy(rng.standard_normal(30).astype(np.float32)),
                            intercept=torch.tensor(-1.0))
    return FraudLogisticModel(params, scaler_fit(x), NAMES, device="cpu"), x


def test_uri_dispatch(tmp_path):
    """``http(s)://`` opens the HTTP client, ``file:`` and bare paths the
    file store."""
    assert isinstance(TrackingClient("http://localhost:1"), HttpTrackingClient)
    assert isinstance(TrackingClient("https://tracking.internal"), HttpTrackingClient)
    assert isinstance(TrackingClient(f"file:{tmp_path}"), FileTrackingClient)
    assert isinstance(TrackingClient(str(tmp_path)), FileTrackingClient)


@pytest.mark.parametrize("client_kind, server_kind", COMBOS)
def test_run_lifecycle(env, tmp_path, client_kind, server_kind):
    root = tmp_path / "trackroot"
    with _serve(server_kind, root) as s:
        client = CLIENTS[client_kind](f"http://127.0.0.1:{s.port}")
        with client.start_run("exp1") as run:
            run.log_params({"lr": 0.1, "solver": "lbfgs"})
            run.log_param("seed", 42)
            run.log_metric("auc", 0.97, step=1)
            run.log_metric("auc", 0.975, step=2)
            run.set_tag("registered", "no")
            with open(run.artifact_path("plots", "roc.txt"), "w") as f:
                f.write("fake plot")
            run_id = run.run_id
        reopened = client.get_run("exp1", run_id)
        assert reopened.params == {"lr": "0.1", "solver": "lbfgs", "seed": "42"}
        assert reopened.latest_metric("auc") == pytest.approx(0.975)
        assert [m["step"] for m in reopened.metrics["auc"]] == [1, 2]
        assert reopened.tags == {"registered": "no"}
        assert client.list_runs("exp1") == [run_id]
        with pytest.raises(FileNotFoundError):
            client.get_run("exp1", "nope")
        with pytest.raises(RuntimeError):
            with client.start_run("exp2") as failed:
                raise RuntimeError("boom")
    # the server wrote the file store's layout: the file clients read it
    art = root / "experiments" / "exp1" / "runs" / run_id / "artifacts" / "plots" / "roc.txt"
    assert art.read_text() == "fake plot"
    for local in (FileTrackingClient(f"file:{root}"), JaxTrackingClient(f"file:{root}")):
        assert local.get_run("exp1", run_id).params["seed"] == "42"
    assert FileTrackingClient(f"file:{root}").get_run("exp2", failed.run_id).path
    import json

    meta = json.loads((root / "experiments" / "exp2" / "runs" / failed.run_id
                       / "meta.json").read_text())
    assert meta["status"] == "FAILED"


@pytest.mark.parametrize("client_kind, server_kind", COMBOS)
def test_registry_gate_and_resolve(env, tmp_path, client_kind, server_kind):
    art = tmp_path / "model"
    os.makedirs(art / "sub")
    (art / "model.npz").write_bytes(b"weights" * 100)
    (art / "sub" / "names.json").write_text('["Time"]')
    with _serve(server_kind, tmp_path / "trackroot") as s:
        reg = CLIENTS[client_kind](f"http://127.0.0.1:{s.port}").registry
        assert reg.register_if_gate("fraud", str(art), 0.5, 0.9) is None
        assert reg.register_if_gate("fraud", str(art), float("nan"), 0.9) is None
        assert reg.register_if_gate("fraud", str(art), 0.97, 0.9, alias="prod",
                                    run_id="r1") == 1
        resolved = reg.resolve("models:/fraud@prod")
        assert resolved.startswith(str(tmp_path / "cache"))
        assert open(os.path.join(resolved, "model.npz"), "rb").read() == b"weights" * 100
        assert open(os.path.join(resolved, "sub", "names.json")).read() == '["Time"]'
        assert reg.get_meta("fraud", 1)["run_id"] == "r1"
        assert reg.get_meta("fraud", 1)["metrics"] == {"auc": 0.97}
        assert reg.register("fraud", str(art), metrics={"auc": 0.99},
                            lineage={"parent_version": 1}) == 2
        reg.set_alias("fraud", "prod", 2)
        reg.set_alias("fraud", "shadow", 1)
        assert reg.get_version_by_alias("fraud", "prod") == 2
        assert reg.latest_version("fraud") == 2
        assert reg.resolve("models:/fraud@prod").endswith(os.path.join("fraud", "2"))
        assert reg.resolve("models:/fraud/1").endswith(os.path.join("fraud", "1"))
        assert reg.get_meta("fraud", 2)["lineage"] == {"parent_version": 1}
        assert reg.delete_alias("fraud", "shadow") is True
        assert reg.delete_alias("fraud", "shadow") is False
        assert reg.get_version_by_alias("fraud", "shadow") is None
        for missing in ("models:/nope@prod", "models:/fraud@shadow", "models:/fraud/9"):
            with pytest.raises(FileNotFoundError):
                reg.resolve(missing)
    # an unreachable server resolves as a missing model does
    with pytest.raises(FileNotFoundError):
        CLIENTS[client_kind](f"http://127.0.0.1:{s.port}").registry.resolve(
            "models:/fraud@prod")


@pytest.mark.parametrize("client_kind, server_kind", COMBOS)
def test_serving_loads_the_model_from_the_http_registry(env, tmp_path, client_kind,
                                                        server_kind):
    """The no-shared-volume topology: the model registered over HTTP, then
    each package's production loader with only ``MLFLOW_TRACKING_URI`` (and
    ``REQUIRE_REGISTRY_MODEL=1``: no fallback) serves it."""
    model, x = _model()
    art = str(tmp_path / "trained-model")
    model.save(art, joblib_too=False)
    env.setenv("MODEL_PATH", str(tmp_path / "nowhere" / "model.npz"))
    env.setenv("REQUIRE_REGISTRY_MODEL", "1")
    with _serve(server_kind, tmp_path / "trackroot") as s:
        uri = f"http://127.0.0.1:{s.port}"
        env.setenv("MLFLOW_TRACKING_URI", uri)
        CLIENTS[client_kind](uri).registry.register_if_gate("fraud", art, 0.97, 0.9,
                                                            alias="prod")
        if client_kind == "port":
            loaded, source = load_production_model(device="cpu")
            got = loaded.scorer.predict_proba(x[:8])
        else:
            loaded, source = jax_load()
            got = np.asarray(loaded.scorer.predict_proba(x[:8])).reshape(-1)
    assert source == "registry:models:/fraud@prod"
    np.testing.assert_allclose(got, model.scorer.predict_proba(x[:8]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_app_worker_and_validate_auc_over_http(env, tmp_path, server_kind):
    """The port's app and SHAP worker serve ``@prod`` from a tracking
    server, and ``validate_auc`` gates it and logs its run there."""
    from fraud_detection_tpu_torch.service.app import create_app as create_api
    from fraud_detection_tpu_torch.service.http import TestClient
    from fraud_detection_tpu_torch.service.worker import XaiWorker
    from fraud_detection_tpu_torch.validate_auc import validate_auc

    model, _ = _model(1)
    art = str(tmp_path / "trained-model")
    model.save(art, joblib_too=False)
    env.setenv("MODEL_PATH", str(tmp_path / "nowhere" / "model.npz"))
    env.setenv("SCORER_MAX_BATCH", "16")
    with _serve(server_kind, tmp_path / "trackroot") as s:
        uri = f"http://127.0.0.1:{s.port}"
        env.setenv("MLFLOW_TRACKING_URI", uri)
        TrackingClient(uri).registry.register_if_gate("fraud", art, 0.97, 0.9, alias="prod")
        db, q = f"sqlite:///{tmp_path}/f.db", f"sqlite:///{tmp_path}/q.db"
        with TestClient(create_api(database_url=db, broker_url=q, device="cpu")) as tc:
            health = tc.get("/health").json()
            assert health["status"] == "healthy"
            assert health["model_source"] == "registry:models:/fraud@prod"
            r = tc.post("/predict", json={"features": [0.5] * 30})
            assert r.status_code == 200
        worker = XaiWorker(broker_url=q, database_url=db, device="cpu")
        try:
            assert worker.run_once() is True
        finally:
            worker.close()
        auc, passed = validate_auc(threshold=0.0, n_samples=500, device="cpu")
        client = TrackingClient(uri)
        (run_id,) = client.list_runs("model-validation")
        run = client.get_run("model-validation", run_id)
        assert run.params == {"model_uri": "models:/fraud@prod"}
        assert run.tags == {"validation_pass": "True"} and passed
        assert run.latest_metric("auc_score") == pytest.approx(auc)


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_train_registers_over_http(env, tmp_path, server_kind):
    """The port's ``train(register=True)`` on the CPU with an HTTP tracking
    URI: the run, its staged artifacts and the gated version land on the
    server, and ``@prod`` resolves to the trained model."""
    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.train import train

    csv = str(tmp_path / "synth.csv")
    generate_synthetic_data(csv, n_samples=2000, fraud_ratio=0.05, seed=1, shift_scale=1.0)
    env.setenv("MLFLOW_AUC_THRESHOLD", "0.70")
    root = tmp_path / "trackroot"
    with _serve(server_kind, root) as s:
        uri = f"http://127.0.0.1:{s.port}"
        env.setenv("MLFLOW_TRACKING_URI", uri)
        metrics = train(data_csv=csv, n_folds=2, out_dir=str(tmp_path / "out"), device="cpu")
        assert metrics["registered_version"] == 1
        client = TrackingClient(uri)
        art = client.registry.resolve("models:/fraud@prod")
        (run_id,) = client.list_runs("fraud-detection")
        run = client.get_run("fraud-detection", run_id)
        assert run.tags["registered_version"] == "1"
        assert run.latest_metric("test_auc") == pytest.approx(metrics["test_auc"])
    served = load_any_model(art, device="cpu")
    local = load_any_model(str(tmp_path / "out"), device="cpu")
    x = np.zeros((4, 30), np.float32)
    assert served.scorer.predict_proba(x).tobytes() == local.scorer.predict_proba(x).tobytes()
    staged = root / "experiments" / "fraud-detection" / "runs" / run_id / "artifacts"
    assert (staged / "model" / "model.npz").exists()


def _status(port, method, path, body=b"{}", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body,
                     headers={"content-type": "application/json", **(headers or {})})
        return conn.getresponse().status
    finally:
        conn.close()


def _bundle(name: str, data: bytes = b"x") -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_path_traversal_is_refused(env, tmp_path):
    """Path parameters, artifact paths and bundle members that would leave
    the store root answer 400 and touch nothing outside it."""
    root = tmp_path / "trackroot"
    with _serve("port", root) as s:
        assert _status(s.port, "POST", "/api/experiments/../runs") == 400
        assert _status(s.port, "POST", "/api/experiments/.%2e/runs") in (400, 404)
        assert _status(s.port, "GET", "/api/experiments/ok/runs/..") == 400
        assert _status(s.port, "GET", "/api/registry/../aliases") == 400
        assert _status(s.port, "GET", "/api/registry/./latest") == 400
        for evil in ("../evil.txt", "/abs/evil.txt"):
            assert _status(s.port, "POST", "/api/registry/fraud/versions",
                           body=_bundle(evil)) == 400
        run_id = TrackingClient(f"http://127.0.0.1:{s.port}").start_run("exp").run_id
        for rel in ("../../../evil.txt", "/etc/evil.txt", ""):
            assert _status(s.port, "PUT", f"/api/experiments/exp/runs/{run_id}/artifact",
                           body=b"x", headers={"x-artifact-path": rel}) == 400
        assert _status(s.port, "POST", "/api/registry/fraud/aliases",
                       body=b'{"alias": "prod"}') == 422
        assert _status(s.port, "POST", "/api/experiments/exp-1.ok/runs") == 200
    assert not (root.parent / "runs").exists() and not (root.parent / "evil.txt").exists()
    assert not (tmp_path / "cache").exists()
    assert not os.path.exists(os.path.join(root, "registry", "fraud"))


def test_bundle_round_trip(tmp_path):
    """``tar_bytes``/``untar_bytes`` carry a directory tree, and the JAX
    package unpacks the port's bundle alike."""
    from fraud_detection_tpu.tracking.server import untar_bytes as jax_untar

    src = tmp_path / "src"
    os.makedirs(src / "a" / "b")
    (src / "model.npz").write_bytes(b"\x00\x01" * 50)
    (src / "a" / "b" / "c.json").write_text("{}")
    data = tar_bytes(str(src))
    for dest, fn in ((tmp_path / "p", untar_bytes), (tmp_path / "j", jax_untar)):
        fn(data, str(dest))
        assert (dest / "model.npz").read_bytes() == b"\x00\x01" * 50
        assert (dest / "a" / "b" / "c.json").read_text() == "{}"
