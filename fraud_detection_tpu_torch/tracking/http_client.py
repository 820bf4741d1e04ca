"""HTTP tracking and registry client.

The surface of the file store's :class:`~fraud_detection_tpu_torch.tracking.
store.TrackingClient` and :class:`~fraud_detection_tpu_torch.tracking.
registry.ModelRegistry`, over a tracking server (``server.py``, or the JAX
package's, which speaks the same wire), selected by
``MLFLOW_TRACKING_URI=http://host:5000``. Standard library only.

Two differences from the file client, by construction:

- ``Run.artifact_path`` returns a local staging path; the staged files
  upload when the run ends (one PUT a file), so the trainer's "write the
  artifacts, then register the directory" flow is unchanged.
- ``registry.register*`` uploads the artifact directory as one gzipped tar;
  ``registry.resolve`` downloads the version into a local cache
  (``FRAUD_REGISTRY_CACHE``) and returns that path, so loading a model stays
  a local-directory read.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import urllib.error
import urllib.request
from typing import Any

from fraud_detection_tpu_torch.tracking.registry import parse_model_uri

TIMEOUT = 30.0


class TrackingHTTPError(OSError):
    pass


def _call(
    method: str,
    url: str,
    body: bytes | None = None,
    headers: dict[str, str] | None = None,
) -> bytes:
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")[:500]
        raise TrackingHTTPError(f"{method} {url} -> {e.code}: {detail}") from e
    except urllib.error.URLError as e:
        raise TrackingHTTPError(f"{method} {url} failed: {e.reason}") from e


def _call_json(method: str, url: str, obj: Any = None, **kw) -> Any:
    body = None if obj is None else json.dumps(obj).encode()
    return json.loads(_call(method, url, body, **kw) or b"null")


class HttpRun:
    """A run on a tracking server; a context manager that ends it FAILED on
    an exception, like the file store's ``Run``."""

    def __init__(self, base: str, experiment: str, run_id: str):
        self.base = base
        self.experiment = experiment
        self.run_id = run_id
        self._staging = tempfile.mkdtemp(prefix="fraud-run-artifacts-")

    @property
    def _url(self) -> str:
        return f"{self.base}/api/experiments/{self.experiment}/runs/{self.run_id}"

    def log_param(self, key: str, value) -> None:
        _call_json("POST", f"{self._url}/params", {key: str(value)})

    def log_params(self, params: dict) -> None:
        _call_json("POST", f"{self._url}/params", {k: str(v) for k, v in params.items()})

    def log_metric(self, key: str, value: float, step: int | None = None) -> None:
        _call_json(
            "POST", f"{self._url}/metrics",
            [{"key": key, "value": float(value), "step": step}],
        )

    def set_tag(self, key: str, value) -> None:
        _call_json("POST", f"{self._url}/tags", {key: str(value)})

    # -- artifacts: staged locally, uploaded when the run ends --------------
    @property
    def artifacts_dir(self) -> str:
        return self._staging

    def artifact_path(self, *parts: str) -> str:
        p = os.path.join(self._staging, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def _upload_staged(self) -> None:
        for root, _dirs, files in os.walk(self._staging):
            for fn in files:
                full = os.path.join(root, fn)
                rel = os.path.relpath(full, self._staging)
                with open(full, "rb") as f:
                    _call("PUT", f"{self._url}/artifact", f.read(),
                          headers={"x-artifact-path": rel})

    # -- reads: a round trip to the server each ------------------------------
    def _fetch(self) -> dict:
        return _call_json("GET", self._url)

    @property
    def params(self) -> dict:
        return self._fetch()["params"]

    @property
    def metrics(self) -> dict:
        return self._fetch()["metrics"]

    @property
    def tags(self) -> dict:
        return self._fetch()["tags"]

    def latest_metric(self, key: str) -> float | None:
        hist = self.metrics.get(key)
        return hist[-1]["value"] if hist else None

    def end(self, status: str = "FINISHED") -> None:
        self._upload_staged()
        _call_json("POST", f"{self._url}/end", {"status": status})
        shutil.rmtree(self._staging, ignore_errors=True)

    def __enter__(self) -> "HttpRun":
        return self

    def __exit__(self, exc_type, *_):
        self.end("FAILED" if exc_type else "FINISHED")
        return False


class HttpModelRegistry:
    def __init__(self, base: str):
        from fraud_detection_tpu_torch import config

        self.base = base
        host_key = base.split("//", 1)[-1].replace(":", "_").replace("/", "_")
        self.cache = os.path.join(config.registry_cache(), host_key)

    def register(
        self,
        name: str,
        artifact_dir: str,
        run_id: str | None = None,
        metrics: dict | None = None,
        lineage: dict | None = None,
    ) -> int:
        from fraud_detection_tpu_torch.tracking.server import tar_bytes

        headers = {"x-metrics": json.dumps(metrics or {})}
        if lineage:
            headers["x-lineage"] = json.dumps(lineage)
        if run_id:
            headers["x-run-id"] = run_id
        resp = json.loads(_call(
            "POST", f"{self.base}/api/registry/{name}/versions",
            tar_bytes(artifact_dir), headers=headers,
        ))
        return int(resp["version"])

    def set_alias(self, name: str, alias: str, version: int) -> None:
        _call_json("POST", f"{self.base}/api/registry/{name}/aliases",
                   {"alias": alias, "version": int(version)})

    def delete_alias(self, name: str, alias: str) -> bool:
        resp = _call_json("POST", f"{self.base}/api/registry/{name}/aliases",
                          {"alias": alias, "version": None})
        return bool(resp.get("deleted"))

    def aliases(self, name: str) -> dict:
        return _call_json("GET", f"{self.base}/api/registry/{name}/aliases")

    def get_meta(self, name: str, version: int) -> dict:
        """``meta.json`` of a version (downloaded if not cached); {} when
        absent."""
        try:
            path = os.path.join(self.artifact_dir(name, version), "meta.json")
        except TrackingHTTPError:
            return {}
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def get_version_by_alias(self, name: str, alias: str) -> int | None:
        v = self.aliases(name).get(alias)
        return int(v) if v is not None else None

    def latest_version(self, name: str) -> int | None:
        v = _call_json("GET", f"{self.base}/api/registry/{name}/latest")["version"]
        return int(v) if v is not None else None

    def artifact_dir(self, name: str, version: int) -> str:
        """The version's local cache directory, downloaded if absent."""
        from fraud_detection_tpu_torch.tracking.server import untar_bytes

        dest = os.path.join(self.cache, name, str(version))
        if os.path.isdir(dest) and os.listdir(dest):
            return dest
        data = _call("GET", f"{self.base}/api/registry/{name}/versions/{version}")
        tmp = f"{dest}.tmp-{os.getpid()}"
        untar_bytes(data, tmp)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        try:
            os.replace(tmp, dest)  # atomic: concurrent loaders race safely
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.isdir(dest):
                raise
        return dest

    def resolve(self, model_uri: str) -> str:
        """``models:/`` URI → local artifact directory. Raises
        ``FileNotFoundError`` for an unknown model or alias and for an
        unreachable server, as the file registry does for a missing one,
        so the serving loader falls back alike."""
        name, alias, version = parse_model_uri(model_uri)
        try:
            if version is None:
                version = (
                    self.get_version_by_alias(name, alias) if alias
                    else self.latest_version(name)
                )
        except TrackingHTTPError as e:
            raise FileNotFoundError(f"registry unreachable: {e}") from e
        if version is None:
            raise FileNotFoundError(f"no registered version for {model_uri}")
        try:
            return self.artifact_dir(name, version)
        except TrackingHTTPError as e:
            raise FileNotFoundError(str(e)) from e

    def register_if_gate(
        self,
        name: str,
        artifact_dir: str,
        auc: float,
        threshold: float,
        alias: str | None = None,
        run_id: str | None = None,
        lineage: dict | None = None,
    ) -> int | None:
        """Register (and alias) only when ``auc >= threshold``; a NaN AUC
        fails, as in the file registry."""
        if not (auc >= threshold):
            return None
        version = self.register(name, artifact_dir, run_id, {"auc": auc}, lineage=lineage)
        if alias:
            self.set_alias(name, alias, version)
        return version


class HttpTrackingClient:
    def __init__(self, uri: str):
        self.base = uri.rstrip("/")

    def start_run(self, experiment: str | None = None) -> HttpRun:
        from fraud_detection_tpu_torch import config

        exp = experiment or config.experiment_name()
        resp = _call_json("POST", f"{self.base}/api/experiments/{exp}/runs", {})
        return HttpRun(self.base, exp, resp["run_id"])

    def get_run(self, experiment: str, run_id: str) -> HttpRun:
        """Reopen a run; ``FileNotFoundError`` for an unknown one."""
        try:
            _call_json("GET", f"{self.base}/api/experiments/{experiment}/runs/{run_id}")
        except TrackingHTTPError as e:
            raise FileNotFoundError(str(e)) from e
        return HttpRun(self.base, experiment, run_id)

    def list_runs(self, experiment: str) -> list[str]:
        return _call_json("GET", f"{self.base}/api/experiments/{experiment}/runs")["runs"]

    @property
    def registry(self) -> HttpModelRegistry:
        return HttpModelRegistry(self.base)
