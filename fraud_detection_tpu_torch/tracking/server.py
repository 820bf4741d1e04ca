"""Tracking and registry HTTP server.

Serves the file tracking store (``store.py``) and model registry
(``registry.py``) over the port's HTTP framework (``service/http.py``): one
process the trainer, the API and the workers all reach over the network, so
the registry needs no shared filesystem. ``MLFLOW_TRACKING_URI=http://host:
5000`` points every client at it (``http_client.py``). Routes, bodies and
headers are the JAX package's, so either package's client talks to either
package's server. Like the reference's MLflow service it is
unauthenticated: deploy it on the service network.

API (JSON unless noted):

- ``POST /api/experiments/{experiment}/runs``                → ``{run_id}``
- ``POST .../runs/{run_id}/params|metrics|tags``             → merge/append
- ``POST .../runs/{run_id}/end``                             → set status
- ``GET  .../runs``                                          → ``{runs: [...]}``
- ``GET  .../runs/{run_id}``                  → meta+params+metrics+tags
- ``PUT  .../runs/{run_id}/artifact`` (raw body, relative path in the
  ``x-artifact-path`` header)                                → store a file
- ``POST /api/registry/{name}/versions`` (gzipped tar body, optional
  ``x-run-id``/``x-metrics``/``x-lineage`` headers)          → ``{version}``
- ``GET  /api/registry/{name}/versions/{version}``  → gzipped tar of the
  artifact directory
- ``POST /api/registry/{name}/aliases``  ``{alias, version}`` (``version``
  null deletes the alias)
- ``GET  /api/registry/{name}/aliases``       → alias map
- ``GET  /api/registry/{name}/latest``        → ``{version | null}``
- ``GET  /health``                            → liveness

Run: ``python -m fraud_detection_tpu_torch.tracking.server --port 5000
--root /var/lib/fraudtracking``.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import re
import tarfile
import tempfile

from fraud_detection_tpu_torch.service.http import App, HTTPError, Request, Response
from fraud_detection_tpu_torch.tracking.registry import ModelRegistry
from fraud_detection_tpu_torch.tracking.store import Run, TrackingClient

log = logging.getLogger("fraud_detection_tpu_torch.tracking.server")

MAX_BUNDLE = 256 << 20  # artifact bundle ceiling
_SAFE_SEGMENT = re.compile(r"^[A-Za-z0-9._-]+$")


def _safe_members(tar: tarfile.TarFile):
    """Refuse path traversal (absolute paths, ``..``) and anything but
    files and directories in an uploaded bundle."""
    for m in tar.getmembers():
        name = os.path.normpath(m.name)
        if name.startswith(("/", "..")) or os.path.isabs(name):
            raise HTTPError(400, f"unsafe path in bundle: {m.name!r}")
        if not (m.isfile() or m.isdir()):
            raise HTTPError(400, f"unsupported member type: {m.name!r}")
        yield m


def tar_bytes(directory: str) -> bytes:
    """Gzipped tar of ``directory``'s files (paths relative to it)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for root, _dirs, files in os.walk(directory):
            for fn in sorted(files):
                full = os.path.join(root, fn)
                tar.add(full, arcname=os.path.relpath(full, directory))
    return buf.getvalue()


def untar_bytes(data: bytes, dest: str) -> None:
    """Extract a :func:`tar_bytes` bundle into ``dest`` (the member checks,
    then ``filter="data"``, which also strips links and special bits)."""
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        tar.extractall(dest, members=_safe_members(tar), filter="data")


def create_app(root: str) -> App:
    store = TrackingClient(f"file:{root}")
    registry = ModelRegistry(store.root)
    app = App(title="fraud-tracking")

    def _seg(req: Request, key: str) -> str:
        """A path parameter becomes a path segment under the store root:
        one ``[A-Za-z0-9._-]+`` segment, never ``.`` or ``..``."""
        v = req.path_params[key]
        if not _SAFE_SEGMENT.match(v) or v in (".", ".."):
            raise HTTPError(400, f"invalid {key} {v!r}")
        return v

    def _run(req: Request) -> Run:
        try:
            return Run(store.root, _seg(req, "experiment"), _seg(req, "run_id"),
                       create=False)
        except FileNotFoundError as e:
            raise HTTPError(404, str(e)) from e

    @app.get("/health")
    async def health(req: Request) -> Response:
        return Response({"status": "healthy", "root": root})

    # -- runs ---------------------------------------------------------------
    @app.post("/api/experiments/{experiment}/runs")
    async def create_run(req: Request) -> Response:
        run = store.start_run(_seg(req, "experiment"))
        return Response({"run_id": run.run_id})

    @app.get("/api/experiments/{experiment}/runs")
    async def list_runs(req: Request) -> Response:
        return Response({"runs": store.list_runs(_seg(req, "experiment"))})

    @app.get("/api/experiments/{experiment}/runs/{run_id}")
    async def get_run(req: Request) -> Response:
        run = _run(req)
        with open(os.path.join(run.path, "meta.json")) as f:
            meta = json.load(f)
        return Response(
            {"meta": meta, "params": run.params, "metrics": run.metrics, "tags": run.tags}
        )

    @app.post("/api/experiments/{experiment}/runs/{run_id}/params")
    async def log_params(req: Request) -> Response:
        _run(req).log_params(req.json())
        return Response({"ok": True})

    @app.post("/api/experiments/{experiment}/runs/{run_id}/metrics")
    async def log_metrics(req: Request) -> Response:
        run = _run(req)
        for m in req.json():
            run.log_metric(m["key"], m["value"], m.get("step"))
        return Response({"ok": True})

    @app.post("/api/experiments/{experiment}/runs/{run_id}/tags")
    async def set_tags(req: Request) -> Response:
        run = _run(req)
        for k, v in req.json().items():
            run.set_tag(k, v)
        return Response({"ok": True})

    @app.post("/api/experiments/{experiment}/runs/{run_id}/end")
    async def end_run(req: Request) -> Response:
        _run(req).end((req.json() or {}).get("status", "FINISHED"))
        return Response({"ok": True})

    @app.route("PUT", "/api/experiments/{experiment}/runs/{run_id}/artifact")
    async def put_artifact(req: Request) -> Response:
        rel = req.headers.get("x-artifact-path", "")
        norm = os.path.normpath(rel)
        if not rel or norm.startswith(("/", "..")):
            raise HTTPError(400, f"bad x-artifact-path {rel!r}")
        run = _run(req)
        dest = os.path.join(run.artifacts_dir, norm)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as f:
            f.write(req.body)
        return Response({"ok": True, "bytes": len(req.body)})

    # -- registry -----------------------------------------------------------
    @app.post("/api/registry/{name}/versions")
    async def register_version(req: Request) -> Response:
        if len(req.body) > MAX_BUNDLE:
            raise HTTPError(413, "bundle too large")
        metrics = json.loads(req.headers.get("x-metrics", "{}") or "{}")
        lineage = json.loads(req.headers.get("x-lineage", "{}") or "{}")
        with tempfile.TemporaryDirectory() as tmp:
            untar_bytes(req.body, tmp)
            version = registry.register(
                _seg(req, "name"), tmp, run_id=req.headers.get("x-run-id"),
                metrics=metrics, lineage=lineage,
            )
        return Response({"version": version})

    @app.get("/api/registry/{name}/versions/{version}")
    async def get_version(req: Request) -> Response:
        d = registry.artifact_dir(_seg(req, "name"), int(req.path_params["version"]))
        if not os.path.isdir(d):
            raise HTTPError(404, f"no version {req.path_params['version']}")
        return Response(tar_bytes(d), media_type="application/gzip")

    @app.post("/api/registry/{name}/aliases")
    async def set_alias(req: Request) -> Response:
        # an explicit "version": null deletes the alias; a missing key is an
        # error, so a client that forgot the field cannot drop @prod
        body = req.json()
        if "version" not in body:
            raise HTTPError(422, "'version' required (null deletes the alias)")
        if body["version"] is None:
            deleted = registry.delete_alias(_seg(req, "name"), body["alias"])
            return Response({"ok": True, "deleted": deleted})
        registry.set_alias(_seg(req, "name"), body["alias"], int(body["version"]))
        return Response({"ok": True})

    @app.get("/api/registry/{name}/aliases")
    async def get_aliases(req: Request) -> Response:
        return Response(registry.aliases(_seg(req, "name")))

    @app.get("/api/registry/{name}/latest")
    async def latest(req: Request) -> Response:
        return Response({"version": registry.latest_version(_seg(req, "name"))})

    return app


def main(argv=None) -> None:
    from fraud_detection_tpu_torch.service.http import run

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--root", default="./mlruns")
    args = ap.parse_args(argv)
    log.info("tracking server on %s:%d (root %s)", args.host, args.port, args.root)
    run(create_app(args.root), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
