"""File-based experiment tracking store, in the JAX package's layout.

Rooted at the ``file:`` tracking URI::

    <root>/
      experiments/<experiment>/runs/<run_id>/
        meta.json      {run_id, experiment, start_time, end_time, status}
        params.json    {name: str}
        metrics.json   {name: [{value, step, timestamp}, ...]}
        tags.json      {name: str}
        artifacts/     free-form files (model dirs, ...)
      registry/        (see registry.py)

Writes are atomic (tmp + rename), so concurrent runs and readers never see
a torn file. Standard library only.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any


def _atomic_write_json(path: str, obj: Any) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:6]}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=str)
    os.replace(tmp, path)


def _read_json(path: str, default: Any) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return default


def parse_file_uri(uri: str) -> str:
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if uri.startswith("file:"):
        return uri[len("file:"):]
    return uri


class Run:
    """An active (or reopened) tracking run."""

    def __init__(
        self,
        root: str,
        experiment: str,
        run_id: str | None = None,
        create: bool = True,
    ):
        self.experiment = experiment
        self.run_id = run_id or uuid.uuid4().hex
        self.path = os.path.join(root, "experiments", experiment, "runs", self.run_id)
        if not create and not os.path.isdir(self.path):
            raise FileNotFoundError(
                f"run {self.run_id} not found in experiment {experiment}"
            )
        os.makedirs(os.path.join(self.path, "artifacts"), exist_ok=True)
        meta_path = os.path.join(self.path, "meta.json")
        if not os.path.exists(meta_path):
            _atomic_write_json(
                meta_path,
                {
                    "run_id": self.run_id,
                    "experiment": experiment,
                    "start_time": time.time(),
                    "end_time": None,
                    "status": "RUNNING",
                },
            )

    def _update(self, name: str, fn) -> None:
        p = os.path.join(self.path, name)
        cur = _read_json(p, {})
        fn(cur)
        _atomic_write_json(p, cur)

    # -- logging -----------------------------------------------------------
    def log_param(self, key: str, value) -> None:
        self._update("params.json", lambda d: d.__setitem__(key, str(value)))

    def log_params(self, params: dict) -> None:
        self._update(
            "params.json", lambda d: d.update({k: str(v) for k, v in params.items()})
        )

    def log_metric(self, key: str, value: float, step: int | None = None) -> None:
        entry = {"value": float(value), "step": step, "timestamp": time.time()}
        self._update("metrics.json", lambda d: d.setdefault(key, []).append(entry))

    def set_tag(self, key: str, value) -> None:
        self._update("tags.json", lambda d: d.__setitem__(key, str(value)))

    # -- artifacts ---------------------------------------------------------
    @property
    def artifacts_dir(self) -> str:
        return os.path.join(self.path, "artifacts")

    def artifact_path(self, *parts: str) -> str:
        p = os.path.join(self.artifacts_dir, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    # -- lifecycle ---------------------------------------------------------
    def end(self, status: str = "FINISHED") -> None:
        self._update("meta.json", lambda d: d.update(end_time=time.time(), status=status))

    # -- reads -------------------------------------------------------------
    @property
    def params(self) -> dict:
        return _read_json(os.path.join(self.path, "params.json"), {})

    @property
    def metrics(self) -> dict:
        return _read_json(os.path.join(self.path, "metrics.json"), {})

    @property
    def tags(self) -> dict:
        return _read_json(os.path.join(self.path, "tags.json"), {})

    def latest_metric(self, key: str) -> float | None:
        hist = self.metrics.get(key)
        return hist[-1]["value"] if hist else None

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, exc_type, *_):
        self.end("FAILED" if exc_type else "FINISHED")
        return False


class TrackingClient:
    """The file store: experiments, runs, and the registry handle."""

    def __init__(self, uri: str | None = None):
        from fraud_detection_tpu_torch import config

        self.root = parse_file_uri(uri or config.tracking_uri())
        os.makedirs(self.root, exist_ok=True)

    def start_run(self, experiment: str | None = None) -> Run:
        from fraud_detection_tpu_torch import config

        return Run(self.root, experiment or config.experiment_name())

    def get_run(self, experiment: str, run_id: str) -> Run:
        """Reopen an existing run; raises FileNotFoundError on unknown ids."""
        return Run(self.root, experiment, run_id, create=False)

    def list_runs(self, experiment: str) -> list[str]:
        d = os.path.join(self.root, "experiments", experiment, "runs")
        try:
            return sorted(os.listdir(d))
        except FileNotFoundError:
            return []

    @property
    def registry(self):
        from fraud_detection_tpu_torch.tracking.registry import ModelRegistry

        return ModelRegistry(self.root)
