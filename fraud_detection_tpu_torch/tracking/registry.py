"""Model registry with versioned models and alias-based resolution, in the
JAX package's layout (either package reads the other's registry).

``<root>/registry/<name>/versions/<N>/`` holds a copy of the model artifact
directory plus ``meta.json``; ``aliases.json`` maps alias → version.
:meth:`ModelRegistry.register_if_gate` is the AUC promotion gate.
"""

from __future__ import annotations

import os
import re
import shutil
import time

from fraud_detection_tpu_torch.tracking.store import _atomic_write_json, _read_json

# models:/name@alias | models:/name/3 | models:/name/Production (a
# non-numeric tail is an alias) | models:/name
_MODEL_URI = re.compile(
    r"^models:/(?P<name>[^@/]+)(@(?P<alias>[^/]+))?"
    r"(/(?P<version>\d+)|/(?P<stage>[^/]+))?$"
)


def parse_model_uri(model_uri: str) -> tuple[str, str | None, int | None]:
    """``models:/...`` → (name, alias, version). Raises ValueError on other
    URIs and on ``@alias`` combined with a non-numeric tail."""
    m = _MODEL_URI.match(model_uri)
    if not m:
        raise ValueError(f"not a models:/ URI: {model_uri}")
    alias, stage = m.group("alias"), m.group("stage")
    if alias and stage:
        raise ValueError(
            f"ambiguous models:/ URI (both @{alias} and /{stage}): {model_uri}"
        )
    version = int(m.group("version")) if m.group("version") else None
    return m.group("name"), alias or stage, version


class ModelRegistry:
    def __init__(self, root: str):
        self.root = os.path.join(root, "registry")
        os.makedirs(self.root, exist_ok=True)

    def _model_dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _aliases_path(self, name: str) -> str:
        return os.path.join(self._model_dir(name), "aliases.json")

    def _versions(self, name: str) -> list[int]:
        try:
            entries = os.listdir(os.path.join(self._model_dir(name), "versions"))
        except FileNotFoundError:
            return []
        return [int(v) for v in entries if v.isdigit()]

    # -- writes ------------------------------------------------------------
    def register(
        self,
        name: str,
        artifact_dir: str,
        run_id: str | None = None,
        metrics: dict | None = None,
        lineage: dict | None = None,
    ) -> int:
        """Copy ``artifact_dir`` in as the next version; returns its number.
        ``lineage`` (parent version, data, ...) goes into ``meta.json``."""
        version = max(self._versions(name), default=0) + 1
        dest = self.artifact_dir(name, version)
        shutil.copytree(artifact_dir, dest)
        _atomic_write_json(
            os.path.join(dest, "meta.json"),
            {
                "name": name,
                "version": version,
                "run_id": run_id,
                "metrics": metrics or {},
                "lineage": lineage or {},
                "created_at": time.time(),
            },
        )
        return version

    def set_alias(self, name: str, alias: str, version: int) -> None:
        path = self._aliases_path(name)
        aliases = _read_json(path, {})
        aliases[alias] = int(version)
        _atomic_write_json(path, aliases)

    def delete_alias(self, name: str, alias: str) -> bool:
        """Drop an alias; the versions stay. False when it did not exist."""
        path = self._aliases_path(name)
        aliases = _read_json(path, {})
        if alias not in aliases:
            return False
        del aliases[alias]
        _atomic_write_json(path, aliases)
        return True

    def aliases(self, name: str) -> dict:
        """The alias → version map ({} for an unknown model)."""
        return _read_json(self._aliases_path(name), {})

    # -- reads -------------------------------------------------------------
    def get_version_by_alias(self, name: str, alias: str) -> int | None:
        v = self.aliases(name).get(alias)
        return int(v) if v is not None else None

    def latest_version(self, name: str) -> int | None:
        return max(self._versions(name), default=None)

    def artifact_dir(self, name: str, version: int) -> str:
        return os.path.join(self._model_dir(name), "versions", str(version))

    def get_meta(self, name: str, version: int) -> dict:
        """``meta.json`` of a version; {} when absent."""
        return _read_json(
            os.path.join(self.artifact_dir(name, version), "meta.json"), {}
        )

    def resolve(self, model_uri: str) -> str:
        """``models:/name@alias`` | ``models:/name/3`` | ``models:/name/stage``
        | ``models:/name`` (latest) → the artifact directory. Raises
        FileNotFoundError when the model or alias does not exist."""
        name, alias, version = parse_model_uri(model_uri)
        if version is None:
            version = (
                self.get_version_by_alias(name, alias) if alias
                else self.latest_version(name)
            )
        if version is None:
            raise FileNotFoundError(f"no registered version for {model_uri}")
        d = self.artifact_dir(name, version)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"registry artifact missing: {d}")
        return d

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
        """Register (and alias) only when ``auc >= threshold``; returns the
        version or None. Written so that a NaN AUC fails the gate."""
        if not (auc >= threshold):
            return None
        version = self.register(
            name, artifact_dir, run_id, {"auc": auc}, lineage=lineage
        )
        if alias:
            self.set_alias(name, alias, version)
        return version
