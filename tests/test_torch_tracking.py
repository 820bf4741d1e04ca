"""The port's file tracking store and model registry against the JAX
package's: the same layout, so each package reads what the other wrote."""

import json
import math
import os

import pytest
import torch

from fraud_detection_tpu.tracking import TrackingClient as JaxTrackingClient
from fraud_detection_tpu_torch.tracking import (
    FileTrackingClient,
    ModelRegistry,
    TrackingClient,
)
from fraud_detection_tpu_torch.tracking.registry import parse_model_uri

torch.set_num_threads(1)


def _artifact(path, payload="x"):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.npz"), "w") as f:
        f.write(payload)
    return str(path)


def test_run_logging_layout_is_the_jax_layout(tmp_path):
    client = TrackingClient(f"file:{tmp_path}")
    assert isinstance(client, FileTrackingClient)
    with client.start_run("exp") as run:
        run.log_params({"seed": 42, "solver": "auto"})
        run.log_param("auc_threshold", 0.95)
        run.log_metric("cv_auc", 0.9, step=0)
        run.log_metric("cv_auc", 0.8, step=1)
        run.set_tag("registered_version", 1)
        art = run.artifact_path("model", "model.npz")
    assert os.path.dirname(art) == os.path.join(run.artifacts_dir, "model")
    # the JAX package reopens the run and reads the same values
    jrun = JaxTrackingClient(f"file:{tmp_path}").get_run("exp", run.run_id)
    assert jrun.params == {"seed": "42", "solver": "auto", "auc_threshold": "0.95"}
    assert [m["value"] for m in jrun.metrics["cv_auc"]] == [0.9, 0.8]
    assert jrun.latest_metric("cv_auc") == 0.8
    assert jrun.tags == {"registered_version": "1"}
    with open(os.path.join(run.path, "meta.json")) as f:
        assert json.load(f)["status"] == "FINISHED"
    assert client.list_runs("exp") == [run.run_id]
    with pytest.raises(FileNotFoundError):
        client.get_run("exp", "nope")


def test_failed_run_is_marked(tmp_path):
    client = TrackingClient(str(tmp_path))
    with pytest.raises(RuntimeError):
        with client.start_run("exp") as run:
            raise RuntimeError("boom")
    with open(os.path.join(run.path, "meta.json")) as f:
        assert json.load(f)["status"] == "FAILED"


@pytest.mark.parametrize("auc", [float("nan"), 0.949, 0.95, 0.99])
def test_gate_registers_only_at_or_above_threshold(tmp_path, auc):
    """NaN fails the gate (it would sail through a ``<`` comparison)."""
    reg = ModelRegistry(str(tmp_path))
    v = reg.register_if_gate("fraud", _artifact(tmp_path / "a"), auc, 0.95, alias="prod")
    passes = not math.isnan(auc) and auc >= 0.95
    assert v == (1 if passes else None)
    assert reg.get_version_by_alias("fraud", "prod") == v
    if passes:
        assert reg.resolve("models:/fraud@prod") == reg.artifact_dir("fraud", 1)
        assert reg.get_meta("fraud", 1)["metrics"] == {"auc": auc}
    else:
        with pytest.raises(FileNotFoundError):
            reg.resolve("models:/fraud@prod")


def test_registry_versions_aliases_and_cross_package_reads(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.register("fraud", _artifact(tmp_path / "a", "one"), run_id="r1")
    v2 = reg.register("fraud", _artifact(tmp_path / "b", "two"),
                      lineage={"parent_version": 1})
    assert (v1, v2) == (1, 2) and reg.latest_version("fraud") == 2
    reg.set_alias("fraud", "prod", 1)
    reg.set_alias("fraud", "shadow", 2)
    assert reg.resolve("models:/fraud@prod").endswith(os.path.join("versions", "1"))
    assert reg.resolve("models:/fraud/2") == reg.artifact_dir("fraud", 2)
    assert reg.resolve("models:/fraud/shadow") == reg.artifact_dir("fraud", 2)
    assert reg.resolve("models:/fraud") == reg.artifact_dir("fraud", 2)
    # the JAX registry resolves the port's aliases and reads its lineage
    jreg = JaxTrackingClient(f"file:{tmp_path}").registry
    assert jreg.resolve("models:/fraud@prod") == reg.resolve("models:/fraud@prod")
    assert jreg.get_meta("fraud", 2)["lineage"] == {"parent_version": 1}
    # and the port reads what the JAX registry writes
    assert jreg.register("fraud", _artifact(tmp_path / "c")) == 3
    jreg.set_alias("fraud", "prod", 3)
    assert reg.resolve("models:/fraud@prod") == reg.artifact_dir("fraud", 3)
    with pytest.raises(FileNotFoundError):
        reg.resolve("models:/other@prod")


@pytest.mark.parametrize(
    "uri, parsed",
    [
        ("models:/fraud@prod", ("fraud", "prod", None)),
        ("models:/fraud/3", ("fraud", None, 3)),
        ("models:/fraud/Production", ("fraud", "Production", None)),
        ("models:/fraud", ("fraud", None, None)),
    ],
)
def test_model_uri_parsing(uri, parsed):
    assert parse_model_uri(uri) == parsed


@pytest.mark.parametrize("bad", ["runs:/x", "models:/fraud@prod/v2"])
def test_model_uri_rejects(bad):
    with pytest.raises(ValueError):
        parse_model_uri(bad)

