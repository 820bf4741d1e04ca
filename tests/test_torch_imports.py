"""The port stands alone: every module of ``fraud_detection_tpu_torch`` and
``chip_smoke.py`` import in a fresh interpreter where ``jax*``, ``optax``,
the JAX package (``fraud_detection_tpu`` and ``fraud_detection_tpu.*`` —
the port's own name shares that prefix), ``pydantic``/``prometheus_client``,
``msgpack`` (imported only inside ``/ingest/batch``'s msgpack branch),
``yaml`` and ``opentelemetry`` (imported only inside ``promlint`` and
``setup_tracing``) and ``pandas``/``joblib``/``sklearn``/``matplotlib``
all refuse to import."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, importlib.abc, importlib.util, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def __init__(self, test):
        self.test = test
    def find_spec(self, name, path=None, target=None):
        if self.test(name):
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None

def jax_or_reference(name):
    return (name.startswith("jax") or name == "fraud_detection_tpu"
            or name.startswith("fraud_detection_tpu.")
            or name == "optax" or name.startswith("optax."))

def service_deps(name):
    return any(name == m or name.startswith(m + ".")
               for m in ("pydantic", "prometheus_client", "pandas", "joblib",
                         "sklearn", "matplotlib", "msgpack", "yaml", "opentelemetry"))

sys.meta_path[:0] = [Refuse(jax_or_reference), Refuse(service_deps)]
import fraud_detection_tpu_torch as pkg
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if jax_or_reference(m) or service_deps(m))
assert not leaked, leaked
print("IMPORTED", len(names))
'''


def test_port_imports_with_jax_reference_and_service_deps_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.split("IMPORTED")[1])
    assert n >= 117  # every module of the slices so far, not a stub package


def test_training_modules_are_among_those_imported():
    """The blocked-import probe walks the package; the training, GBT,
    explain, offline-tool, ingest, ledger, wide-family, lifecycle, lifeboat,
    network-store, telemetry, serving-mesh, sharded-training and model-axis
    slices' modules are in it."""
    import pkgutil

    import fraud_detection_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    for mod in ("train", "data.loader", "ops.smote", "ops.metrics", "ops.quant",
                "ckpt.train_state", "tracking.store", "tracking.registry",
                "ops.gbt", "ops.tree_shap", "models.gbt", "service.db",
                "service.taskq", "service.worker", "service.errors",
                "preprocess", "evaluate", "explain", "predict_single", "validate_auc",
                "eda", "plots", "data.synthetic", "tracking.server",
                "tracking.http_client", "service.loading", "data.native",
                "telemetry", "telemetry.timeline", "telemetry.flightrecorder",
                "service.binlane", "service.legacy", "monitor.shadow",
                "ledger", "ledger.state", "ledger.features", "ledger.replay",
                "ops.crosses", "mesh", "mesh.retrain",
                "lifecycle", "lifecycle.store", "lifecycle.gate", "lifecycle.retrain",
                "lifecycle.swap", "lifecycle.conductor", "range", "range.faults",
                "utils", "utils.lockdep", "lifeboat", "lifeboat.journal",
                "lifeboat.snapshot", "lifeboat.recovery", "lifeboat.boat",
                "service.wire", "service.netserver", "service.netclient",
                "service.sentinel", "service.storectl", "service.migrate",
                "service.pgwire", "service.pgclient", "service.tracing",
                "telemetry.slo", "telemetry.roofline", "telemetry.compile_sentinel",
                "telemetry.devicemem", "telemetry.profiler", "utils.profiling",
                "utils.jsonlog", "monitor.promlint", "parallel", "parallel.mesh",
                "parallel.sharding", "mesh.topology", "mesh.shardflush", "mesh.front",
                "ledger.placement", "parallel.collectives", "shardfit", "train_turns",
                "ops.logistic", "ops.scorer", "monitor.drift", "service.microbatch",
                "service.app", "config", "range.traffic", "range.invariants",
                "range.scenarios"):
        assert f"fraud_detection_tpu_torch.{mod}" in names


def test_range_modules_import_with_jax_and_service_deps_blocked():
    """The range's traffic, invariants and scenarios import in a fresh
    interpreter with JAX, the JAX package and the service dependencies
    blocked; ``range`` and ``range.faults`` (which the serving flush and
    the task queue import) leave ``torch`` and ``numpy`` unimported, and
    ``range``'s lazy exports resolve."""
    probe = _PROBE.split("import fraud_detection_tpu_torch as pkg")[0] + (
        "import fraud_detection_tpu_torch.range as rng\n"
        "import fraud_detection_tpu_torch.range.faults\n"
        "light = sorted(m for m in ('torch', 'numpy') if m in sys.modules)\n"
        "assert rng.FaultPlan is fraud_detection_tpu_torch.range.faults.FaultPlan\n"
        "for name in ('traffic', 'invariants', 'scenarios'):\n"
        "    importlib.import_module('fraud_detection_tpu_torch.range.' + name)\n"
        "assert len(rng.SCENARIOS) == 11 and callable(rng.run_scenario)\n"
        "assert rng.ScenarioResult.__module__.endswith('range.invariants')\n"
        "leaked = sorted(m for m in sys.modules if jax_or_reference(m) or service_deps(m))\n"
        "assert not leaked, leaked\n"
        "print('LIGHT', light)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("LIGHT []")


def test_store_tier_imports_no_torch():
    """A store server, a sentinel and the network and PostgreSQL clients
    need no card: importing them (and the factories that reach them) in a
    fresh interpreter leaves ``torch`` and ``numpy`` unimported."""
    probe = (
        "import sys\n"
        "from fraud_detection_tpu_torch.service import netserver, sentinel, netclient, "
        "pgclient, storectl, migrate\n"
        "from fraud_detection_tpu_torch.service.db import ResultsDB\n"
        "from fraud_detection_tpu_torch.service.taskq import Broker\n"
        "assert isinstance(Broker('fraud://127.0.0.1:1'), netclient.NetBroker)\n"
        "assert isinstance(ResultsDB('sentinel://127.0.0.1:1/m'), netclient.NetResultsDB)\n"
        "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""  # no result line
    assert "cuda" in out.stderr.lower()
