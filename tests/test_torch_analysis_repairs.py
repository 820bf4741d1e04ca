"""The three departures the JAX package's rules found in the port, repaired,
on the CPU.

- ``shardfit`` writes its ``rank<r>.npz`` through ``ckpt/atomic``: no
  temporary file is left beside it and its arrays are those ``np.savez``
  wrote, bit for bit;
- the worker's batched explain (a hot path) builds its rows list in the
  prepare loop, with no comprehension, as JAX's does;
- ``netserver.store_metrics`` registers each ``fraud_store_*`` series by
  its literal name: the exposition is byte for byte what the local helper
  made, and both alert rules see the names.
"""

from __future__ import annotations

import ast
import os
from types import SimpleNamespace

import numpy as np
import torch

from fraud_detection_tpu.analysis import core as jax_core
from fraud_detection_tpu_torch import shardfit
from fraud_detection_tpu_torch.analysis.core import analyze_file, get_rule
from fraud_detection_tpu_torch.analysis.rules_monitoring import registered_metric_names
from fraud_detection_tpu_torch.service import metrics, netserver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fraud_detection_tpu_torch")

#: the store exporter's exposition as the local helper made it, for a
#: primary at seq 17, epoch 4, 3 queued, 2 redeliveries, 1 expired claim
STORE_EXPOSITION = """\
# HELP fraud_store_queue_depth Deliverable task backlog on this store server (KEDA signal)
# TYPE fraud_store_queue_depth gauge
fraud_store_queue_depth 3.0
# HELP fraud_store_is_primary 1 when this server is the writable primary
# TYPE fraud_store_is_primary gauge
fraud_store_is_primary 1.0
# HELP fraud_store_replication_seq Replication sequence number (replica lag = primary - replica)
# TYPE fraud_store_replication_seq gauge
fraud_store_replication_seq 17.0
# HELP fraud_store_failover_epoch Failover epoch (bumps on every promote; divergence across \
the tier means a stale reign is still serving)
# TYPE fraud_store_failover_epoch gauge
fraud_store_failover_epoch 4.0
# HELP fraud_store_taskq_redeliveries_total Task deliveries beyond the first served by this \
store (visibility-timeout expiry or nack retry)
# TYPE fraud_store_taskq_redeliveries_total gauge
fraud_store_taskq_redeliveries_total 2.0
# HELP fraud_store_taskq_expired_claims_total Claims whose visibility window lapsed before \
ack/nack on this store (worker death or stall mid-task)
# TYPE fraud_store_taskq_expired_claims_total gauge
fraud_store_taskq_expired_claims_total 1.0
"""


def test_the_rank_file_lands_atomically_with_the_same_bits(tmp_path, monkeypatch):
    monkeypatch.setenv("DEVICE", "cpu")
    written = {}
    real = shardfit.atomic_savez

    def recording(path, **arrays):
        written.update(arrays)
        return real(path, **arrays)

    monkeypatch.setattr(shardfit, "atomic_savez", recording)
    out = tmp_path / "out"
    assert shardfit.main(["--fit", "psum", "--fit", "scaler", "--rows", "256", "--shards", "2",
                          "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["rank0.npz"]  # no temporary file left
    np.savez(tmp_path / "plain.npz", **written)
    with np.load(out / "rank0.npz") as got, np.load(tmp_path / "plain.npz") as want:
        assert sorted(got.files) == sorted(want.files) and got.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    rule = [get_rule("artifact-nonatomic-write")]
    assert analyze_file(os.path.join(PORT, "shardfit.py"), root=ROOT, rules=rule) == []


def test_the_workers_batched_explain_builds_its_rows_without_a_comprehension():
    with open(os.path.join(PORT, "service", "worker.py")) as f:
        tree = ast.parse(f.read())
    (fn,) = [n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == "compute_shap_many"]
    assert not [n for n in ast.walk(fn) if isinstance(n, (ast.ListComp, ast.DictComp,
                                                          ast.SetComp, ast.GeneratorExp))]
    stacks = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
              and ast.unparse(n.func) == "np.stack"]
    assert [ast.unparse(n.args[0]) for n in stacks] == ["prepared_rows"]
    assert all(any(k.arg == "out" for k in n.keywords) for n in stacks)
    rules = [get_rule("hot-path-json"), get_rule("hot-path-alloc")]
    assert analyze_file(os.path.join(PORT, "service", "worker.py"), root=ROOT,
                        rules=rules) == []


def test_the_store_exposition_is_unchanged_and_the_alert_rules_see_it():
    srv = SimpleNamespace(broker=SimpleNamespace(depth=lambda: 3, redeliveries=2,
                                                 expired_claims=1),
                          role=netserver.PRIMARY, seq=17, epoch=4)
    assert metrics.render(netserver.store_metrics(srv)).decode() == STORE_EXPOSITION
    with open(os.path.join(PORT, "service", "netserver.py")) as f:
        names = registered_metric_names(ast.parse(f.read()))
    assert {"fraud_store_queue_depth", "fraud_store_is_primary", "fraud_store_replication_seq",
            "fraud_store_failover_epoch"} <= names
    path = os.path.join(PORT, "service", "metrics.py")
    assert analyze_file(path, root=ROOT, rules=[get_rule("alert-metric-registered")]) == []
    # JAX's rule, over the port's exporter, as well
    assert jax_core.analyze_file(path, root=ROOT,
                                 rules=[jax_core.get_rule("alert-metric-registered")]) == []
