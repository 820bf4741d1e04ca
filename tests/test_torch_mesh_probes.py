"""The port's two mesh probes (``mesh/bench.py``, ``mesh/widebench.py``) on
the CPU beside the JAX package's, at the smallest bucket both packages'
gates hold at (64: JAX's own parity fails at buckets 8 and 16), one rep:
the same keys, every parity, allocation and ``*_exact`` gate true in
both, every size and grid measured, the model shard's bytes JAX's, the
single-device reference flushes within 1e-6 of JAX's on the same data,
and one ``fused_score`` dispatch a scoring call the probe counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fraud_detection_tpu.mesh import bench as jax_bench
from fraud_detection_tpu.mesh import widebench as jax_widebench
from fraud_detection_tpu.monitor.drift import DriftMonitor as JaxDriftMonitor
from fraud_detection_tpu_torch.mesh import bench, widebench
from fraud_detection_tpu_torch.monitor.drift import DriftMonitor
from fraud_detection_tpu_torch.ops import kernels

torch.set_num_threads(1)

BUCKET = 64
GATES = {
    "bench": ("mesh_parity_ok", "mesh_quant_parity_ok"),
    "widebench": ("wide_parity_ok", "wide_model_shards_exact"),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, mine, theirs in (("bench", bench, jax_bench),
                               ("widebench", widebench, jax_widebench)):
        mine.COUNTS.update(dict.fromkeys(mine.COUNTS, 0))
        kernels.reset_dispatch_counts()
        port = mine.run(bucket=BUCKET, reps=1, device="cpu")
        scored = sum(mine.COUNTS.values())
        dispatched = kernels.dispatch_counts()["fused_score"]
        out[name] = (port, theirs.run(bucket=BUCKET, reps=1), scored, dispatched)
    return out


@pytest.mark.parametrize("name", sorted(GATES))
def test_the_keys_and_the_gates_are_jaxs(runs, name):
    port, jax_out, _, _ = runs[name]
    assert set(port) == set(jax_out)
    for gate in GATES[name]:
        assert port[gate] is True and jax_out[gate] is True, gate
    assert port["bucket"] == jax_out["bucket"] == BUCKET
    assert port["device_count"] == 1 and jax_out["device_count"] == 8


def test_bench_measures_every_size(runs):
    port, jax_out, _, _ = runs["bench"]
    assert port["mesh_sizes_measured"] == jax_out["mesh_sizes_measured"] == [1, 2, 4, 8]
    assert set(port["mesh_flushes_per_sec"]) == {"1", "2", "4", "8"}
    assert all(v > 0 for v in port["mesh_flushes_per_sec"].values())
    assert bench.MONOTONE_SLACK == jax_bench.MONOTONE_SLACK


def test_widebench_measures_every_grid_and_shards_the_table_exactly(runs):
    port, jax_out, _, _ = runs["widebench"]
    assert port["wide_shapes_measured"] == jax_out["wide_shapes_measured"] == \
        ["2x2", "4x2", "2x4"]
    assert port["wide_staging_steady_allocations"] == 0
    assert jax_out["wide_staging_steady_allocations"] == 0
    assert port["wide_model_shard_bytes"] == jax_out["wide_model_shard_bytes"] == \
        {"1": 65536, "2": 32768, "4": 16384}
    assert set(port["wide_model_axis_flushes_per_sec"]) == {"1", "2", "4"}
    assert port["wide_buckets"] == jax_out["wide_buckets"] == 1 << 14
    assert (port["wide_cpu_floor"], port["wide_model_cpu_floor"]) == \
        (jax_widebench.WIDE_CPU_FLOOR, jax_widebench.WIDE_MODEL_CPU_FLOOR)


@pytest.mark.parametrize("name", sorted(GATES))
def test_a_fused_score_dispatch_a_counted_scoring(runs, name):
    _, _, scored, dispatched = runs[name]
    assert scored > 0 and dispatched == scored


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_the_single_device_reference_is_jaxs(quant):
    data, scorer, quant_scorer, profile = bench._build(n_rows=BUCKET, device="cpu")
    jdata, jscorer, jquant, jprofile = jax_bench._build(n_rows=BUCKET)
    np.testing.assert_array_equal(data, jdata)
    rows = [data[i] for i in range(BUCKET)]
    got = bench._flush_once(quant_scorer if quant else scorer,
                            DriftMonitor(profile, device="cpu"), rows)
    want = jax_bench._flush_once(jquant if quant else jscorer, JaxDriftMonitor(jprofile), rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_the_wide_reference_is_jaxs():
    data, fps, wide, _, wprof, _ = widebench._build(n_rows=BUCKET, device="cpu")
    jdata, jfps, jwide, _, jwprof, _ = jax_widebench._build(n_rows=BUCKET)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(fps, jfps)
    s, ei, ev = widebench._wide_flush_once(wide, DriftMonitor(wprof, device="cpu"), data, fps)
    js, jei, jev = jax_widebench._wide_flush_once(jwide, JaxDriftMonitor(jwprof), jdata, jfps)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ei.astype(np.int64), np.asarray(jei).astype(np.int64))
    np.testing.assert_allclose(ev, jev, rtol=0, atol=1e-5)
