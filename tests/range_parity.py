"""One named range scenario through both packages' ``run_scenario`` at the
same seed, on the CPU, held to the port's contract with the reference (the
``tests/test_torch_range_scenarios_*.py`` files share it):

- every invariant ok in both packages, under the same names in the same
  order — with ``latency=False`` every one but ``p99-holds``, a closed-loop
  host-clock probe: the three scenarios whose probe failed in a loaded run
  of these files (:data:`LATENCY_SLOW`) hold it in a ``slow`` test
  instead;
- the deterministic metrics equal (:data:`EXACT`);
- ``detected_row`` within one sampling interval (the fold samples the
  monitor's status every 4 batches: the two detections are the same
  sample point or adjacent ones);
- ``ring_mean_score`` and ``background_mean_score`` within 1e-3, and
  ``mule_count`` within 1e-5 relative.
"""

import numpy as np

from fraud_detection_tpu.range.scenarios import run_scenario as jax_run_scenario
from fraud_detection_tpu_torch.range import traffic
from fraud_detection_tpu_torch.range.scenarios import D, SCENARIOS, run_scenario

#: the metrics a seeded scenario fixes exactly, whatever the timing
EXACT = (
    "rows", "rows_scored", "rows_with_reasons", "victim_state", "failures_injected",
    "drained_state", "ring_rows", "post_swap_compiles", "explain_k", "wire",
    "labels_released", "labels_flipped", "labels_delivered", "poisoned_batches_rejected",
    "store_window_rows", "challenger_version", "resume_outcome",
    "duplicate_promote_outcome", "second_resume", "redeliveries", "poison_fired",
    "mule_slot", "onset_row", "shards", "victim", "drained_shard", "batches",
)
CLOSE = {"ring_mean_score": 1e-3, "background_mean_score": 1e-3}
#: scenarios whose parity check failed in a loaded run: the forest's p99 in
#: one of three ``-n 6`` runs beside heavy files (the port's, over its
#: budget); ``burst``'s and ``explain_under_burst``'s once each in
#: runs of the three scenario files at ``-n 3`` (a JAX p99 of 320.57 ms
#: against 250 ms among them)
LATENCY_SLOW = ("burst", "explain_under_burst", "gbt_explain_under_burst")


def _sample_points(name: str, seed: int = 2026) -> list[int]:
    """The rows at which ``_fold_campaign`` samples the status in
    ``drift_onset`` or ``fraud_ring``: the end of every 4th batch of the
    scenario's campaign (``build_model(seed)``'s ground truth), and the
    last row."""
    w_true = np.random.default_rng(seed).standard_normal(D).astype(np.float32)
    kw = {"total_rows": 6144, "seed": seed, "w_true": w_true}
    if name == "drift_onset":
        kw["drift"] = traffic.DriftCampaign(onset_row=2048, mean_shift=3.0)
    else:
        kw["ring"] = traffic.FraudRing(start_row=1536, n_rings=3, ring_size=96,
                                       every_rows=288, center_scale=5.0)
    ends = []
    for bi, b in enumerate(traffic.CampaignTraffic(traffic.CampaignSpec(**kw)).batches()):
        if bi % 4 == 0:
            ends.append(b.start_row + b.rows.shape[0])
    return ends + [kw["total_rows"]]


def compare(name: str, tmp_path, latency: bool = True) -> tuple[dict, dict]:
    """Run ``name`` through both packages; assert the contract (the
    ``p99-holds`` outcome only with ``latency``); return both results as
    dicts."""
    assert name in SCENARIOS
    if name in ("label_delay", "control_plane_chaos"):
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        jr = jax_run_scenario(name, tmpdir=str(tmp_path / "jax"))
        tr = run_scenario(name, tmpdir=str(tmp_path / "port"), device="cpu")
    else:
        jr = jax_run_scenario(name)
        tr = run_scenario(name, device="cpu")
    jd, td = jr.to_dict(), tr.to_dict()
    print(name, "port", td, "\njax", jd)
    assert list(td["invariants"]) == list(jd["invariants"])
    bad = {k: v for k, v in {**{f"jax {k}": v for k, v in jd["invariants"].items()},
                             **{f"port {k}": v for k, v in td["invariants"].items()}}.items()
           if not v["ok"] and (latency or not k.endswith("p99-holds"))}
    assert not bad, bad
    jm, tm = jd["metrics"], td["metrics"]
    for key in EXACT:
        if key in jm:
            assert tm[key] == jm[key], (key, tm[key], jm[key])
    for key, atol in CLOSE.items():
        if key in jm:
            assert abs(tm[key] - jm[key]) <= atol, (key, tm[key], jm[key])
    if "mule_count" in jm:
        assert abs(tm["mule_count"] - jm["mule_count"]) <= 1e-5 * abs(jm["mule_count"])
    if "detected_row" in jm:
        points = _sample_points(name)
        a, b = points.index(tm["detected_row"]), points.index(jm["detected_row"])
        assert abs(a - b) <= 1, (tm["detected_row"], jm["detected_row"])
    assert set(jm) <= set(tm)
    return jd, td
