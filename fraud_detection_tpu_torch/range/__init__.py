"""The fraud range: adversarial traffic simulation and closed-loop chaos.

Submodules, imported lazily: production code imports ``range.faults``
alone, which must stay stdlib-light because its ``fire()`` hook sits on
the serving flush:

- :mod:`fraud_detection_tpu_torch.range.faults` — the :class:`FaultPlan`
  injector behind the named injection points in lifecycle/conductor.py,
  lifecycle/store.py, service/taskq.py, service/netclient.py,
  service/microbatch.py, mesh/front.py and lifeboat/;
- :mod:`fraud_detection_tpu_torch.range.traffic` — seeded campaign
  generators (diurnal bursts, drift onsets, fraud rings, label delay and
  noise);
- :mod:`fraud_detection_tpu_torch.range.invariants` — the end-to-end
  invariant checks and the alert-flap detector;
- :mod:`fraud_detection_tpu_torch.range.scenarios` — the named scenario
  suite (``run_scenario``) against the live in-process stack.
"""

from __future__ import annotations

_LAZY = {
    "FaultPlan": ("fraud_detection_tpu_torch.range.faults", "FaultPlan"),
    "ReplicaKilled": ("fraud_detection_tpu_torch.range.faults", "ReplicaKilled"),
    "ScenarioResult": (
        "fraud_detection_tpu_torch.range.invariants", "ScenarioResult"
    ),
    "SCENARIOS": ("fraud_detection_tpu_torch.range.scenarios", "SCENARIOS"),
    "run_scenario": ("fraud_detection_tpu_torch.range.scenarios", "run_scenario"),
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
