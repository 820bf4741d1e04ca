"""analysis — checks the port holds its own code to.

The port's counterpart of the JAX package's ``analysis/``, by intent and
not by mechanism: the JAX package proves its contracts on jaxprs, the port
runs eagerly and counts, and reads its own source. One CLI,
``python -m fraud_detection_tpu_torch.analysis`` (:mod:`.__main__`):

- **the static rules** — :mod:`.core`, the AST engine (findings, the rule
  registry, the parsed module with its captured bodies, its ``# lockcheck:
  ignore[...]`` sanctions and its ``# lockcheck: hot-path`` markers), and
  the rule modules that fill its registry when imported here:
  :mod:`.rules_service` (sockets without timeouts, silent handlers,
  threads never joined, metrics off the shared registry's module, retry
  loops without backoff), :mod:`.rules_artifacts` (in-place writes of a
  trusted artifact), :mod:`.rules_monitoring` (alert rules naming a dead
  series), :mod:`.rules_perf` (allocation and per-row work on the hot
  paths), :mod:`.rules_capture` (host syncs, closures and escaping stores
  in a captured body) and :mod:`.lockcheck`'s ``blocking-under-lock`` and
  ``lock-in-capture``. Findings are gated against
  ``analysis/baseline.json`` (:mod:`.baseline`) and reported as text or
  JSON (:mod:`.report`);
- **the program contracts** (``--contracts``) — :mod:`.contracts`: the
  collective budgets (``parallel.collectives``' counts a unit at several
  shard counts and grids, :func:`~.contracts.check_budgets`) and the
  program half — kernel calls a unit, no host sync in a flush
  (:mod:`.hostsync` reads the bodies), output dtypes, state in place
  (:func:`~.contracts.check_programs`) — each returning its violations as
  stable strings;
- **the lock discipline** (``--contracts`` runs it too) —
  :mod:`.locknames`, :mod:`.lockcheck`: the named-lock inventory, the
  static acquisition-order graph and its drift
  (:func:`~.lockcheck.build_lock_report`);
- **the shape pass** (``--contracts``, ``--shape-check-only``) —
  :mod:`.meshcheck`: every program at every mesh size at JAX's meshcheck
  shapes, one result row each.

Beside the CLI, :mod:`.trajectory` gates a bench trajectory (standard
library only). The contracts' names resolve on first use, so the rules,
the lock pass and the trajectory import no ``torch``.
"""

_CONTRACTS = ("BUDGETS", "PROGRAMS", "Budget", "Program", "check_budgets", "check_programs")


def __getattr__(name: str):
    if name not in _CONTRACTS:
        raise AttributeError(name)
    from fraud_detection_tpu_torch.analysis import contracts

    return getattr(contracts, name)


from fraud_detection_tpu_torch.analysis.core import (  # noqa: F401,E402
    Finding,
    ModuleInfo,
    Rule,
    Severity,
    analyze_file,
    analyze_paths,
    get_rule,
    iter_rules,
    register_rule,
)

# Importing the rule modules fills the registry.
from fraud_detection_tpu_torch.analysis import lockcheck  # noqa: F401,E402
from fraud_detection_tpu_torch.analysis import rules_artifacts  # noqa: F401,E402
from fraud_detection_tpu_torch.analysis import rules_capture  # noqa: F401,E402
from fraud_detection_tpu_torch.analysis import rules_monitoring  # noqa: F401,E402
from fraud_detection_tpu_torch.analysis import rules_perf  # noqa: F401,E402
from fraud_detection_tpu_torch.analysis import rules_service  # noqa: F401,E402
