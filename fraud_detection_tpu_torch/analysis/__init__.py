"""analysis — checks the port holds its own code to.

The port's counterpart of the JAX package's ``analysis/``, by intent and
not by mechanism: the JAX package proves its contracts on jaxprs, the port
runs eagerly and counts, and reads its own source. What is here so far:

- :mod:`.contracts` — every program's contract: the collective budgets
  (``parallel.collectives``' counts a unit at several shard counts and
  grids, :func:`~.contracts.check_budgets`) and the program half — kernel
  calls a unit, no host sync in a flush, output dtypes, state in place
  (:func:`~.contracts.check_programs`) — each returning its violations as
  stable strings;
- :mod:`.core` — the AST engine: findings, the rule registry, the parsed
  module with its captured bodies and ``# lockcheck: ignore[...]``
  sanctions;
- :mod:`.locknames`, :mod:`.lockcheck` — the named-lock inventory, the
  static acquisition-order graph and its drift, and the
  ``blocking-under-lock`` and ``lock-in-capture`` rules
  (:func:`~.lockcheck.build_lock_report`);
- :mod:`.hostsync` — the static host-sync rule the flush contracts read.
"""

from fraud_detection_tpu_torch.analysis.contracts import (  # noqa: F401
    BUDGETS,
    PROGRAMS,
    Budget,
    Program,
    check_budgets,
    check_programs,
)
