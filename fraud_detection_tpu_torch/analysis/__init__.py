"""analysis — checks the port holds its own code to.

The port's counterpart of the JAX package's ``analysis/``, by intent and
not by mechanism: the JAX package proves its contracts on jaxprs, the port
runs eagerly and counts. What is here so far:

- :mod:`.contracts` — the collective budgets: every sharded program's
  count of collective calls a unit (a step, a tree level, a flush, a
  call), read from ``parallel.collectives``' counts at several shard
  counts and grids, with :func:`~.contracts.check_budgets` returning the
  violations as stable strings.
"""

from fraud_detection_tpu_torch.analysis.contracts import (  # noqa: F401
    BUDGETS,
    Budget,
    check_budgets,
)
