"""Migration entrypoint: apply pending schema migrations, then exec the role
command (the reference's run_migrations.sh `alembic upgrade head && exec "$@"`
contract, run_migrations.sh:6-13).

Usage: ``python -m fraud_detection_tpu_torch.service.migrate [cmd args...]``
"""

from __future__ import annotations

import logging
import os
import sys

from fraud_detection_tpu_torch.service.db import ResultsDB

log = logging.getLogger("fraud_detection_tpu_torch.migrate")


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    db = ResultsDB()  # constructor applies pending migrations
    db.close()
    log.info(
        "migrations applied: %s", db.applied_at_init or "none (up to date)"
    )
    argv = sys.argv[1:]
    if argv:
        os.execvp(argv[0], argv)


if __name__ == "__main__":
    main()
