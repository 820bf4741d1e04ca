"""Structured JSON logging, stdlib only: one JSON object a line with
timestamp, level, logger, message and any extra fields (notably
``correlation_id``, which the API middleware and the worker attach).

The JAX package's ``utils/jsonlog.py`` as it is. As there, no entry point
calls :func:`setup_json_logging`: a deployment that wants JSON lines calls
it once at start-up.
"""

from __future__ import annotations

import json
import logging
import time

# logging.LogRecord attributes that are plumbing, not payload.
_RESERVED = frozenset(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        for k, v in record.__dict__.items():
            if k not in _RESERVED and not k.startswith("_"):
                try:
                    json.dumps(v)
                    out[k] = v
                except (TypeError, ValueError):
                    out[k] = repr(v)
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup_json_logging(level: int = logging.INFO, root: str | None = None) -> None:
    """Install the JSON formatter on the (root or named) logger's stream
    handler. Idempotent: re-running replaces the formatter, not the handler."""
    logger = logging.getLogger(root)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
    for h in logger.handlers:
        h.setFormatter(JsonFormatter())
    logger.setLevel(level)
    if root:
        # A named logger keeps emitting through root handlers too unless
        # propagation is cut — otherwise every record prints twice (once as
        # JSON here, once plain-text via the root handler).
        logger.propagate = False
