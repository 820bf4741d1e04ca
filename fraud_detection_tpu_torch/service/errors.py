"""Shared exception types for the service tier's storage backends.

The port's own copy of the JAX package's ``service/errors.py``. The sqlite
tier raises ``sqlite3.Error``; the network store tier (not ported yet,
ROADMAP item 8c) raises these. Call sites that branch on "is this a DB
error" (the worker's retry ladder, mirroring the reference's
``SQLAlchemyError`` branch at xai_tasks.py:137-141) check
``(sqlite3.Error, DatabaseError)``.
"""

from __future__ import annotations


class StoreError(Exception):
    """Base for network-store failures."""


class DatabaseError(StoreError):
    """Results-DB operation failed (server-side error or connection loss)."""


class BrokerError(StoreError):
    """Broker operation failed (server-side error or connection loss)."""


class ReadOnlyError(StoreError):
    """Write sent to a replica; client should re-resolve the primary."""


class ProtocolError(StoreError):
    """Malformed frame on the wire."""


class StoreAuthError(StoreError):
    """Server rejected our credentials — misconfiguration, never retried."""
