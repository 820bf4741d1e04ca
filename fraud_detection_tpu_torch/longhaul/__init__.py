"""longhaul — the multi-host switchyard: a cross-process serving mesh.

The port's counterpart of the JAX package's ``longhaul/``, on the same
wires. The shard front (``mesh/front.py``) shards only within one process;
longhaul spreads the same contracts across hosts. One keyspace, two
moduli: an entity's ledger slot picks its owning HOST via
``slot mod N_hosts`` (outer level, :mod:`.placement`) and its device
shard within that host via ``slot mod n_shards`` (inner level,
``ledger/placement.py``) — the two compose because both are congruences
on the same slot integer.

Layers (one module each):

- :mod:`.membership` — the host directory: heartbeats, epoch-numbered
  membership views, durable state.
- :mod:`.placement` — segment ownership, ring inheritance on host death,
  and the segment merge failover uses (either table form in, the host form out).
- :mod:`.codec` — the front's three ingress formats (JSON, msgpack, the
  binary lane's frame) and the host-to-host array packing.
- :mod:`.front` — the routing tier: rows grouped per owning host (same-slot
  rows always travel together, which keeps routed scores bitwise), 503 +
  Retry-After, last-healthy-host protection, per-host half-open probation.
- :mod:`.host` — one serving process: the micro-batcher + lifeboat stack
  behind a framed-socket data plane; inherits a dead peer's segment by
  replaying the peer's journal and snapshot generation
  (``lifeboat/recovery.py``), epoch-fences promotion finalization.
- :mod:`.scrape` — the fleet's drift-window merge and ``/slo/status``
  aggregation under the epoch fence.
- :mod:`.fleet` — the cross-host training reduce: per-host partials (map)
  and one merge through ``LocalReducer``, ``MeshReducer`` (one ``psum`` an
  array over the process group) or ``SocketReducer`` (the framed wire's
  rank-order sum), behind ``fleet_pool_stats`` and ``fleet_sgd_fit``.
"""

from fraud_detection_tpu_torch.longhaul.membership import (  # noqa: F401
    DirectoryClient,
    DirectoryServer,
    MemberInfo,
    MembershipView,
)
from fraud_detection_tpu_torch.longhaul.placement import (  # noqa: F401
    host_of,
    merge_segment,
    owned_segments,
    segment_mask,
    segment_owner,
)
