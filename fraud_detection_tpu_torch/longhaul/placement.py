"""Two-level placement: one keyspace, two moduli.

The port's counterpart of the JAX package's ``longhaul/placement.py``.
``ledger/placement.py`` places a request's rows onto device shards with
``slot mod n_shards``; longhaul applies the same rule one level up:
``slot mod N_hosts`` names the host segment that owns the slot. Both are
congruences on the same slot integer, so they compose: a host owns every
table slot of its segment, and within the host the shard rule subdivides
them. Two facts carry the correctness:

- **Same-slot rows always land on the same host.** The ledger fold and the
  widened-feature read are per slot (``collisions``/``evictions`` are
  per-slot events summed into scalars), so grouping a batch's rows by
  ``slot mod N`` and flushing each group on its owner keeps every slot's
  flush grouping: routed scores and per-slot table leaves stay bitwise a
  single host's serve of the same batches.
- **Segments are disjoint and cover the table**, so failover is a row
  select: the inheritor copies the dead peer's segment rows (from the
  peer's recovered table) into its live table and sums the scalar event
  counters.

Ring inheritance: segment ``r`` is served by rank ``r`` while it lives;
when rank ``r`` dies its segment goes to the next live rank scanning
upward with wrap-around. Deterministic, a function of the view alone, and
stable under rejoin (the returning rank takes its segment back).

Tables come in two forms (``ledger/state.py``): the host form (numpy, the
file's dtypes, ``uint32`` fingerprint) that a recovery returns, and the
device form (tensors, ``int64`` fingerprint) that the drift monitor serves.
Both functions here read either form in the file's dtypes;
:func:`merge_segment` returns the host form, which
``DriftMonitor.bind_ledger`` copies to the serving device.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from fraud_detection_tpu_torch.ledger.state import LedgerState, host_state

def host_of(slot, n_hosts: int):
    """The outer modulus: the segment of a slot (scalar or ndarray)."""
    return slot % n_hosts


def segment_owner(segment: int, live: Sequence[int], n_hosts: int) -> int:
    """The live rank serving ``segment`` under ring inheritance: the first
    live rank of ``segment, segment+1, ... (mod n_hosts)``."""
    if not 0 <= segment < n_hosts:
        raise ValueError(f"segment {segment} out of range for {n_hosts} hosts")
    alive = set(live)
    if not alive:
        raise ValueError("no live hosts")
    for step in range(n_hosts):
        cand = (segment + step) % n_hosts
        if cand in alive:
            return cand
    raise ValueError(f"live ranks {sorted(alive)} outside 0..{n_hosts - 1}")


def owned_segments(rank: int, live: Sequence[int], n_hosts: int) -> tuple[int, ...]:
    """Every segment ``rank`` serves (its own and those it inherited)."""
    return tuple(
        seg for seg in range(n_hosts) if segment_owner(seg, live, n_hosts) == rank
    )


def segment_mask(n_slots: int, segments: Iterable[int], n_hosts: int) -> np.ndarray:
    """Boolean mask over table slots belonging to ``segments``."""
    slots = np.arange(n_slots, dtype=np.int64)
    mask = np.zeros(n_slots, dtype=bool)
    for seg in set(segments):
        mask |= (slots % n_hosts) == seg
    return mask


def merge_segment(
    dst: LedgerState,
    src: LedgerState,
    segments: Iterable[int],
    n_hosts: int,
    baseline: tuple[float, float] = (0.0, 0.0),
) -> LedgerState:
    """Fold ``src``'s rows for ``segments`` into a new host table, ``dst``
    and ``src`` in either form.

    Per-slot leaves are a bitwise row select (the segments are disjoint
    from what ``dst`` owns); the scalar event counters sum, in float32 and
    the reference's order ``(dst + src) − baseline``: ``baseline`` is the
    ``(collisions, evictions)`` pair both tables started from (the seeded
    warm-up every fleet member replicates), subtracted once so shared
    history is not counted twice. The shapes are ``dst``'s, so binding the
    merge into the drift monitor serves it with the kernels already
    loaded."""
    segments = list(segments)
    coll0, evic0 = np.float32(baseline[0]), np.float32(baseline[1])
    dst, src = host_state(dst), host_state(src)
    mask = segment_mask(dst.last_ts.shape[-1], segments, n_hosts)
    acc = np.array(dst.acc, np.float32, copy=True)
    last_ts = np.array(dst.last_ts, np.float32, copy=True)
    fp = np.array(dst.fingerprint, np.uint32, copy=True)
    acc[..., mask, :] = src.acc[..., mask, :]
    last_ts[..., mask] = src.last_ts[..., mask]
    fp[..., mask] = src.fingerprint[..., mask]
    return LedgerState(
        acc=acc,
        last_ts=last_ts,
        fingerprint=fp,
        collisions=np.asarray(
            np.float32(dst.collisions) + np.float32(src.collisions) - coll0
        ),
        evictions=np.asarray(
            np.float32(dst.evictions) + np.float32(src.evictions) - evic0
        ),
    )


def segments_equal(
    a: LedgerState, b: LedgerState, segments: Iterable[int], n_hosts: int
) -> tuple[bool, str]:
    """Bitwise comparison of the per-slot leaves restricted to ``segments``,
    of tables in either form (each read in the file's dtypes). The scalar
    counters are global, not per segment: compare those apart."""
    a, b = host_state(a), host_state(b)
    mask = segment_mask(a.last_ts.shape[-1], segments, n_hosts)
    for name in ("acc", "last_ts", "fingerprint"):
        av = np.asarray(getattr(a, name))
        bv = np.asarray(getattr(b, name))
        if name == "acc":  # (..., S, 3): the slot axis is second to last
            av, bv = av[..., mask, :], bv[..., mask, :]
        else:
            av, bv = av[..., mask], bv[..., mask]
        if av.tobytes() != bv.tobytes():
            n_diff = int(np.sum(av != bv))
            return False, f"{name}: {n_diff} element(s) differ in segment"
    return True, "segment bitwise equal on per-slot leaves"
