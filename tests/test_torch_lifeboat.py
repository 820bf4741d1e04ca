"""The lifeboat (the ledger's write-ahead journal, snapshots and warm
restart) on the port against the JAX package's ``lifeboat/``, at a small
size (``SLOTS = 64``, d = 30), on the CPU.

Counterparts of every test of the JAX package's ``tests/test_lifeboat.py``
(the torn-file contracts, rotation and pruning, the fsync lag, the spec
refusal and re-sequencing, the journal-only recovery, the dequantized
amount, the torn-tail metric, the window restore and its mismatch skip),
then across the packages: ``spec_hash`` equal (a spec whose floats came
back as ``np.float64`` too), journal files byte for byte equal, snapshots
that load in the other package, and the two recoveries of one directory
(``last_ts``, fingerprints and counts equal, the float columns within
1e-5: the read-update's ``exp2``/``log1p`` differ between XLA's CPU and
PyTorch's in the last bits). Inside the port, bitwise: a ``MicroBatcher``
with a watchtower and a lifeboat serves entity rows on the f32, bf16 and
int8 wires and is abandoned without a final snapshot; a fresh boat's
recovery is the served table. Then the app's 503 gate on every scoring
edge while it recovers, ``/lifeboat/status``, and the hot swap's kept
behaviour in both packages (the boat keeps the start-up monitor)."""

import asyncio
import os
import socket
import struct
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fraud_detection_tpu.data.synthetic import generate_synthetic_data
from fraud_detection_tpu.ledger.state import LedgerSpec as JaxSpec
from fraud_detection_tpu.ledger.state import LedgerState as JaxState
from fraud_detection_tpu.lifeboat import Journal as JaxJournal
from fraud_detection_tpu.lifeboat import Lifeboat as JaxLifeboat
from fraud_detection_tpu.lifeboat import load_snapshot as jax_load_snapshot
from fraud_detection_tpu.lifeboat import recover as jax_recover
from fraud_detection_tpu.lifeboat import spec_hash as jax_spec_hash
from fraud_detection_tpu.lifeboat import write_snapshot as jax_write_snapshot
from fraud_detection_tpu.monitor.baseline import build_baseline_profile as jax_profile
from fraud_detection_tpu.monitor.drift import DriftWindow as JaxWindow
from fraud_detection_tpu.monitor.watchtower import Thresholds as JaxThresholds
from fraud_detection_tpu.monitor.watchtower import Watchtower as JaxWatchtower
from fraud_detection_tpu_torch.ledger import entity_fingerprint, load_ledger
from fraud_detection_tpu_torch.ledger.state import (
    LEDGER_K,
    LedgerSpec,
    LedgerState,
    entity_slot,
    host_state,
)
from fraud_detection_tpu_torch.lifeboat import (
    Journal,
    Lifeboat,
    TornSnapshot,
    list_journals,
    list_snapshots,
    load_latest,
    load_snapshot,
    read_journal_file,
    read_tail,
    recover,
    replay_records,
    spec_hash,
    write_snapshot,
)
from fraud_detection_tpu_torch.lifeboat.journal import journal_path, prune_journals
from fraud_detection_tpu_torch.lifeboat.recovery import slots_for
from fraud_detection_tpu_torch.lifeboat.snapshot import prune_snapshots, snapshot_path
from fraud_detection_tpu_torch.models import FraudLogisticModel
from fraud_detection_tpu_torch.monitor.baseline import build_baseline_profile, load_profile
from fraud_detection_tpu_torch.monitor.drift import WINDOW_FIELDS, DriftMonitor, DriftWindow
from fraud_detection_tpu_torch.monitor.watchtower import Thresholds, Watchtower
from fraud_detection_tpu_torch.range import faults
from fraud_detection_tpu_torch.service import binlane, metrics
from fraud_detection_tpu_torch.service.app import create_app
from fraud_detection_tpu_torch.service.http import Request
from fraud_detection_tpu_torch.service.microbatch import IngestBlock, MicroBatcher
from fraud_detection_tpu_torch.train import train

torch.set_num_threads(1)

D = 30
SLOTS = 64
#: the float columns of two packages' tables (the ledger's tolerance)
RTOL = ATOL = 1e-5
FIELDS = ("acc", "last_ts", "fingerprint", "collisions", "evictions")
EXACT = ("last_ts", "fingerprint", "collisions", "evictions")
NEVER = Thresholds(5.0, 5.0, 5.0, 1.0, 10**9)


def _kw(**overrides) -> dict:
    kw = dict(
        n_base=D, slots=SLOTS, halflife_s=900.0, amount_col=-1, ts_origin=100.0,
        null_features=np.arange(4, dtype=np.float32),
    )
    kw.update(overrides)
    return kw


def _spec(**overrides) -> LedgerSpec:
    return LedgerSpec(**_kw(**overrides))


def _table(seed: int = 3, slots: int = SLOTS) -> LedgerState:
    rng = np.random.default_rng(seed)
    return LedgerState(
        acc=rng.standard_normal((slots, 3)).astype(np.float32),
        last_ts=rng.uniform(0, 1e4, slots).astype(np.float32),
        fingerprint=rng.integers(0, 2**32, slots, dtype=np.uint64).astype(np.uint32),
        collisions=np.zeros((), np.float32),
        evictions=np.zeros((), np.float32),
    )


def _tables_equal(a, b) -> bool:
    return all(
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(host_state(a), host_state(b))
    )


def _assert_tables_close(want, got, what=""):
    """``last_ts``, fingerprints and the counts equal, ``acc`` within the
    ledger's tolerance."""
    for name, a, b in zip(FIELDS, host_state(want), host_state(got)):
        if name in EXACT:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


def _triples(seed: int, n: int):
    rng = np.random.default_rng(seed)
    fp = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ts = rng.uniform(10.0, 500.0, n).astype(np.float32)
    amt = rng.uniform(0.0, 200.0, n).astype(np.float32)
    return fp, ts, amt


# -- snapshot format --------------------------------------------------------


def test_snapshot_roundtrip(tmp_path):
    spec, table = _spec(), _table()
    path = write_snapshot(str(tmp_path), 7, spec, table, slot_version=3, rows_seen=420)
    snap = load_snapshot(path)
    assert snap.seq == 7 and snap.slot_version == 3 and snap.rows_seen == 420
    assert snap.spec_hash == spec_hash(spec)
    for field in ("n_base", "slots", "halflife_s", "amount_col", "ts_origin"):
        assert getattr(snap.spec, field) == getattr(spec, field)
    assert np.array_equal(snap.spec.null_features, spec.null_features)
    assert _tables_equal(snap.ledger, table)
    assert snap.window is None and snap.shard_window is None


def test_snapshot_truncated_at_every_section_boundary(tmp_path):
    """A prefix cut at any boundary — and strictly inside every section —
    raises TornSnapshot, never loads partial state."""
    path = write_snapshot(str(tmp_path), 1, _spec(), _table())
    blob = open(path, "rb").read()
    (header_len,) = struct.unpack_from("<I", blob, 6)
    p_start = 10 + header_len + 4
    payload_len = len(blob) - p_start - 4
    cuts = sorted({
        0, 2, 4, 5, 6, 8, 10, 10 + header_len // 2, 10 + header_len,
        10 + header_len + 2, p_start, p_start + payload_len // 2,
        p_start + payload_len, len(blob) - 1,
    })
    for cut in cuts:
        torn = tmp_path / "torn" / f"lifeboat-{cut:012d}.snap"
        torn.parent.mkdir(exist_ok=True)
        torn.write_bytes(blob[:cut])
        with pytest.raises(TornSnapshot):
            load_snapshot(str(torn))
    assert load_snapshot(path).seq == 1


def test_snapshot_corruption_and_bad_framing(tmp_path):
    path = write_snapshot(str(tmp_path), 1, _spec(), _table())
    blob = bytearray(open(path, "rb").read())
    (header_len,) = struct.unpack_from("<I", blob, 6)

    def _expect_torn(mutated: bytes):
        p = tmp_path / "x.snap"
        p.write_bytes(mutated)
        with pytest.raises(TornSnapshot):
            load_snapshot(str(p))

    h = bytearray(blob)
    h[12] ^= 0xFF  # inside the header JSON
    _expect_torn(bytes(h))
    p = bytearray(blob)
    p[10 + header_len + 4 + 5] ^= 0xFF  # inside the payload
    _expect_torn(bytes(p))
    _expect_torn(b"XXXX" + bytes(blob[4:]))
    v = bytearray(blob)
    struct.pack_into("<H", v, 4, 99)
    _expect_torn(bytes(v))
    g = bytearray(blob)
    struct.pack_into("<I", g, 6, 1 << 30)  # no giant allocation
    _expect_torn(bytes(g))


def test_load_latest_generation_fallback(tmp_path):
    spec = _spec()
    tables = [_table(seed) for seed in (1, 2, 3)]
    for seq, table in enumerate(tables, start=1):
        write_snapshot(str(tmp_path), seq, spec, table)
    newest = snapshot_path(str(tmp_path), 3)
    blob = open(newest, "rb").read()
    open(newest, "wb").write(blob[: len(blob) // 2])
    snap, skipped = load_latest(str(tmp_path))
    assert snap.seq == 2 and skipped == 1
    assert _tables_equal(snap.ledger, tables[1])
    for seq in (1, 2):
        p = snapshot_path(str(tmp_path), seq)
        open(p, "wb").write(open(p, "rb").read()[:9])
    snap, skipped = load_latest(str(tmp_path))
    assert snap is None and skipped == 3


def test_zero_length_files_degrade_cleanly(tmp_path):
    open(snapshot_path(str(tmp_path), 5), "wb").close()
    open(journal_path(str(tmp_path), 0), "wb").close()
    snap, skipped = load_latest(str(tmp_path))
    assert snap is None and skipped == 1
    records, torn, mid, header_ok, header_hash = read_journal_file(journal_path(str(tmp_path), 0))
    assert records == [] and torn == 0 and mid == 0 and not header_ok
    rep = recover(str(tmp_path), _spec(), device="cpu")
    assert rep.ok and not rep.restored and rep.state is None


def test_prune_snapshots_keeps_newest_k(tmp_path):
    for seq in range(1, 6):
        write_snapshot(str(tmp_path), seq, _spec(), _table())
    assert prune_snapshots(str(tmp_path), keep=3) == [1, 2]
    assert [s for s, _ in list_snapshots(str(tmp_path))] == [3, 4, 5]


def test_spec_hash_covers_every_geometry_field():
    variants = [_spec(slots=128), _spec(halflife_s=60.0), _spec(ts_origin=0.0),
                _spec(amount_col=0), _spec(null_features=np.zeros(4, np.float32))]
    hashes = {spec_hash(s) for s in [_spec()] + variants}
    assert len(hashes) == len(variants) + 1
    assert spec_hash(_spec()) == spec_hash(_spec())


# -- journal format ---------------------------------------------------------


def test_journal_roundtrip_rotation_and_prune(tmp_path):
    j = Journal(str(tmp_path), spec_hash(_spec()), base_seq=0, fsync_s=0.0)
    batches = [_triples(seed, 16 + seed) for seed in range(3)]
    for fp, ts, amt in batches[:2]:
        j.append(fp, ts, amt)
    assert j.pending_rows == 0  # fsync every append
    j.rotate(2)
    j.append(*batches[2])
    j.close()
    assert [b for b, _ in list_journals(str(tmp_path))] == [0, 2]
    tail = read_tail(str(tmp_path), 0)
    assert tail.n_records == 3 and tail.torn_rows == 0
    assert [r[0] for r in tail.records] == [1, 2, 3]
    for (seq, fp, ts, amt), (efp, ets, eamt) in zip(tail.records, batches):
        assert np.array_equal(fp, efp) and np.array_equal(ts, ets)
        assert np.array_equal(amt, eamt)
    tail2 = read_tail(str(tmp_path), 2)
    assert tail2.n_records == 1 and tail2.records[0][0] == 3
    assert prune_journals(str(tmp_path), 2) == [0]
    assert [b for b, _ in list_journals(str(tmp_path))] == [2]


def test_journal_fsync_policy_bounds_lag(tmp_path):
    j = Journal(str(tmp_path), "a" * 16, base_seq=0, fsync_s=5.0)
    j.append(*_triples(1, 32))
    assert j.pending_rows == 32  # the crash-loss bound until the cadence
    j.sync()
    assert j.pending_rows == 0
    j.close()


def test_journal_misaligned_arrays_rejected(tmp_path):
    j = Journal(str(tmp_path), "a" * 16, fsync_s=0.0)
    fp, ts, amt = _triples(1, 8)
    with pytest.raises(ValueError):
        j.append(fp, ts[:4], amt)
    j.close()


def test_journal_torn_tail_drops_exactly_the_final_record(tmp_path):
    j = Journal(str(tmp_path), "b" * 16, fsync_s=0.0)
    for seed in range(3):
        j.append(*_triples(seed, 16))
    j.close()
    path = journal_path(str(tmp_path), 0)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-6])  # tear the last record's CRC
    records, torn, mid, header_ok, _ = read_journal_file(path)
    assert header_ok and mid == 0
    assert [r[0] for r in records] == [1, 2]
    assert torn == 16


def test_journal_corrupt_record_mid_file_resyncs(tmp_path):
    """Disk damage (not a crash shape): the corrupt record counts as
    mid-file corruption, every later record still replays."""
    j = Journal(str(tmp_path), "c" * 16, fsync_s=0.0)
    batches = [_triples(seed, 16) for seed in range(4)]
    offsets = []
    for fp, ts, amt in batches:
        offsets.append(os.path.getsize(journal_path(str(tmp_path), 0)))
        j.append(fp, ts, amt)
    j.close()
    path = journal_path(str(tmp_path), 0)
    blob = bytearray(open(path, "rb").read())
    blob[offsets[1] + 20] ^= 0xFF  # inside record 2's payload
    open(path, "wb").write(bytes(blob))
    records, torn, mid, header_ok, _ = read_journal_file(path)
    assert header_ok and [r[0] for r in records] == [1, 3, 4]
    assert torn == 16 and mid >= 1
    assert np.array_equal(records[1][1], batches[2][0])
    assert np.array_equal(records[2][3], batches[3][2])


def test_journal_bad_header_still_resyncs_records(tmp_path):
    j = Journal(str(tmp_path), "d" * 16, fsync_s=0.0)
    fp, ts, amt = _triples(5, 12)
    j.append(fp, ts, amt)
    j.close()
    path = journal_path(str(tmp_path), 0)
    blob = bytearray(open(path, "rb").read())
    blob[0] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    records, _, _, header_ok, _ = read_journal_file(path)
    assert not header_ok
    assert len(records) == 1 and np.array_equal(records[0][1], fp)


def test_slots_for_matches_scalar_hash():
    fp = _triples(9, 256)[0]
    assert np.array_equal(slots_for(fp, 6),
                          np.asarray([entity_slot(int(f), 6) for f in fp], np.int32))


# -- recovery ---------------------------------------------------------------


def test_recover_refuses_mismatched_spec_hash(tmp_path):
    spec_a, spec_b = _spec(), _spec(halflife_s=60.0)
    write_snapshot(str(tmp_path), 4, spec_a, _table())
    rep = recover(str(tmp_path), spec_b, device="cpu")
    assert not rep.ok and not rep.restored and rep.state is None
    assert "refusing" in rep.refused_reason
    assert spec_hash(spec_a) in rep.refused_reason and spec_hash(spec_b) in rep.refused_reason
    rep2 = recover(str(tmp_path), spec_a, device="cpu")
    assert rep2.ok and rep2.restored and rep2.snapshot_seq == 4


def _drift(table, spec) -> DriftMonitor:
    """A CPU drift monitor with ``table`` bound and ``rows_seen`` 77: what
    the boat snapshots and what a recovery binds into."""
    rng = np.random.default_rng(0)
    profile = build_baseline_profile(rng.standard_normal((128, D)).astype(np.float32),
                                     rng.uniform(0, 1, 128).astype(np.float32), device="cpu")
    dm = DriftMonitor(profile, halflife_rows=100.0, device="cpu")
    dm.bind_ledger(spec, table)
    dm.rows_seen = 77
    return dm


def test_refusal_resumes_sequencing_past_the_stale_generation(tmp_path):
    """A spec change over a reused LIFEBOAT_DIR must not brick the layer:
    the refusal resumes sequencing past everything on disk, so the next
    new-spec snapshot supersedes the stale file."""
    write_snapshot(str(tmp_path), 500, _spec(), _table())
    spec_new = _spec(slots=128)
    zeros = LedgerState(np.zeros((128, 3), np.float32), np.zeros(128, np.float32),
                        np.zeros(128, np.uint32), np.zeros((), np.float32),
                        np.zeros((), np.float32))
    boat = Lifeboat(str(tmp_path), spec_new, drift=_drift(zeros, spec_new), snapshot_s=1e9,
                    fsync_s=0.0)
    rep = boat.recover()
    assert not rep.ok and rep.resume_seq >= 500
    assert boat.journal.seq >= 500
    assert boat.take_snapshot() is not None
    boat.close()
    rep2 = recover(str(tmp_path), spec_new, device="cpu")
    assert rep2.ok and rep2.restored and rep2.snapshot_seq >= 500


def test_journal_from_mismatched_spec_refused(tmp_path):
    spec_old, spec_new = _spec(), _spec(halflife_s=60.0)
    j = Journal(str(tmp_path), spec_hash(spec_old), fsync_s=0.0)
    j.append(*_triples(1, 16))
    j.close()
    rep = recover(str(tmp_path), spec_new, device="cpu")
    assert rep.ok and not rep.restored and rep.replayed_rows == 0
    rep2 = recover(str(tmp_path), spec_old, device="cpu")
    assert rep2.restored and rep2.replayed_rows == 16


def test_journal_append_after_close_is_bounded_loss_not_a_crash(tmp_path):
    j = Journal(str(tmp_path), "e" * 16, fsync_s=0.0)
    j.append(*_triples(1, 8))
    j.close()
    assert j.append(*_triples(2, 8)) == 1  # no-op, no raise
    assert read_tail(str(tmp_path), 0).n_records == 1


def test_recover_journal_only_before_first_snapshot(tmp_path):
    spec = _spec()
    j = Journal(str(tmp_path), spec_hash(spec), fsync_s=0.0)
    batches = [_triples(seed, 24) for seed in range(2)]
    for fp, ts, amt in batches:
        j.append(fp, ts, amt)
    j.close()
    rep = recover(str(tmp_path), spec, device="cpu")
    assert rep.restored and rep.snapshot_seq == 0
    assert rep.replayed_rows == 48 and rep.resume_seq == 2
    manual = replay_records(spec, None, [(i + 1, *b) for i, b in enumerate(batches)],
                            device="cpu")
    assert _tables_equal(rep.state, manual)


def test_read_update_bits_do_not_depend_on_a_rows_position():
    """A journal record keeps a flush's entity rows alone, so the replay
    folds a row at another position of another bucket than serving did:
    the read-update's table and features must not change a bit for it
    (ATen's CPU ``exp2`` differs in the last bit between its vector body
    and its scalar tail; the body pads it to whole vectors)."""
    from fraud_detection_tpu_torch.ledger import _ledger_read_update
    from fraud_detection_tpu_torch.ledger.state import device_state

    spec = _spec(halflife_s=600.0)
    base = _table(8)
    null = torch.tensor(spec.null_features)
    hl = torch.tensor(spec.halflife_s, dtype=torch.float32)
    fp, ts, amt = _triples(6, 40)
    fp = base.fingerprint[np.arange(40) % SLOTS] | 1
    ts = ts * 40.0 + 1e4  # past every anchor, gaps of several half-lives
    slots = slots_for(fp, spec.log2_slots)
    for i in range(40):
        out = []
        for bucket, pos in ((8, 3), (256, 0), (256, 97)):
            table = device_state(base, SLOTS)
            cols = [np.zeros(bucket, dt) for dt in (np.int64, np.int64, np.float32,
                                                    np.float32, np.float32)]
            for c, v in zip(cols, (slots[i], fp[i], ts[i], amt[i], 1.0)):
                c[pos] = v
            feats = _ledger_read_update(table, *(torch.from_numpy(c) for c in cols), null, hl)
            out.append((host_state(table), feats[pos].numpy().tobytes()))
        for table, feats in out[1:]:
            assert _tables_equal(table, out[0][0]) and feats == out[0][1], i


def test_replay_records_deterministic_and_segmentation_sensitive():
    spec = _spec()
    records = [(i + 1, *_triples(seed, 32)) for i, seed in enumerate(range(3))]
    a = replay_records(spec, None, records, device="cpu")
    assert _tables_equal(a, replay_records(spec, None, records, device="cpu"))
    assert np.asarray(a.acc).any()


# -- the Lifeboat -----------------------------------------------------------


def _staged_flush(seed: int, bucket: int = 32):
    """A staging slot and wire batch shaped as ``_flush_device`` hands them
    to ``journal_staged``: int64 fingerprint and float lanes (zeros: the
    entity-less rows) and the staged block."""
    rng = np.random.default_rng(seed)
    lh = (rng.uniform(size=bucket) < 0.75).astype(np.float32)
    slot = SimpleNamespace(
        lh=lh,
        lf=np.where(lh > 0, rng.integers(1, 2**32, bucket, dtype=np.uint64), 0).astype(np.int64),
        lt=rng.uniform(5.0, 50.0, bucket).astype(np.float32),
    )
    return slot, rng.standard_normal((bucket, D)).astype(np.float32)


def _boat(directory, spec, drift=None):
    return Lifeboat(str(directory), spec, drift=drift, snapshot_s=1e9, fsync_s=0.0)


def test_lifeboat_snapshot_journal_recover_cycle(tmp_path):
    spec, table = _spec(), _table(11)
    boat = _boat(tmp_path, spec, _drift(table, spec))
    rep0 = boat.recover()
    assert boat.state == "ready" and not rep0.restored
    slot1, hx1 = _staged_flush(1)
    slot2, hx2 = _staged_flush(2)
    with boat.flush_lock:
        boat.journal_staged(slot1, hx1, None, 32)
    assert boat.take_snapshot() is not None  # generation at seq 1
    with boat.flush_lock:
        boat.journal_staged(slot2, hx2, None, 32)
    status = boat.status()
    assert status["state"] == "ready"
    assert status["journal_seq"] == 2 and status["generations"] == [1]
    boat.close()
    fresh = _drift(_table(12), spec)
    boat2 = _boat(tmp_path, spec, fresh)
    rep = boat2.recover()
    boat2.close()
    assert rep.restored and rep.snapshot_seq == 1
    assert rep.replayed_rows == int((slot2.lh != 0).sum())
    assert rep.rows_seen == 77 and fresh.rows_seen == 77
    assert _tables_equal(fresh.ledger_snapshot(), rep.state)
    manual = replay_records(spec, table, read_tail(str(tmp_path), 1).records, device="cpu")
    assert _tables_equal(rep.state, manual)
    assert rep.resume_seq == 2


@pytest.mark.parametrize("scale_kind", ["ndarray", "tensor"])
def test_lifeboat_dequant_scale_folds_into_journaled_amount(tmp_path, scale_kind):
    """On the int8 wire the flush consumes dequantized codes: the journal
    records exactly those, from the scale the fused spec carries (a device
    tensor) or a host array."""
    spec = _spec()
    boat = _boat(tmp_path, spec, _drift(_table(), spec))
    boat.recover()
    slot, hx = _staged_flush(3)
    codes = np.clip(np.rint(hx * 40), -127, 127).astype(np.int8)
    scale = np.full(D, 0.25, np.float32)
    with boat.flush_lock:
        boat.journal_staged(slot, codes, scale if scale_kind == "ndarray"
                            else torch.from_numpy(scale), 32)
    boat.close()
    mask = slot.lh != 0
    want = (codes[:, spec.amount_col][mask].astype(np.float32) * np.float32(0.25))
    assert np.array_equal(read_tail(str(tmp_path), 0).amount, want)


def test_lifeboat_bf16_wire_journals_the_rounded_amount(tmp_path):
    """On the bf16 wire ``hx`` is a ``torch.bfloat16`` tensor: the journal
    holds its exact f32 upcast, never its bits read as integers."""
    spec = _spec()
    boat = _boat(tmp_path, spec, _drift(_table(), spec))
    boat.recover()
    slot, hx = _staged_flush(4)
    hb = torch.from_numpy(hx * 100).to(torch.bfloat16)
    with boat.flush_lock:
        boat.journal_staged(slot, hb, None, 32)
    boat.close()
    want = hb.float().numpy()[:, spec.amount_col][slot.lh != 0]
    got = read_tail(str(tmp_path), 0)
    assert np.array_equal(got.amount, want) and got.fp.dtype == np.uint32
    assert np.array_equal(got.fp, slot.lf[slot.lh != 0].astype(np.uint32))


def test_lifeboat_closed_before_its_recovery_ends_opens_nothing(tmp_path):
    """A shutdown that lands while the warm restart replays: the journal the
    recovery opens is closed at once, and the ``start()`` after it starts no
    maintenance thread that could reopen it."""
    spec = _spec()
    boat = _boat(tmp_path, spec, _drift(_table(), spec))
    boat.close()
    rep = boat.recover()
    boat.start()
    assert rep.ok and boat.state == "ready"
    assert boat.journal is None and boat._thread is None
    slot, hx = _staged_flush(5)
    with boat.flush_lock:
        boat.journal_staged(slot, hx, None, 32)  # nothing journals now
    assert not read_tail(str(tmp_path), 0).records


def test_lifeboat_torn_tail_counted_on_metric(tmp_path):
    spec = _spec()
    boat = _boat(tmp_path, spec, _drift(_table(), spec))
    boat.recover()
    slot, hx = _staged_flush(4)
    with boat.flush_lock:
        boat.journal_staged(slot, hx, None, 32)
    boat.close()
    path = journal_path(str(tmp_path), 0)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-4])
    before = metrics.lifeboat_torn_tail_rows.get()
    boat2 = Lifeboat(str(tmp_path), spec, snapshot_s=1e9, fsync_s=0.0)
    rep = boat2.recover()
    boat2.close()
    n = int((slot.lh != 0).sum())
    assert rep.torn_rows == n
    assert metrics.lifeboat_torn_tail_rows.get() - before == n


# -- the drift window's restore ---------------------------------------------


def test_restore_window_roundtrip_and_mismatch_skip(caplog):
    rng = np.random.default_rng(5)
    profile = build_baseline_profile(rng.standard_normal((128, 6)).astype(np.float32),
                                     rng.uniform(0, 1, 128).astype(np.float32), device="cpu")
    dm = DriftMonitor(profile, halflife_rows=100.0, device="cpu")
    dm.update(rng.standard_normal((40, 6)).astype(np.float32), rng.uniform(0, 1, 40))
    win = dm.window_snapshot()
    live = dm.window.feature_counts
    dm.update(rng.standard_normal((40, 6)).astype(np.float32), rng.uniform(0, 1, 40))
    assert dm.restore_window(win, rows_seen=420) is True
    assert dm.rows_seen == 420
    assert dm.window.feature_counts is live  # restored in place
    for name in WINDOW_FIELDS:
        assert getattr(dm.window, name).numpy().tobytes() == getattr(win, name).numpy().tobytes()
    bad = DriftWindow(np.zeros((2, 2), np.float32), *win.tensors()[1:])
    with caplog.at_level("WARNING"):
        assert dm.restore_window(bad, rows_seen=1) is False
    assert dm.rows_seen == 420 and "restore skipped" in caplog.text


def _mesh_drift(table, spec, n_shards) -> "MeshDriftMonitor":
    from fraud_detection_tpu_torch.mesh.shardflush import MeshDriftMonitor
    from fraud_detection_tpu_torch.mesh.topology import serving_mesh

    rng = np.random.default_rng(0)
    profile = build_baseline_profile(rng.standard_normal((128, D + 4)).astype(np.float32),
                                     rng.uniform(0, 1, 128).astype(np.float32), device="cpu")
    dm = MeshDriftMonitor(profile, serving_mesh(n_shards, devices=["cpu"]),
                          halflife_rows=100.0)
    dm.bind_ledger(spec, table)
    return dm


def _mesh_flush(dm, spec, seed):
    """One placed ledger flush of 24 rows (a third entity-less) into the
    mesh monitor's per-shard windows and sub-tables."""
    from fraud_detection_tpu_torch.ledger.placement import shard_placement
    from fraud_detection_tpu_torch.ops.scorer import _raw_score_linear

    rng = np.random.default_rng(seed)
    n = 24
    x = rng.standard_normal((n, D)).astype(np.float32)
    has = (np.arange(n) % 3 != 0).astype(np.float32)
    fps = np.where(has > 0, rng.integers(1, 40, n), 0).astype(np.int64)
    slots = np.asarray([spec.row_keys(f"e{f}")[0] for f in fps], np.int64)
    ts = np.where(has > 0, rng.uniform(1.0, 50.0, n), 0.0).astype(np.float32)
    bucket, pos = shard_placement(slots, has, dm.n_shards, min_bucket=8)
    cols = [np.zeros((bucket, D), np.float32), np.zeros(bucket, np.int64),
            np.zeros(bucket, np.int64), np.zeros(bucket, np.float32),
            np.zeros(bucket, np.float32), np.zeros(bucket, np.float32)]
    for c, v in zip(cols, (x, slots, fps, ts, has, np.ones(n, np.float32))):
        c[pos] = v
    xt, sl, fp, tt, hh, vv = (torch.from_numpy(c) for c in cols)
    coef = torch.from_numpy(rng.standard_normal(D + 4).astype(np.float32) * 0.1)
    dm.fused_flush(xt, vv, n, (coef, torch.tensor(0.1)), _raw_score_linear,
                   ledger_rows=(sl, fp, tt, hh))


def test_mesh_snapshot_roundtrip_per_shard_windows_and_sub_tables(tmp_path, caplog):
    """The serving mesh's half of the lifeboat: a snapshot of an N = 4
    ledger monitor carries the ``sw_*`` per-shard windows and the merged
    table; recovering into a fresh N = 4 monitor restores the per-shard
    windows and each shard's slots of the sub-tables bitwise, and the merged
    table; into N = 2 the per-shard
    windows are skipped with the geometry WARNING and the base window and
    the table are restored."""
    spec = _spec()
    src = _mesh_drift(_table(21), spec, 4)
    for seed in range(3):
        _mesh_flush(src, spec, seed)
    src.update(np.ones((4, D), np.float32), np.full(4, 0.3, np.float32),
               labels=np.ones(4, np.float32), calibration_only=True)
    boat = _boat(tmp_path, spec, src)
    boat.recover()
    assert boat.take_snapshot() is not None
    boat.close()
    snap = load_snapshot(snapshot_path(str(tmp_path), 0))
    assert snap.shard_window is not None and snap.shard_window.n_rows.shape == (4,)
    fresh = _mesh_drift(None, spec, 4)
    boat4 = _boat(tmp_path, spec, fresh)
    rep = boat4.recover()
    boat4.close()
    assert rep.restored
    for a, b in zip(src.shard_window.tensors(), fresh.shard_window.tensors()):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for a, b in zip(src.window.tensors(), fresh.window.tensors()):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    # the slot-owned leaves come back in their shards; the collision and
    # eviction totals are one merged count in the file, seeded on shard 0
    for a, b in zip(src.ledger[:3], fresh.ledger[:3]):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert _tables_equal(src.ledger_snapshot(), fresh.ledger_snapshot())
    two = _mesh_drift(None, spec, 2)
    boat2 = _boat(tmp_path, spec, two)
    with caplog.at_level("WARNING", logger="fraud_detection_tpu_torch.lifeboat"):
        rep2 = boat2.recover()
    boat2.close()
    assert rep2.restored and "per-shard window restore skipped" in caplog.text
    assert not any(t.any() for t in two.shard_window.tensors())
    for a, b in zip(src.window.tensors(), two.window.tensors()):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert _tables_equal(src.ledger_snapshot(), two.ledger_snapshot())


# -- across the packages ------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's ``train(ledger=True)`` on a small synthetic CSV (2,000
    rows, ``LEDGER_SLOTS=64``, 2 folds), on the CPU, unregistered."""
    root = tmp_path_factory.mktemp("lifeboat_train")
    csv = str(root / "synth.csv")
    generate_synthetic_data(csv, n_samples=2000, fraud_ratio=0.03, seed=0, shift_scale=0.35)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEDGER_SLOTS", str(SLOTS))
        mp.setenv("MLFLOW_TRACKING_URI", f"file:{root}/mlruns")
        out = str(root / "models")
        train(data_csv=csv, n_folds=2, register=False, out_dir=out, ledger=True,
              device="cpu")
    x = np.loadtxt(csv, delimiter=",", skiprows=1, max_rows=400, dtype=np.float32)[:, :D]
    return {"dir": out, "x": x, "root": root}


def test_spec_hash_equals_jax(trained):
    """The 16 hex characters equal JAX's: for hand-built specs, for the
    spec ``train --ledger`` built (held by the trained model) and the one
    ``load_ledger`` reads back, and for a spec whose floats came back as
    ``np.float64`` (numpy 2's repr differs; the port formats Python
    floats)."""
    specs = [_kw(), _kw(halflife_s=60.0, ts_origin=1.7e9 + 0.125), _kw(slots=128, amount_col=3)]
    for kw in specs:
        assert spec_hash(LedgerSpec(**kw)) == jax_spec_hash(JaxSpec(**kw))
        as_np = dict(kw, halflife_s=np.float64(kw["halflife_s"]),
                     ts_origin=np.float64(kw["ts_origin"]))
        assert spec_hash(LedgerSpec(**as_np)) == jax_spec_hash(JaxSpec(**kw))
    model = FraudLogisticModel.load(trained["dir"], device="cpu")
    loaded, _ = load_ledger(trained["dir"])
    for spec in (model.ledger_spec, loaded):
        kw = {f: getattr(spec, f) for f in
              ("n_base", "slots", "halflife_s", "amount_col", "ts_origin", "null_features")}
        assert spec_hash(spec) == jax_spec_hash(JaxSpec(**kw))
    assert spec_hash(model.ledger_spec) == spec_hash(loaded)


def test_journal_files_byte_for_byte_jax(tmp_path):
    """The same triples (the port's fingerprints as its staging's int64),
    base seq and spec hash: the two packages' files are the same bytes,
    across a rotation."""
    h = spec_hash(_spec())
    batches = [_triples(seed, 5 + 7 * seed) for seed in range(4)]
    for name, cls, fp_dtype in (("port", Journal, np.int64), ("jax", JaxJournal, np.uint32)):
        j = cls(str(tmp_path / name), h, base_seq=9, fsync_s=0.0)
        for i, (fp, ts, amt) in enumerate(batches):
            j.append(fp.astype(fp_dtype), ts, amt)
            if i == 1:
                j.rotate(j.seq)
        j.close()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "journal-000000000009.wal", "journal-000000000011.wal"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def _np_load_payload(path):
    import io
    import json

    blob = open(path, "rb").read()
    (header_len,) = struct.unpack_from("<I", blob, 6)
    header = json.loads(blob[10:10 + header_len])
    start = 10 + header_len + 4
    z = np.load(io.BytesIO(blob[start:start + header["payload_len"]]))
    return header, {k: z[k] for k in z.files}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshots_load_across_packages(tmp_path, writer):
    """A snapshot written by either package, with a window, loads in the
    other: the same header, keys and arrays (the fingerprint uint32)."""
    kw, table = _kw(), _table(6)
    rng = np.random.default_rng(2)
    leaves = [rng.uniform(0, 9, s).astype(np.float32)
              for s in ((D, 10), (10,), (10,), (10,), (10,), ())]
    args = dict(slot_version=4, rows_seen=321, created_at=1234.5)
    if writer == "port":
        path = write_snapshot(str(tmp_path), 3, LedgerSpec(**kw), table,
                              window=DriftWindow(*leaves), **args)
        snap = jax_load_snapshot(path)
        window = [np.asarray(leaf) for leaf in snap.window]
    else:
        path = jax_write_snapshot(str(tmp_path), 3, JaxSpec(**kw), JaxState(*table),
                                  window=JaxWindow(*leaves), **args)
        snap = load_snapshot(path)
        window = list(snap.window.tensors())
    assert (snap.seq, snap.slot_version, snap.rows_seen, snap.created_at) == (3, 4, 321, 1234.5)
    assert snap.spec_hash == spec_hash(LedgerSpec(**kw)) == jax_spec_hash(JaxSpec(**kw))
    assert _tables_equal(snap.ledger, table) and snap.shard_window is None
    for got, want in zip(window, leaves):
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    header, arrays = _np_load_payload(path)
    other = tmp_path / "other"
    if writer == "port":
        other_path = jax_write_snapshot(str(other), 3, JaxSpec(**kw), JaxState(*table),
                                        window=JaxWindow(*leaves), **args)
    else:
        other_path = write_snapshot(str(other), 3, LedgerSpec(**kw), table,
                                    window=DriftWindow(*leaves), **args)
    header2, arrays2 = _np_load_payload(other_path)
    assert header == header2 and sorted(arrays) == sorted(arrays2)
    for k in arrays:
        assert arrays[k].dtype == arrays2[k].dtype and arrays[k].tobytes() == arrays2[k].tobytes(), k
    assert arrays["fingerprint"].dtype == np.uint32


def test_jax_and_port_recover_one_directory(tmp_path):
    """One directory (a generation and a journal tail across a rotation):
    JAX's ``recover`` and the port's give tables with ``last_ts``,
    fingerprints and counts equal, the float columns within 1e-5."""
    spec_kw = _kw()
    spec = LedgerSpec(**spec_kw)
    table = replay_records(spec, None, [(1, *_triples(40, 48))], device="cpu")
    write_snapshot(str(tmp_path), 4, spec, table)
    j = Journal(str(tmp_path), spec_hash(spec), base_seq=4, fsync_s=0.0)
    rng = np.random.default_rng(3)
    for seed in range(5):
        fp, ts, amt = _triples(seed, 20 + seed)
        fp[: 8] = table.fingerprint[rng.integers(0, SLOTS, 8)] | 1  # known entities
        j.append(fp, ts + 500.0, amt)
    j.close()
    mine = recover(str(tmp_path), spec, device="cpu")
    theirs = jax_recover(str(tmp_path), JaxSpec(**spec_kw))
    assert mine.restored and theirs.restored
    assert (mine.snapshot_seq, mine.replayed_rows, mine.resume_seq) == \
        (theirs.snapshot_seq, theirs.replayed_rows, theirs.resume_seq) == (4, 110, 9)
    _assert_tables_close(theirs.state, mine.state, "jax vs port recover")


# -- inside the port: serve, abandon, recover -------------------------------


def _drive(mb, scorer, spec, x, boat):
    """Entity-keyed single rows (one a flush), bursts with entity-less rows
    interleaved, a generation mid-way, and an ingest block whose every
    ninth fingerprint is 0."""
    t0 = 5000.0

    def ent(i):
        s, fp = spec.row_keys(f"card-{i % 7}")
        return s, fp, t0 + 3.0 * i

    async def run():
        await mb.start()
        try:
            for i in range(6):
                await mb.score(x[i], entity=ent(i))
            await asyncio.gather(*(mb.score(x[i], entity=ent(i) if i % 3 else None)
                                   for i in range(6, 30)))
            await asyncio.to_thread(boat.take_snapshot)
            fps = np.asarray([0 if i % 9 == 0 else entity_fingerprint(f"card-{i % 5}")
                              for i in range(20)], np.uint32)
            slot, n, cols = binlane.block_from_arrays(
                scorer, x[30:50], fps, spec.ts_origin + t0 + 200.0 + np.arange(20.0), 64)
            try:
                await mb.score_block(IngestBlock(slot, n, cols))
            finally:
                scorer.staging.release(slot)
            await asyncio.gather(*(mb.score(x[i], entity=ent(i) if i % 4 else None)
                                   for i in range(50, 80)))
        finally:
            await mb.stop()

    asyncio.run(run())


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_recovery_is_bitwise_the_table_the_batcher_served(trained, tmp_path, monkeypatch, wire):
    """A MicroBatcher with a watchtower and a lifeboat serves entity rows
    (single rows, bursts with null rows, an ingest block) on ``wire``; the
    boat is closed without a final snapshot. A fresh boat on a fresh
    monitor holding the train-time stamp recovers the generation cut
    mid-traffic plus the journal tail: bitwise the served table, and the
    window as the generation holds it."""
    monkeypatch.setenv("SCORER_WIRE", wire)
    model = FraudLogisticModel.load(trained["dir"], device="cpu")
    spec = model.ledger_spec
    assert model.scorer.io_dtype == wire
    profile = load_profile(trained["dir"])
    wt = Watchtower(profile, thresholds=NEVER, device="cpu")
    wt.drift.bind_ledger(spec, model.ledger_state)
    boat = _boat(tmp_path, spec, wt.drift)
    boat.recover()
    boat.start()
    mb = MicroBatcher(model.scorer, watchtower=wt, telemetry=False, max_batch=64,
                      max_wait_ms=2.0, explain=True, explain_k=3, lifeboat=boat)
    try:
        _drive(mb, model.scorer, spec, trained["x"], boat)
        served = wt.drift.ledger_snapshot()
    finally:
        boat.close()
        wt.close()
    gens = list_snapshots(str(tmp_path))
    assert len(gens) == 1 and gens[0][0] >= 7
    tail = read_tail(str(tmp_path), gens[0][0])
    assert tail.n_records >= 2 and tail.torn_rows == 0
    mon = DriftMonitor(profile, device="cpu")
    mon.bind_ledger(spec, model.ledger_state)
    fresh = _boat(tmp_path, spec, mon)
    rep = fresh.recover()
    fresh.close()
    assert rep.restored and rep.snapshot_seq == gens[0][0]
    # the block's 17 entity rows and the last burst's 23
    assert rep.replayed_rows == tail.fp.shape[0] == 17 + 23
    assert _tables_equal(mon.ledger_snapshot(), served)
    assert not _tables_equal(served, model.ledger_state)
    window = load_snapshot(gens[0][1]).window
    for name in WINDOW_FIELDS:
        assert getattr(mon.window, name).numpy().tobytes() == getattr(window, name).tobytes()


# -- the app: the 503 gate, /lifeboat/status ---------------------------------


class _LoopThread:
    """A background event loop: the app's handlers and the binary lane's
    admissions run on it, as under the HTTP server."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._t = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._t.start()

    def call(self, coro, timeout=120.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def request(self, app, method, path, body=b"", ctype="application/json"):
        return self.call(app.dispatch(Request(method, path, {"content-type": ctype}, body)))

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._t.join(timeout=5.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def app_env(trained, tmp_path, monkeypatch):
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("MODEL_PATH", os.path.join(trained["dir"], "model.npz"))
    monkeypatch.setenv("MLFLOW_TRACKING_URI", f"file:{tmp_path}/empty_mlruns")
    monkeypatch.setenv("SCORER_EXPLAIN", "topk")
    monkeypatch.setenv("LIFEBOAT_FSYNC_S", "0")
    monkeypatch.setenv("LIFECYCLE_RELOAD_INTERVAL_S", "0")
    for var in ("SCORER_WIRE", "LIFEBOAT_SNAPSHOT_FLUSHES", "INGEST_PORT"):
        monkeypatch.delenv(var, raising=False)
    return {"db": dict(database_url=f"sqlite:///{tmp_path}/fraud.db",
                       broker_url=f"sqlite:///{tmp_path}/taskq.db")}


def _predict_body(x, i, t0):
    import json

    return json.dumps({"features": x[i].tolist(), "entity_id": f"card-{i % 5}",
                       "timestamp": t0 + 2.0 * i}).encode()


def test_app_answers_503_while_recovering_then_serves_the_recovered_table(
        trained, app_env, tmp_path, monkeypatch):
    """A first app journals 12 entity-keyed /predict and shuts down. A
    second app on the same LIFEBOAT_DIR, its recovery stalled by a fault
    plan: /health, /predict and /ingest/batch answer 503 with
    ``retry-after: 5``, a binary-lane frame is refused (status 3) and the
    connection scores once the stall is released; /lifeboat/status then
    reports the restored journal rows, and the table is the first app's."""
    x = trained["x"]
    spec, _ = load_ledger(trained["dir"])
    t0 = spec.ts_origin + 9000.0
    monkeypatch.setenv("LIFEBOAT_DIR", str(tmp_path / "lb"))
    lt = _LoopThread()
    try:
        app1 = create_app(**app_env["db"])
        lt.call(app1.startup())
        boat1 = app1.state["lifeboat"]
        while boat1.state != "ready":
            threading.Event().wait(0.01)
        # a generation of the train-time stamp: the recovery's base (a
        # journal-only recovery replays onto a fresh table, as the reference)
        assert boat1.take_snapshot() is not None
        for i in range(12):
            r = lt.request(app1, "POST", "/predict", _predict_body(x, i, t0))
            assert r.status_code == 200, r.body
        served = app1.state["watchtower"].drift.ledger_snapshot()
        lt.call(app1.shutdown())

        port = _free_port()
        monkeypatch.setenv("INGEST_PORT", str(port))
        monkeypatch.setenv("INGEST_HOST", "127.0.0.1")
        gate = threading.Event()
        plan = faults.FaultPlan().call("lifeboat.recover", lambda **_: gate.wait(60))
        app2 = create_app(**app_env["db"])
        with plan.armed():
            lt.call(app2.startup())
            assert app2.state["lifeboat"].state == "recovering"
            frame = binlane.encode_frame(x[:4], None, None, length_prefix=False)
            for method, path, body, ctype in (
                    ("GET", "/health", b"", "application/json"),
                    ("POST", "/predict", _predict_body(x, 0, t0), "application/json"),
                    ("POST", "/ingest/batch", frame, "application/x-fraud-frame")):
                r = lt.request(app2, method, path, body, ctype)
                assert r.status_code == 503 and r.headers["retry-after"] == "5", (path, r.body)
            with binlane.BinLaneClient("127.0.0.1", port) as cli:
                with pytest.raises(binlane.LaneBusy) as e:
                    cli.score_batch(x[:4])
                assert e.value.status == 3 and e.value.retry_after_s == 5.0
                gate.set()
                while app2.state["lifeboat"].state != "ready":
                    threading.Event().wait(0.01)
                scores, _ = cli.score_batch(x[:4])
                assert scores.shape == (4,) and np.all((scores >= 0) & (scores <= 1))
            assert plan.fired("lifeboat.recover") == 1
        body = lt.request(app2, "GET", "/lifeboat/status").json()
        assert body["enabled"] and body["state"] == "ready"
        last = body["last_recovery"]
        assert last["restored"] and last["snapshot_seq"] == 0
        assert last["replayed_rows"] == 12 and last["torn_rows"] == 0
        # the frame's 4 entity-less rows left the recovered table as it was
        assert _tables_equal(app2.state["watchtower"].drift.ledger_snapshot(), served)
        assert lt.request(app2, "GET", "/health").status_code == 200
        lt.call(app2.shutdown())
    finally:
        lt.close()


def test_lifeboat_status_disabled_without_a_ledger(app_env, tmp_path, monkeypatch, caplog):
    """Without LIFEBOAT_DIR, and with it beside a stateless model (WARNING:
    the durability layer is off), ``/lifeboat/status`` answers
    ``{"enabled": false, "state": "disabled"}``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lt = _LoopThread()
    try:
        for lb in (None, str(tmp_path / "lb")):
            if lb is None:
                monkeypatch.delenv("LIFEBOAT_DIR", raising=False)
            else:
                monkeypatch.setenv("LIFEBOAT_DIR", lb)
                monkeypatch.setenv("MODEL_PATH", os.path.join(root, "models", "model.npz"))
            app = create_app(**app_env["db"])
            with caplog.at_level("WARNING"):
                lt.call(app.startup())
            assert lt.request(app, "GET", "/lifeboat/status").json() == \
                {"enabled": False, "state": "disabled"}
            lt.call(app.shutdown())
    finally:
        lt.close()
    assert "LIFEBOAT_DIR set but the served model carries no ledger" in caplog.text


# -- the hot swap: the boat keeps the start-up monitor, in both packages ----


def test_hot_swap_leaves_the_boat_on_the_start_up_monitor(tmp_path):
    """Kept as the reference has it: the boat is built on the start-up
    drift monitor, and ``rebind_champion`` replaces ``watchtower.drift``
    without re-pointing it. After a promotion the boat's snapshot still
    copies the old monitor's table, not the served one — in the JAX package
    and in the port alike."""
    spec_kw = dict(n_base=D, slots=SLOTS, halflife_s=600.0, amount_col=-1,
                   null_features=np.zeros(LEDGER_K, np.float32))
    rng = np.random.default_rng(1)
    xw = rng.standard_normal((256, D + LEDGER_K)).astype(np.float32)
    sc = rng.uniform(0, 1, 256).astype(np.float32)
    old, new = _table(21), _table(22)
    cases = (
        ("port", LedgerSpec(**spec_kw), Lifeboat,
         lambda: Watchtower(build_baseline_profile(xw, sc, device="cpu"), thresholds=NEVER,
                            device="cpu"),
         lambda: build_baseline_profile(xw, sc, device="cpu")),
        ("jax", JaxSpec(**spec_kw), JaxLifeboat,
         lambda: JaxWatchtower(jax_profile(xw, sc), thresholds=JaxThresholds(
             5.0, 5.0, 5.0, 1.0, 10**9)),
         lambda: jax_profile(xw, sc)),
    )
    for name, spec, boat_cls, make_wt, make_profile in cases:
        wt = make_wt()
        try:
            wt.drift.bind_ledger(spec, old)
            boat = boat_cls(str(tmp_path / name), spec, drift=wt.drift, snapshot_s=1e9,
                            fsync_s=0.0)
            boat.recover()
            start_up = wt.drift
            wt.rebind_champion(make_profile(), ledger=(spec, new))
            assert wt.drift is not start_up and boat.drift is start_up, name
            path = boat.take_snapshot()
            boat.close()
        finally:
            wt.close()
        snap = load_snapshot(path)
        assert _tables_equal(snap.ledger, old) and not _tables_equal(snap.ledger, new), name
