"""The port's longhaul fleet against the JAX package's, on the CPU, from the
same seeded numpy inputs: the two-level placement over every (segment, live
set), the segment merge (bitwise on host tables, and on the port's device
form bitwise the host merge), the membership directory (epochs, sticky
ranks, the restart fence, the sweeper, the wire and its auth — each
package's client against the other's server), the codecs byte for byte in
all three formats, the front's routing and degradation ladder against stub
hosts, the epoch-fenced scrape merges, ``lifecycle_db_url``'s multi-host
refusal and ``drop_host_gauges``; then one real fleet of two
``python -m fraud_detection_tpu_torch.longhaul.host`` children with
``DEVICE=cpu`` behind an in-process directory and front: binary-routed
scores bitwise the in-process reference's, a SIGKILL, the typed 503, the
failover and the survivor's table bitwise the reference's."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu import config as jax_config
from fraud_detection_tpu.ledger.state import LedgerSpec as JaxSpec
from fraud_detection_tpu.ledger.state import LedgerState as JaxState
from fraud_detection_tpu.longhaul import codec as jcodec
from fraud_detection_tpu.longhaul import front as jfront
from fraud_detection_tpu.longhaul import membership as jmem
from fraud_detection_tpu.longhaul import placement as jplace
from fraud_detection_tpu.longhaul import scrape as jscrape
from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ledger.state import (
    LEDGER_K,
    LedgerSpec,
    LedgerState,
    device_state,
    host_state,
)
from fraud_detection_tpu_torch.longhaul import codec, front, membership, placement, scrape
from fraud_detection_tpu_torch.longhaul.codec import Unavailable
from fraud_detection_tpu_torch.service import metrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 6


def _specs(slots: int = 64):
    kw = dict(n_base=D, slots=slots, halflife_s=600.0, amount_col=-1,
              null_features=np.zeros(LEDGER_K, np.float32))
    return LedgerSpec(**kw), JaxSpec(**kw)


def _filled(slots: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        acc=rng.standard_normal((slots, 3)).astype(np.float32),
        last_ts=rng.random(slots).astype(np.float32),
        fingerprint=rng.integers(1, 2**32, slots, dtype=np.uint32),
        collisions=np.asarray(np.float32(36.0 + seed)),
        evictions=np.asarray(np.float32(2.0 + seed / 4)),
    )


def _leaf_bytes(state) -> list[bytes]:
    return [np.asarray(leaf).tobytes() for leaf in host_state(state)]


# -- placement ----------------------------------------------------------------


def test_host_of_scalar_and_array_match_jax():
    for slot in range(12):
        for n in (1, 2, 3, 4):
            assert placement.host_of(slot, n) == jplace.host_of(slot, n)
    np.testing.assert_array_equal(placement.host_of(np.arange(9), 3),
                                  jplace.host_of(np.arange(9), 3))


@pytest.mark.parametrize("n_hosts", [2, 3, 4])
def test_placement_matches_jax_over_every_live_set(n_hosts):
    """``segment_owner``, ``owned_segments`` and ``segment_mask`` over every
    (segment, live set), the empty live set's refusal among them."""
    import itertools

    for k in range(n_hosts + 1):
        for live in itertools.combinations(range(n_hosts), k):
            for seg in range(n_hosts):
                if not live:
                    with pytest.raises(ValueError):
                        placement.segment_owner(seg, live, n_hosts)
                    with pytest.raises(ValueError):
                        jplace.segment_owner(seg, live, n_hosts)
                    continue
                assert placement.segment_owner(seg, live, n_hosts) == \
                    jplace.segment_owner(seg, live, n_hosts)
            for rank in live:
                assert placement.owned_segments(rank, live, n_hosts) == \
                    jplace.owned_segments(rank, live, n_hosts)
            segs = list(live)
            np.testing.assert_array_equal(placement.segment_mask(64, segs, n_hosts),
                                          jplace.segment_mask(64, segs, n_hosts))
    with pytest.raises(ValueError):
        placement.segment_owner(n_hosts + 3, [0], n_hosts)


def test_merge_segment_on_host_tables_is_bitwise_jax():
    dst, src = _filled(64, 1), _filled(64, 2)
    got = placement.merge_segment(LedgerState(**dst), LedgerState(**src), [1], 2,
                                  baseline=(36.0, 2.0))
    want = jplace.merge_segment(JaxState(**dst), JaxState(**src), [1], 2,
                                baseline=(36.0, 2.0))
    assert _leaf_bytes(got) == [np.asarray(leaf).tobytes() for leaf in want]
    assert got.fingerprint.dtype == np.uint32
    for segs in ([0], [1], [0, 1]):
        assert placement.segments_equal(got, LedgerState(**src), segs, 2) == \
            jplace.segments_equal(want, JaxState(**src), segs, 2)


@pytest.mark.parametrize("src_form", ["host", "device"])
def test_merge_segment_of_the_live_table_is_bitwise_jax(src_form):
    """What an inheritance does: the live table (tensors, int64 fingerprint)
    merged with a recovered table (host, uint32) or another live one gives
    the host merge, bitwise JAX's in the file's dtypes with the counters in
    float32's ``(dst + src) − baseline`` order; bound back to the device it
    has the live table's dtypes and shapes."""
    dst, src = _filled(64, 3), _filled(64, 4)
    live = device_state(LedgerState(**dst), 64, "cpu")
    other = LedgerState(**src) if src_form == "host" else device_state(LedgerState(**src), 64, "cpu")
    got = placement.merge_segment(live, other, [0], 2, baseline=(36.5, 2.25))
    want = jplace.merge_segment(JaxState(**dst), JaxState(**src), [0], 2,
                                baseline=(36.5, 2.25))
    assert _leaf_bytes(got) == [np.asarray(leaf).tobytes() for leaf in want]
    assert got.fingerprint.dtype == np.uint32
    bound = device_state(got, 64, "cpu")
    for a, b in zip(bound, live):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device)


# -- membership ---------------------------------------------------------------


def test_directory_join_epochs_and_sticky_ranks_match_jax(tmp_path):
    views = []
    for mod, sub in ((membership, "port"), (jmem, "jax")):
        d = mod.DirectoryServer(str(tmp_path / sub), n_hosts=2, token="")
        seq = [d.epoch, d.join("ha", "127.0.0.1:1").to_dict(),
               d.join("hb", "127.0.0.1:2").to_dict()]
        with pytest.raises(ValueError, match="fleet full"):
            d.join("hc", "127.0.0.1:3")
        seq += [d.mark_dead("hb").to_dict(), d.join("hb", "127.0.0.1:9").to_dict(),
                d.leave("ha").to_dict(), d.heartbeat("ha"), d.heartbeat("hb")]
        views.append(seq)
        d.close()
    assert views[0] == views[1]
    last = membership.MembershipView.from_dict(views[0][4])
    assert last.member_by_rank(1).addr == "127.0.0.1:9" and last.live_ranks == (0, 1)


def test_directory_restart_bumps_epoch_and_resets_liveness(tmp_path):
    d = membership.DirectoryServer(str(tmp_path), n_hosts=2, token="")
    d.join("ha", "127.0.0.1:1")
    d.join("hb", "127.0.0.1:2")
    e_live = d.epoch
    d.close()
    # the JAX package's directory restarts from the port's durable state,
    # and the port's from the JAX one's: the file is shared
    j = jmem.DirectoryServer(str(tmp_path), n_hosts=2, token="")
    j.close()
    d2 = membership.DirectoryServer(str(tmp_path), n_hosts=2, token="")
    try:
        assert d2.epoch == e_live + 2
        v = d2.view()
        assert v.member_by_rank(0).host_id == "ha"
        assert not any(m.alive for m in v.members)
        assert d2.heartbeat("ha")["stale"] is True
        assert d2.join("ha", "127.0.0.1:1").member_by_rank(0).alive
    finally:
        d2.close()


def test_sweeper_declares_silent_member_dead(tmp_path):
    d = membership.DirectoryServer(str(tmp_path), n_hosts=2, dead_after_s=0.2, token="")
    d.start()
    try:
        e_joined = d.join("ha", "127.0.0.1:1").epoch
        metrics.longhaul_host_heartbeat_age.labels("ha").set(0.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and d.view().member_by_rank(0).alive:
            time.sleep(0.05)
        v = d.view()
        assert not v.member_by_rank(0).alive and v.epoch == e_joined + 1
        assert d.heartbeat("ha")["stale"] is True
        assert metrics.longhaul_host_up.get("ha") == 0
        assert ("ha",) not in metrics.longhaul_host_heartbeat_age._children
        assert metrics.longhaul_membership_epoch.get() == v.epoch
    finally:
        d.close()


@pytest.mark.parametrize("server_pkg, client_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port"),
])
def test_directory_client_wire_and_auth_across_packages(server_pkg, client_pkg, tmp_path):
    smod = membership if server_pkg == "port" else jmem
    cmod = membership if client_pkg == "port" else jmem
    d = smod.DirectoryServer(str(tmp_path), n_hosts=2, token="tok")
    d.start()
    try:
        cl = cmod.DirectoryClient(d.addr, token="tok")
        v = cl.join("ha", "127.0.0.1:1")
        assert v.member_by_rank(0).host_id == "ha"
        assert cl.heartbeat("ha")["stale"] is False
        assert cl.view().live_ranks == (0,)
        assert not cl.mark_dead("ha").member_by_rank(0).alive
        assert cl.view().to_dict() == d.view().to_dict()
        with pytest.raises(RuntimeError, match="unauthorized"):
            cmod.DirectoryClient(d.addr, token="wrong").view()
    finally:
        d.close()


def test_membership_view_dict_roundtrip_matches_jax():
    members = (("ha", 0, "127.0.0.1:1", True), ("hb", 1, "127.0.0.1:2", False))
    v = membership.MembershipView(9, 2, tuple(membership.MemberInfo(*m) for m in members))
    j = jmem.MembershipView(9, 2, tuple(jmem.MemberInfo(*m) for m in members))
    assert v.to_dict() == j.to_dict()
    assert membership.MembershipView.from_dict(j.to_dict()) == v
    assert v.live_ranks == j.live_ranks == (0,)


# -- codecs -------------------------------------------------------------------


def test_pack_array_matches_jax_bytes():
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal((5, 3)).astype(np.float32),
                np.arange(7, dtype=np.uint32), np.float32(41.5), np.zeros((0, 4), np.float64)):
        got = codec.pack_array(np.asarray(arr))
        assert got == jcodec.pack_array(np.asarray(arr))
        back = codec.unpack_array(got)
        assert back.dtype == np.asarray(arr).dtype and back.shape == np.asarray(arr).shape
        assert back.tobytes() == np.asarray(arr).tobytes()
    t = torch.as_tensor(rng.standard_normal((4, 2)).astype(np.float32))
    assert codec.pack_array(t) == jcodec.pack_array(t.numpy())


@pytest.mark.parametrize("form", ["host", "device"])
def test_pack_table_is_the_jax_wire(form):
    """A table of either form goes on the wire in the file's dtypes (the
    uint32 fingerprint): the JAX package's bytes, and back to the host."""
    leaves = _filled(32, 5)
    st = LedgerState(**leaves)
    if form == "device":
        st = device_state(st, 32, "cpu")
    packed = codec.pack_table(st)
    assert packed == jcodec.pack_table(JaxState(**leaves))
    back = codec.unpack_table(packed)
    assert [np.asarray(x).tobytes() for x in back] == \
        [np.asarray(leaves[k]).tobytes() for k in LedgerState._fields]
    assert [np.asarray(x).tobytes() for x in jcodec.unpack_table(packed)] == \
        [np.asarray(x).tobytes() for x in back]


@pytest.mark.parametrize("fmt", codec.FORMATS)
def test_request_bytes_and_decode_match_jax(fmt):
    spec, jspec = _specs()
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((4, D)).astype(np.float32)
    entities = ["card-1", None, "card-2", "card-1"]
    ts = [10.0, 0.0, 11.5, 12.25]
    payload = codec.encode_request(rows, entities, ts, fmt, spec=spec)
    assert payload == jcodec.encode_request(rows, entities, ts, fmt, spec=jspec)
    rows2, ents2 = codec.decode_request(payload, fmt, spec)
    jrows, jents = jcodec.decode_request(payload, fmt, jspec)
    assert rows2.tobytes() == jrows.tobytes() == rows.tobytes()
    assert ents2 == jents == [None if e is None else (*spec.row_keys(e), float(t))
                              for e, t in zip(entities, ts)]


@pytest.mark.parametrize("fmt", codec.FORMATS)
def test_response_and_503_bytes_match_jax(fmt):
    scores = np.asarray([0.25, 0.5, 0.875, 1e-7], np.float32)
    payload = codec.encode_response(scores, fmt)
    assert payload == jcodec.encode_response(scores, fmt)
    assert codec.decode_response(payload, fmt).tobytes() == scores.tobytes()
    busy = codec.encode_unavailable("owner inheriting", 1.5, fmt)
    assert busy == jcodec.encode_unavailable("owner inheriting", 1.5, fmt)
    with pytest.raises(Unavailable) as ei:
        codec.decode_response(busy, fmt)
    assert ei.value.retry_after_s == 1.5 and "inheriting" in str(ei.value)


def test_msgpack_absent_raises_the_import_error_naming_it(monkeypatch):
    """Where msgpack is not installed (the card's machine), asking for it
    raises the ImportError that names it; JSON and binary go on."""
    spec, _ = _specs()
    monkeypatch.setitem(sys.modules, "msgpack", None)
    rows = np.ones((1, D), np.float32)
    with pytest.raises(ImportError, match="msgpack"):
        codec.encode_request(rows, [None], [0.0], "msgpack", spec=spec)
    with pytest.raises(ImportError, match="msgpack"):
        codec.decode_response(b"\x81", "msgpack")
    for fmt in ("json", "binary"):
        assert codec.decode_request(codec.encode_request(rows, [None], [0.0], fmt, spec=spec),
                                    fmt, spec)[0].tobytes() == rows.tobytes()


def test_unknown_format_is_refused_as_jax_refuses_it():
    spec, jspec = _specs()
    for fn, jfn, args in ((codec.decode_request, jcodec.decode_request, (b"{}", "xml", spec)),
                          (codec.encode_response, jcodec.encode_response, (np.ones(1), "xml"))):
        with pytest.raises(ValueError) as a:
            fn(*args)
        with pytest.raises(ValueError) as b:
            jfn(*args[:-1], jspec) if fn is codec.decode_request else jfn(*args)
        assert str(a.value) == str(b.value)


# -- the front ----------------------------------------------------------------


def _fronts(n_hosts: int = 2, **kw):
    """The port's and the JAX package's fronts over the same static view."""
    kw.setdefault("probation_s", 0.05)
    kw.setdefault("retry_after_s", 0.5)
    out = []
    for fmod, mmod, spec in ((front, membership, _specs()[0]), (jfront, jmem, _specs()[1])):
        view = mmod.MembershipView(epoch=3, n_hosts=n_hosts, members=tuple(
            mmod.MemberInfo(f"h{r}", r, f"127.0.0.1:{7400 + r}", True)
            for r in range(n_hosts)))
        out.append(fmod.LonghaulFront(spec, n_hosts, view=view, token="", **kw))
    return out


def test_front_groups_rows_by_segment_and_reassembles():
    for f, cmod in zip(_fronts(), (codec, jcodec)):
        seen: dict[int, list] = {0: [], 1: []}

        def make(rank, cmod=cmod, seen=seen):
            def call(op, args, timeout=30.0):
                assert op == "score"
                rows = cmod.unpack_array(args["rows"])
                seen[rank].append([tuple(e) for e in args["ents"] if e])
                return {"scores": cmod.pack_array(rows[:, 0].copy())}
            return call

        f.handles[0].call, f.handles[1].call = make(0), make(1)
        rows = np.arange(5 * D, dtype=np.float32).reshape(5, D)
        # slots 2, 4 → segment 0; 3, 5 → segment 1; None rides segment 0
        ents = [(2, 11, 1.0), (3, 12, 1.0), None, (5, 13, 1.0), (4, 14, 1.0)]
        np.testing.assert_array_equal(f.score(rows, ents, fmt="json"), rows[:, 0])
        assert {s for b in seen[0] for s, _, _ in b} == {2, 4}
        assert {s for b in seen[1] for s, _, _ in b} == {3, 5}
    port, jax_ = _fronts()
    assert port.status() == jax_.status()


def test_front_backpressure_is_not_a_strike():
    for f, cmod in zip(_fronts(), (codec, jcodec)):
        f.handles[1].call = lambda op, args, timeout=30.0: {
            "unavailable": True, "retry_after_s": 2.5, "reason": "inheriting"}
        before = metrics.longhaul_unavailable.get()
        with pytest.raises(cmod.Unavailable) as ei:
            f.score(np.ones((1, D), np.float32), [(1, 9, 1.0)])
        assert ei.value.retry_after_s == 2.5
        h = f.handles[1]
        assert h.consecutive_errors == 0 and h.state == "healthy"
        if cmod is codec:  # the port's front counts its 503 on the port's series
            assert metrics.longhaul_unavailable.get() == before + 1


def test_front_death_probation_and_revival():
    def boom(op, args, timeout=30.0):
        raise ConnectionError("wire down")

    rows, ents = np.ones((1, D), np.float32), [(1, 9, 1.0)]
    for f, cmod in zip(_fronts(death_threshold=2), (codec, jcodec)):
        f.handles[1].call = boom
        for _ in range(2):
            with pytest.raises(cmod.Unavailable):
                f.score(rows, ents)
        assert f.handles[1].state == "dead"
        with pytest.raises(cmod.Unavailable, match="probation"):
            f.score(rows, ents)
        time.sleep(0.06)
        f.handles[1].call = lambda op, args, timeout=30.0, cmod=cmod: {
            "scores": cmod.pack_array(np.zeros(1, np.float32))}
        f.score(rows, ents)
        assert f.handles[1].state == "healthy" and f.handles[1].consecutive_errors == 0
    assert metrics.longhaul_route_errors.get("h1") >= 2


def test_front_last_healthy_host_is_never_given_up():
    def boom(op, args, timeout=30.0):
        raise ConnectionError("wire down")

    for f, cmod in zip(_fronts(n_hosts=1, death_threshold=2), (codec, jcodec)):
        f.handles[0].call = boom
        for _ in range(5):
            with pytest.raises(cmod.Unavailable):
                f.score(np.ones((1, D), np.float32), [(0, 9, 1.0)])
        h = f.handles[0]
        assert h.consecutive_errors >= 5 and h.state == "healthy"


@pytest.mark.parametrize("fmt", codec.FORMATS)
def test_front_handles_request_end_to_end_with_503_floor(fmt):
    """The same payloads through both fronts over the same stub hosts: the
    answers are the same bytes, the served one and the 503 in the caller's
    format."""
    spec, jspec = _specs()
    answers = []
    for f, cmod, sp in zip(_fronts(), (codec, jcodec), (spec, jspec)):
        f.handles[0].call = lambda op, args, timeout=30.0, cmod=cmod: {
            "scores": cmod.pack_array(np.full(cmod.unpack_array(args["rows"]).shape[0],
                                              0.25, np.float32))}
        f.handles[1].call = lambda op, args, timeout=30.0: {
            "unavailable": True, "retry_after_s": 1.0, "reason": "inheriting"}
        rows = np.ones((2, D), np.float32)
        ok = f.handle_request(cmod.encode_request(rows, [None, None], [0.0, 0.0], fmt, spec=sp), fmt)
        seg1 = next(e for e in (f"card-{i}" for i in range(64)) if sp.row_keys(e)[0] % 2 == 1)
        bad = f.handle_request(cmod.encode_request(rows[:1], [seg1], [1.0], fmt, spec=sp), fmt)
        answers.append((ok, bad))
    assert answers[0] == answers[1]
    np.testing.assert_array_equal(codec.decode_response(answers[0][0], fmt), [0.25, 0.25])
    with pytest.raises(Unavailable) as ei:
        codec.decode_response(answers[0][1], fmt)
    assert ei.value.retry_after_s == 1.0


# -- the scrape merges --------------------------------------------------------


def _window_contrib(cmod, host, epoch, base=1.0):
    leaves = [np.full((4, 3), base, np.float32), np.full((4,), base, np.float32),
              np.full((3,), base, np.float32), np.full((3,), base / 2, np.float32),
              np.full((3,), base / 4, np.float32), np.float32(base * 8)]
    return {
        "host_id": host, "epoch": epoch, "rows_seen": int(base * 8),
        "window": [cmod.pack_array(np.asarray(x)) for x in leaves],
        "slo": {"availability": {
            "objective": 0.99, "window_good": int(90 * base), "window_bad": int(base),
            "total_good": int(900 * base), "total_bad": int(10 * base)}},
    }


def _contribs(cmod):
    return [_window_contrib(cmod, "ha", 5, 1.0), _window_contrib(cmod, "hb", 4, 100.0),
            _window_contrib(cmod, "hc", 5, 2.0)]


def test_merge_drift_windows_matches_jax_and_counts_the_stale_host():
    from fraud_detection_tpu_torch.monitor.drift import _window_leaves

    before = metrics.longhaul_scrape_stale_epoch.get("hb")
    merged, accepted, stale = scrape.merge_drift_windows(_contribs(codec), epoch=5)
    jmerged, jaccepted, jstale = jscrape.merge_drift_windows(_contribs(jcodec), epoch=5)
    assert (accepted, stale) == (jaccepted, jstale) == (["ha", "hc"], ["hb"])
    assert [np.asarray(x).tobytes() for x in _window_leaves(merged)] == \
        [np.asarray(x).tobytes() for x in jmerged]
    assert float(merged.n_rows) == 24.0
    assert metrics.longhaul_scrape_stale_epoch.get("hb") == before + 1
    assert scrape.merge_drift_windows([], 5) == (None, [], [])


def test_merge_slo_status_matches_jax_and_refreshes_the_fleet_gauge():
    agg = scrape.merge_slo_status(_contribs(codec), epoch=5)
    assert agg == jscrape.merge_slo_status(_contribs(jcodec), epoch=5)
    a = agg["availability"]
    assert a["hosts"] == 2 and (a["window_good"], a["window_bad"]) == (270, 3)
    assert metrics.longhaul_fleet_budget_remaining.get("availability") == a["budget_remaining"]


def test_fleet_scrape_skips_unreachable_hosts():
    class Dead:
        host_id = "hdead"

        def call(self, op, args):
            raise ConnectionError("gone")

    class Live:
        host_id = "ha"

        def __init__(self, cmod):
            self.cmod = cmod

        def call(self, op, args):
            return _window_contrib(self.cmod, "ha", 7, 1.0)

    out = scrape.fleet_scrape([Live(codec), Dead()], epoch=7)
    jout = jscrape.fleet_scrape([Live(jcodec), Dead()], epoch=7)
    for key in ("epoch", "slo", "rows_seen", "accepted", "stale", "unreachable"):
        assert out[key] == jout[key]
    assert out["unreachable"] == ["hdead"] and out["rows_seen"] == 8


# -- config and metrics hygiene ----------------------------------------------


def test_lifecycle_db_url_refuses_the_split_brain_fallback(monkeypatch):
    monkeypatch.delenv("LIFECYCLE_DB_URL", raising=False)
    monkeypatch.setenv("LONGHAUL_HOSTS", "2")
    msgs = []
    for cfg in (config, jax_config):
        with pytest.raises(RuntimeError, match="LONGHAUL_HOSTS") as ei:
            cfg.lifecycle_db_url(broker="fraud://store:7300/0")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]  # word for word
    # a SQL broker carries the fleet's tables: no refusal
    assert config.lifecycle_db_url(broker="sqlite:////tmp/q.db") == "sqlite:////tmp/q.db"
    monkeypatch.setenv("LONGHAUL_HOSTS", "1")
    assert config.lifecycle_db_url(broker="fraud://store:7300/0").startswith("sqlite")
    monkeypatch.setenv("LONGHAUL_HOSTS", "2")
    monkeypatch.setenv("LIFECYCLE_DB_URL", "postgresql://db/fleet")
    assert config.lifecycle_db_url(broker="fraud://store:7300/0") == "postgresql://db/fleet"


def test_drop_host_gauges_removes_stale_series():
    metrics.longhaul_host_heartbeat_age.labels("h-stale").set(4.2)
    assert 'longhaul_host_heartbeat_age_seconds{host="h-stale"} 4.2' in metrics.render().decode()
    metrics.drop_host_gauges("h-stale")
    assert 'host="h-stale"' not in metrics.render().decode()
    metrics.drop_host_gauges("h-never")  # idempotent on a never-written host


def test_longhaul_series_are_the_jax_packages():
    from fraud_detection_tpu.service import metrics as jmetrics

    names = [n for n in dir(jmetrics) if n.startswith("longhaul_")]
    assert len(names) == 15
    for n in names:
        j, p = getattr(jmetrics, n), getattr(metrics, n)
        assert p.name == j._name and p.labelnames == tuple(j._labelnames)
        assert p.kind == j._type


# -- the host backend ---------------------------------------------------------


def test_backend_releases_its_staging_slot_each_flush(tmp_path):
    """``score_items`` copies the scores out of the flush's pooled staging
    slot and releases it: routed batches allocate no new slot."""
    from fraud_detection_tpu_torch.longhaul.host import build_seeded_backend
    from fraud_detection_tpu_torch.range.scenarios import _entity_batches, _keyed_batches

    b, t0 = build_seeded_backend(7, str(tmp_path), "h0", device="cpu")
    try:
        batches = _keyed_batches(b.spec, _entity_batches(7, 12, 16, t0))
        outs, allocs = [], []
        for r, ke in batches:
            outs.append(b.score_items([(r[i], None, None, ke[i]) for i in range(r.shape[0])]))
            allocs.append(b.scorer.staging.allocations)
        assert allocs == [allocs[0]] * len(batches)
        assert all(o.dtype == np.float32 and o.shape == (16,) for o in outs)
        assert not np.shares_memory(outs[0], outs[1])
        assert b.device == torch.device("cpu") and b.baseline_counters[0] >= 0.0
    finally:
        b.close()


def test_host_entry_point_refuses_without_a_card_or_device_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DEVICE", None)
    out = subprocess.run(
        [sys.executable, "-m", "fraud_detection_tpu_torch.longhaul.host", "--host-id", "x",
         "--port", "0", "--n-hosts", "1", "--data-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "LONGHAUL_READY" not in out.stdout


@pytest.mark.parametrize("env, argv, want", [
    ({}, [], ("host-0", "127.0.0.1:7300")),
    ({"LONGHAUL_HOST_ID": "host-7", "LONGHAUL_DIRECTORY": "10.0.0.5:7301"}, [],
     ("host-7", "10.0.0.5:7301")),
    ({"LONGHAUL_HOST_ID": "host-7", "LONGHAUL_DIRECTORY": "10.0.0.5:7301"},
     ["--host-id", "h1", "--directory", ""], ("h1", None)),
])
def test_host_entry_point_reads_its_identity_and_directory_settings(env, argv, want,
                                                                     monkeypatch):
    """A flag left out takes its ``LONGHAUL_*`` setting; ``--directory ''``
    serves alone."""
    from fraud_detection_tpu_torch.longhaul import host as hmod

    for var in ("LONGHAUL_HOST_ID", "LONGHAUL_DIRECTORY", "LONGHAUL_HOSTS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    seen = {}

    class Backend:
        device = torch.device("cpu")

    class Server:
        addr = "127.0.0.1:1"

        def __init__(self, host_id, backend, n_hosts, port, directory_addr):
            seen.update(host_id=host_id, directory=directory_addr)

        def start(self):
            pass

        def close(self):
            seen["closed"] = True

    def interrupt(_s):
        raise KeyboardInterrupt

    def build(seed, data_dir, host_id):
        seen["built"] = host_id
        return Backend(), 0.0

    monkeypatch.setattr(hmod, "build_seeded_backend", build)
    monkeypatch.setattr(hmod, "HostServer", Server)
    monkeypatch.setattr(hmod.time, "sleep", interrupt)
    assert hmod.main(["--port", "0", "--data-dir", "", *argv]) == 0
    assert (seen["host_id"], seen["directory"]) == want
    assert seen["built"] == want[0] and seen["closed"]


# -- one real fleet: two host processes on the CPU ----------------------------


def test_subprocess_hosts_route_bitwise_and_fail_over(tmp_path):
    """Two host children with ``DEVICE=cpu`` behind an in-process directory:
    routed binary batches bitwise the in-process reference's scores, then a
    SIGKILL of rank 1's child, the typed 503 on its segment, the failover,
    and the survivor's table bitwise the reference's
    (``range.scenarios.longhaul_drill``, which chip_smoke runs on the card)."""
    from fraud_detection_tpu_torch.range.scenarios import longhaul_drill

    r = longhaul_drill(str(tmp_path), 2, 4, 64, "cpu", ["binary"] * 4)
    assert min(r["retry_after_s"]) > 0.0
    assert r["replayed_rows"] > 0 and r["torn_rows"] == 0
    assert r["routed_rows"] == 128 and r["post_rows"] == 128
