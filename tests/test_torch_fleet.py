"""The port's fleet reduce (``longhaul/fleet.py``) against the JAX package's,
on the CPU: the three transports, the wire shared across packages, the
pool summary and the fleet SGD fit (JAX's oracle, ``tests/test_longhaul.py``'s
fleet tests), the deliberate ``MeshReducer`` deviation, and two ``gloo``
rank processes through ``shardfit`` whose socket and mesh fits are the same
bytes.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fraud_detection_tpu.longhaul import fleet as jfleet
from fraud_detection_tpu_torch.longhaul import fleet
from fraud_detection_tpu_torch.longhaul.fleet import (
    LocalReducer,
    MeshReducer,
    SocketReducer,
    fleet_pool_stats,
    fleet_sgd_fit,
    make_reducer,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240
#: the two packages' fleet SGD fits on the same halves and seed: the map
#: bodies may sum in different orders (XLA's dot against torch's), so the
#: merged gradients can differ in their last bits and momentum carries it;
#: the measured gap on this fixture is 1.86e-9 on the coefficients (max
#: |coef| 0.73) and 0 on the intercept
SGD_JAX_ATOL = 1e-6


def _data(seed: int = 11, n: int = 64, d: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    s = rng.random(n).astype(np.float32)
    return x, y, s


def _sgd_data():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    w_true = np.asarray([1.0, -1.0, 0.5, 0.0, 2.0], np.float32)
    y = (x @ w_true + 0.1 * rng.standard_normal(64) > 0).astype(np.float32)
    return x, y


def _two_rank(fn, cls0=SocketReducer, cls1=SocketReducer, token0="t", token1="t"):
    """``fn(rank, reducer)`` on two socket ranks (rank 0 of ``cls0``, rank 1
    of ``cls1``: either package's), rank 1 in a thread: [rank0, rank1]."""
    r0 = cls0(0, 2, "127.0.0.1:0", token=token0)
    r1 = cls1(1, 2, r0.addr, token=token1, timeout=30.0)
    results, errs = [None, None], []

    def run(rank, red):
        try:
            results[rank] = fn(rank, red)
        except Exception as e:  # surfaced below
            errs.append(e)

    t = threading.Thread(target=run, args=(1, r1), daemon=True)
    t.start()
    try:
        run(0, r0)
        t.join(timeout=60.0)
    finally:
        r1.close()
        r0.close()
    assert not errs, errs
    return results


def _half(rank: int, n: int = 64) -> slice:
    return slice(0, n // 2) if rank == 0 else slice(n // 2, n)


# -- the transports ------------------------------------------------------------


def test_local_reducer_is_the_identity_byte_for_byte():
    arrays = [np.asarray([1.5, 2.5], np.float32), np.float32(3.0),
              np.arange(6, dtype=np.float64).reshape(2, 3)]
    got, want = LocalReducer().allreduce(arrays), jfleet.LocalReducer().allreduce(arrays)
    assert (LocalReducer.n_hosts, LocalReducer.rank) == (1, 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_make_reducer_dispatch():
    assert isinstance(make_reducer(n_hosts=1), LocalReducer)
    with pytest.raises(ValueError, match="coordinator addr"):
        make_reducer(rank=1, n_hosts=2, addr=None)
    red = make_reducer(rank=0, n_hosts=2, addr="127.0.0.1:0", token="t")
    try:
        assert isinstance(red, SocketReducer) and red.addr.startswith("127.0.0.1:")
    finally:
        red.close()
    assert not MeshReducer.available()  # no process group here


def test_socket_reducer_rank_order_sum_is_byte_identical():
    a0 = [np.asarray([0.1, 0.2, 0.3], np.float32), np.float32(0.7)]
    a1 = [np.asarray([1.0, 2.0, 3.0], np.float32), np.float32(1e-8)]

    def fn(rank, red):
        return [red.allreduce(a0 if rank == 0 else a1) for _ in range(3)]

    out0, out1 = _two_rank(fn)
    for step0, step1 in zip(out0, out1):
        for g0, g1, p, q in zip(step0, step1, a0, a1):
            assert g0.tobytes() == g1.tobytes() == (np.float32(p) + np.float32(q)).tobytes()
            assert g0.shape == np.shape(p)


@pytest.mark.parametrize("coordinator", ["jax", "port"])
def test_the_wire_is_jax_s(coordinator):
    """A JAX rank and a port rank on one wire, either coordinating: the
    rank-order sum, the same bytes on both."""
    a0 = np.asarray([0.1, -2.5, 3.25], np.float32)
    a1 = np.asarray([1e-3, 7.0, -0.125], np.float32)
    cls0, cls1 = ((jfleet.SocketReducer, SocketReducer) if coordinator == "jax"
                  else (SocketReducer, jfleet.SocketReducer))

    def fn(rank, red):
        return [red.allreduce([a0 if rank == 0 else a1, np.float32(rank + 1)])
                for _ in range(2)]

    out0, out1 = _two_rank(fn, cls0, cls1)
    for s0, s1 in zip(out0, out1):
        assert s0[0].tobytes() == s1[0].tobytes() == (a0 + a1).tobytes()
        assert float(s0[1]) == float(s1[1]) == 3.0


@pytest.mark.parametrize("coordinator", ["jax", "port"])
def test_a_wrong_token_is_refused_across_packages(coordinator):
    """The coordinator answers a bad token ``{"ok": False, "error":
    "unauthorized"}`` (the participant raises) and keeps accepting: a rank
    with the right token then completes the reduce."""
    jax0 = coordinator == "jax"
    r0 = (jfleet.SocketReducer if jax0 else SocketReducer)(0, 2, "127.0.0.1:0", token="good")
    done = {}
    t = threading.Thread(target=lambda: done.setdefault(
        "out", r0.allreduce([np.float32(1.0)])), daemon=True)
    t.start()
    try:
        bad = (SocketReducer if jax0 else jfleet.SocketReducer)(1, 2, r0.addr, token="bad",
                                                                  timeout=30.0)
        with pytest.raises(ConnectionError, match="refused hello"):
            bad.allreduce([np.float32(2.0)])
        bad.close()
        good = (SocketReducer if jax0 else jfleet.SocketReducer)(1, 2, r0.addr, token="good",
                                                                   timeout=30.0)
        assert float(good.allreduce([np.float32(2.0)])[0]) == 3.0
        good.close()
        t.join(timeout=30.0)
        assert float(done["out"][0]) == 3.0
    finally:
        r0.close()


def test_step_skew_is_refused():
    """A participant a step ahead: the coordinator raises the step-skew
    ``RuntimeError`` (the JAX participant's frames, the port's
    coordinator)."""
    r0 = SocketReducer(0, 2, "127.0.0.1:0", token="t")
    r1 = jfleet.SocketReducer(1, 2, r0.addr, token="t", timeout=5.0)
    r1._step = 5
    errs = []

    def participant():
        try:
            r1.allreduce([np.float32(1.0)])
        except (ConnectionError, OSError) as e:  # the coordinator hung up
            errs.append(e)

    t = threading.Thread(target=participant, daemon=True)
    t.start()
    try:
        with pytest.raises(RuntimeError, match="reduce step skew: rank 1 at 5"):
            r0.allreduce([np.float32(1.0)])
    finally:
        r0.close()
        t.join(timeout=30.0)
        r1.close()
    assert len(errs) == 1


# -- the pool summary ------------------------------------------------------------


def _pool_close(got, want):
    assert got["rows"] == want["rows"] and got["positives"] == want["positives"]
    np.testing.assert_allclose(got["feature_mean"], want["feature_mean"], rtol=1e-5)
    np.testing.assert_allclose(got["feature_std"], want["feature_std"], rtol=1e-4)
    np.testing.assert_allclose(got["label_rate"], want["label_rate"], rtol=1e-6)
    np.testing.assert_allclose(got["score_mean"], want["score_mean"], rtol=1e-5)


def test_fleet_pool_stats_two_hosts_match_one_and_jax():
    x, y, s = _data()
    single = fleet_pool_stats(x, y, s, LocalReducer(), device="cpu")
    jsingle = jfleet.fleet_pool_stats(x, y, s, jfleet.LocalReducer())
    _pool_close(single, jsingle)
    assert single["rows"] == 64 and single["hosts"] == 1

    def port(rank, red):
        h = _half(rank)
        return fleet_pool_stats(x[h], y[h], s[h], red, device="cpu")

    def jax(rank, red):
        h = _half(rank)
        return jfleet.fleet_pool_stats(x[h], y[h], s[h], red)

    st0, st1 = _two_rank(port)
    j0, _ = _two_rank(jax, jfleet.SocketReducer, jfleet.SocketReducer)
    assert st0["hosts"] == st1["hosts"] == j0["hosts"] == 2
    _pool_close(st0, single)
    _pool_close(st0, j0)
    # fleet replication: both hosts derive identical floats
    for key in ("feature_mean", "feature_std"):
        assert np.asarray(st0[key]).tobytes() == np.asarray(st1[key]).tobytes()
    assert (st0["label_rate"], st0["score_mean"]) == (st1["label_rate"], st1["score_mean"])


def test_an_empty_partition_contributes_zeros():
    """Rank 1 holds no rows: its zeros of shapes ``()`` ×3 and ``(d,)`` ×2
    leave rank 0's summary, on both ranks, as JAX's does."""
    x, y, s = _data()
    one = fleet_pool_stats(x, y, s, LocalReducer(), device="cpu")

    def fn(rank, red):
        if rank == 0:
            return fleet_pool_stats(x, y, s, red, device="cpu")
        return fleet_pool_stats(np.zeros((0, 5), np.float32), [], [], red, device="cpu")

    def jfn(rank, red):
        if rank == 0:
            return jfleet.fleet_pool_stats(x, y, s, red)
        return jfleet.fleet_pool_stats(np.zeros((0, 5), np.float32), [], [], red)

    st0, st1 = _two_rank(fn)
    j0, j1 = _two_rank(jfn, jfleet.SocketReducer, jfleet.SocketReducer)
    for st in (st0, st1):
        assert st["hosts"] == 2
        for key in ("rows", "positives", "label_rate", "score_mean"):
            assert st[key] == one[key]
        assert np.asarray(st["feature_mean"]).tobytes() == one["feature_mean"].tobytes()
    _pool_close(st1, j1)
    empty = fleet_pool_stats(np.zeros((0, 5), np.float32), [], [], LocalReducer(), device="cpu")
    assert empty["rows"] == 0 and empty["feature_mean"].shape == (5,)


# -- the fleet SGD fit -------------------------------------------------------------


def test_fleet_sgd_fit_replicates_bitwise_and_matches_jax():
    x, y = _sgd_data()

    def port(rank, red):
        h = _half(rank)
        p = fleet_sgd_fit(x[h], y[h], red, epochs=2, batch_size=16, seed=4, device="cpu")
        assert p.coef.device.type == "cpu" and p.coef.dtype == torch.float32
        return p.coef.numpy(), p.intercept.numpy()

    def jax(rank, red):
        h = _half(rank)
        p = jfleet.fleet_sgd_fit(x[h], y[h], red, epochs=2, batch_size=16, seed=4)
        return np.asarray(p.coef, np.float32), np.asarray(p.intercept, np.float32)

    (c0, b0), (c1, b1) = _two_rank(port)
    (jc, jb), _ = _two_rank(jax, jfleet.SocketReducer, jfleet.SocketReducer)
    # the fleet-replication contract: every host applies the identical
    # merged gradient bytes, so the weights can never diverge
    assert c0.tobytes() == c1.tobytes() and b0.tobytes() == b1.tobytes()
    assert np.abs(c0).max() > 0.1  # it learned
    np.testing.assert_allclose(c0, jc, rtol=0, atol=SGD_JAX_ATOL)
    np.testing.assert_allclose(b0, jb, rtol=0, atol=SGD_JAX_ATOL)


def test_fleet_sgd_fit_update_is_jax_s_given_the_same_merged_bytes():
    """The update runs in numpy float32 on the host: fed the same merged
    gradients (a reducer that returns fixed bytes), the port's and JAX's
    weights are the same bits."""
    x, y = _sgd_data()
    grads = np.random.default_rng(3).standard_normal((200, 7)).astype(np.float32)

    class Fixed(LocalReducer):
        def __init__(self):
            self.i = 0

        def allreduce(self, arrays):
            if len(arrays) == 1:  # the geometry reduce
                return [np.asarray(arrays[0], np.float32)]
            g = grads[self.i]
            self.i += 1
            return [g[:5].copy(), np.asarray(g[5], np.float32), np.asarray(16.0 + g[6] ** 2,
                                                                           np.float32)]

    p = fleet_sgd_fit(x, y, Fixed(), epochs=3, batch_size=16, seed=1, device="cpu")
    jp = jfleet.fleet_sgd_fit(x, y, Fixed(), epochs=3, batch_size=16, seed=1)
    assert p.coef.numpy().tobytes() == np.asarray(jp.coef, np.float32).tobytes()
    assert p.intercept.numpy().tobytes() == np.asarray(jp.intercept, np.float32).tobytes()


def test_fleet_sgd_fit_warm_start_and_empty_host():
    """A warm start seeds both ranks; a host with no rows takes empty
    batches and still applies the merged update (both ranks bitwise)."""
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams

    x, y = _sgd_data()
    warm = LogisticParams(torch.full((5,), 0.25), torch.tensor(-0.5))

    def fn(rank, red):
        xs, ys = (x, y) if rank == 0 else (np.zeros((0, 5), np.float32), np.zeros(0))
        p = fleet_sgd_fit(xs, ys, red, epochs=1, batch_size=16, warm_start=warm, device="cpu")
        return p.coef.numpy().tobytes(), p.intercept.numpy().tobytes()

    r0, r1 = _two_rank(fn)
    assert r0 == r1
    one = fleet_sgd_fit(x, y, LocalReducer(), epochs=0, warm_start=warm, device="cpu")
    assert one.coef.tolist() == [0.25] * 5 and float(one.intercept) == -0.5


# -- the mesh reducer --------------------------------------------------------------


def test_mesh_reducer_in_one_process_returns_the_partial():
    """One process: the partial back unchanged, one psum an array; JAX's
    single-process MeshReducer on its 8 virtual devices returns it within
    rounding, with n_hosts the device count."""
    from fraud_detection_tpu_torch.parallel import collectives

    a = [np.random.default_rng(5).standard_normal(7).astype(np.float32) * 3.0,
         np.float32(1.0 / 3.0)]
    red = MeshReducer(device="cpu")
    assert (red.n_hosts, red.rank) == (1, 0)
    collectives.reset_collective_counts()
    got = red.allreduce(a)
    assert collectives.collective_counts() == {("psum", "data"): 2}
    for g, w in zip(got, a):
        assert g.shape == np.shape(w) and g.tobytes() == np.asarray(w, np.float32).tobytes()
    jred = jfleet.MeshReducer()
    assert jred.n_hosts == 8
    for g, w in zip(got, jred.allreduce(a)):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_jax_mesh_reducer_across_processes_is_a_mean_the_port_gives_the_sum():
    """The deliberate deviation: JAX's ``MeshReducer`` puts each process's
    own partial, divided by the device count, on that process's devices
    (``fleet.py:166-171``). Two processes of 4 devices, laid out as they
    would hold it on the 8 virtual devices, psum to ``(a0 + a1) / 2``; the
    port's rank-order sum (its socket transport here, its mesh one in the
    gloo test below) gives ``a0 + a1``."""
    import jax.numpy as jnp

    a0 = np.asarray([2.0, -4.0, 8.0], np.float32)
    a1 = np.asarray([6.0, 4.0, 0.5], np.float32)
    per_device = np.concatenate([np.broadcast_to(a0 / 8, (4, 3)), np.broadcast_to(a1 / 8, (4, 3))])
    jred = jfleet.MeshReducer()
    merged = jfleet._fleet_grad_merge(jnp.asarray(per_device), jnp.zeros((8,), jnp.float32),
                                      mesh=jred.mesh)[0]
    np.testing.assert_allclose(np.asarray(merged), (a0 + a1) / 2, rtol=1e-6)

    def fn(rank, red):
        return red.allreduce([a0 if rank == 0 else a1])[0]

    out0, _ = _two_rank(fn)
    assert out0.tobytes() == (a0 + a1).tobytes()


def test_map_bodies_equal_jax_s():
    x, y, s = _data()
    v = np.ones(64, np.float32)
    got = fleet._host_partial_pool(*(torch.from_numpy(a) for a in (x, y, s, v)))
    want = jfleet._host_partial_pool(x, y, s, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    coef = np.linspace(-1, 1, 5).astype(np.float32)
    ypm = 2 * y - 1
    got = fleet._host_grad(torch.from_numpy(coef), torch.tensor(0.2), torch.from_numpy(x),
                           torch.from_numpy(ypm), torch.from_numpy(v))
    want = jfleet._host_grad(coef, np.float32(0.2), x, ypm, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


# -- two rank processes through shardfit -------------------------------------------

#: the committed CSV and model: both fleet fits at JAX's defaults (5 epochs of
#: 20,000 // (2 · 4096) = 2 steps)
FLEET_ARGS = ["--fit", "fleet_sgd", "--fit", "fleet_pool", "--data", "data/creditcard.csv",
              "--model-dir", "models"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args, env_extra, out, log):
    """A ``shardfit`` rank on the CPU, its output to the file ``log``."""
    env = dict(os.environ, DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **env_extra)
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        if var not in env_extra:
            env.pop(var, None)
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "fraud_detection_tpu_torch.shardfit", *FLEET_ARGS, *args,
             "--out", out], env=env, cwd=REPO, stdout=f, stderr=subprocess.STDOUT)


def _listening(proc, log) -> str | None:
    """Rank 0's address once ``log`` holds its whole ``FLEET_LISTENING``
    line; None when it exits first or ``CHILD_TIMEOUT_S`` passes."""
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while True:
        done = proc.poll() is not None
        with open(log) as f:
            for line in f:
                if line.startswith("FLEET_LISTENING") and line.endswith("\n"):
                    return line.split()[1]
        if done or time.monotonic() > deadline:
            return None
        time.sleep(0.05)


def _finish(procs, logs) -> list[tuple[int, str]]:
    try:
        for p in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        # a hang in one rank must not leak children or hide the other's output
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _summary(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_two_rank_processes_socket_and_mesh_give_the_same_bytes(tmp_path):
    """``shardfit --fit fleet_sgd --fit fleet_pool`` as two rank processes,
    through ``--reducer socket`` (rank 0 started first, its address handed
    on) and through ``--reducer mesh`` (two gloo ranks): every array the
    same bytes on all four, the mesh ranks' psums 1 + 3 a step + 5."""
    sock = str(tmp_path / "socket")
    logs = [tmp_path / f"socket{r}.out" for r in range(2)]
    p0 = _spawn(["--reducer", "socket", "--rank", "0", "--hosts", "2"], {}, sock, logs[0])
    addr = _listening(p0, logs[0])
    p1 = _spawn(["--reducer", "socket", "--rank", "1", "--hosts", "2",
                 "--coordinator", addr or "127.0.0.1:1"], {}, sock, logs[1])
    socket_runs = _finish([p0, p1], logs)
    assert addr, socket_runs[0][1]
    port = str(_free_port())
    logs = [tmp_path / f"mesh{r}.out" for r in range(2)]
    mesh_runs = _finish([
        _spawn(["--reducer", "mesh"], {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                                       "WORLD_SIZE": "2", "RANK": str(r)},
               str(tmp_path / "mesh"), logs[r]) for r in range(2)], logs)
    steps = 5 * (20000 // (2 * 4096))
    for kind, runs in (("socket", socket_runs), ("mesh", mesh_runs)):
        for rank, (rc, text) in enumerate(runs):
            assert rc == 0, f"{kind} rank {rank} failed:\n{text}"
            s = _summary(text)
            assert (s["rank"], s["world"]) == (rank, 2)
            assert s["fleet"]["fleet_sgd"]["merges"] == 1 + steps
            assert s["collectives"] == ({"psum@data": 1 + 3 * steps + 5} if kind == "mesh"
                                        else {})
            assert s["backend"] == ("gloo" if kind == "mesh" else None)
    ref = np.load(tmp_path / "socket" / "rank0.npz")
    assert int(ref["fleet_pool_rows"]) == 20000 and np.abs(ref["fleet_sgd_coef"]).max() > 0
    for kind in ("socket", "mesh"):
        for rank in range(2):
            got = np.load(tmp_path / kind / f"rank{rank}.npz")
            assert sorted(got.files) == sorted(ref.files)
            for key in ref.files:
                assert got[key].tobytes() == ref[key].tobytes(), (kind, rank, key)
