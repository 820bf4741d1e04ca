"""Cross-host reduce: per-host partial pools, one merge.

The port's counterpart of the JAX package's ``longhaul/fleet.py``: the
MapReduce idiom (2403.07128) lifted from the shard axis to the host fleet.
Every host computes its partials with a LOCAL body on its serving device
(no collective: the map side), and exactly one merge combines them. Three
transports stand behind ``allreduce(arrays) -> arrays``:

- :class:`LocalReducer` — a fleet of one: the merge of one partial is the
  partial, byte for byte.
- :class:`MeshReducer` — the ``torch.distributed`` path: each array is
  this process's one-shard partial on a data axis of one shard a process
  (:func:`~fraud_detection_tpu_torch.parallel.mesh.global_mesh`), and one
  ``psum`` an array folds the processes' partials in rank order on the
  serving device (under ``nccl`` the partials stay on the card; ranks
  sharing a card use ``gloo`` through the host). In one process it returns
  the partial unchanged.
- :class:`SocketReducer` — where no process group is up: hosts ship their
  partial arrays over the framed wire (``service/wire``, the arrays packed
  as ``longhaul/codec`` packs them, byte for byte JAX's) to the rank-0
  coordinator, which sums **in rank order** (one fixed float association)
  and broadcasts the result bytes.

Both fleet transports give every host ``((p0 + p1) + p2) + …`` in float32,
so their results are the same bits, and fleet-replicated state (the SGD
weights) can never diverge. The JAX package's ``MeshReducer`` differs
here: it broadcasts a process's own partial over its devices and divides
by the device count, so across processes its psum is a mean over
processes, not the sum its docstring and ``fleet_pool_stats``'s ``rows``
need; the port gives the sum.

:func:`fleet_pool_stats` and :func:`fleet_sgd_fit` are the host-level
twins of ``mesh/retrain.mapreduce_pool_stats`` / ``mesh_sgd_fit``: same
summary keys, same objective scaling, data distributed per host instead of
per shard. Their collective budgets (``analysis/contracts``): the map
bodies none, the pool merge 5 ``psum`` a call, the gradient merge 3 a step
(coef block, intercept, batch count) and the geometry reduce 1 a fit.
"""

from __future__ import annotations

import socket
import threading

import numpy as np
import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.longhaul import codec
from fraud_detection_tpu_torch.service.wire import (
    attach_auth,
    check_auth,
    parse_hostport,
    recv_frame,
    send_frame,
)


# -- map side: local bodies on the serving device (no collective) ------------

def _host_partial_pool(x, y, s, v):
    """This host's pool partials — the map half of the fleet pool merge:
    ``mesh/retrain.mapreduce_pool_stats``'s five sums without the psum."""
    n = v.sum()
    n_pos = (v * y).sum()
    s_sum = (v * s).sum()
    fx = v @ x
    fx2 = v @ (x * x)
    return n, n_pos, s_sum, fx, fx2


def _host_grad(coef, intercept, x, y_pm, sw):
    """This host's UN-normalized data-term gradient sums for one minibatch
    (sklearn primal: d/dz Σ sw·softplus(−y·z) = −y·σ(−y·z)·sw). The
    1/n_total scaling, L2 term, and momentum update run on the host after
    the merge so every host applies the identical reduced floats."""
    z = x @ coef + intercept
    m = torch.sigmoid(-y_pm * z) * sw * (-y_pm)
    return m @ x, m.sum()


# -- the one interface -----------------------------------------------------

class LocalReducer:
    """Degenerate single-host transport: the merge of one partial is the
    partial."""

    n_hosts = 1
    rank = 0

    def allreduce(self, arrays):
        return [np.asarray(a, np.float32) for a in arrays]

    def close(self) -> None:
        pass


class MeshReducer:
    """The ``torch.distributed`` path: one ``psum`` an array over a data
    axis of one shard a process, on the serving device (``device``, else
    ``DEVICE``). ``n_hosts`` is the process count, ``rank`` this process's
    index; without a process group it is a fleet of one and returns each
    partial unchanged."""

    def __init__(self, device=None):
        from fraud_detection_tpu_torch.parallel.mesh import MeshSpec, global_mesh, process_count

        self.mesh = global_mesh(MeshSpec(data=process_count()), device)
        self.n_hosts = self.mesh.processes
        self.rank = self.mesh.process

    @staticmethod
    def available() -> bool:
        from fraud_detection_tpu_torch.parallel.mesh import process_count

        return process_count() > 1

    def allreduce(self, arrays):
        """Each array as this process's ``(1, *shape)`` partial, one
        ``psum`` (folded in global shard order: rank order), float32
        numpy back."""
        from fraud_detection_tpu_torch.parallel.collectives import psum

        out = []
        for a in arrays:
            a = np.array(a, np.float32)  # a contiguous copy; a 0-d partial stays 0-d
            part = torch.from_numpy(a).to(self.mesh.device).reshape(1, *a.shape)
            out.append(psum(part, self.mesh).cpu().numpy().reshape(a.shape))
        return out

    def close(self) -> None:
        pass


class SocketReducer:
    """Rank-order deterministic socket allreduce. Rank 0 coordinates:
    collects one partial per rank per step, sums rank 0 → N−1 (a fixed
    float association), broadcasts the result bytes. Synchronous
    lockstep — exactly the cadence of an SGD loop.

    Rank 0 binds in ``__init__`` and accepts its peers inside its first
    :meth:`allreduce`; a rank > 0 connects on its first :meth:`allreduce`,
    once, without a retry — a launcher starting ranks as processes starts
    rank 0 first and waits for it to listen."""

    def __init__(
        self,
        rank: int,
        n_hosts: int,
        addr: str,
        token: str | None = None,
        timeout: float = 60.0,
    ):
        self.rank = int(rank)
        self.n_hosts = int(n_hosts)
        self.token = token if token is not None else config.store_token()
        self.timeout = timeout
        self._host, self._port = parse_hostport(addr, 7500)
        self._step = 0
        self._lock = threading.Lock()
        if self.rank == 0:
            # the coordinator's listener blocks in accept by design (lockstep
            # reduce); close() unblocks it
            # lockcheck: ignore[socket-no-timeout] (the reason above)
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((self._host, self._port))
            self._listener.listen(self.n_hosts)
            self.addr = "%s:%d" % self._listener.getsockname()[:2]
            self._peers: dict[int, socket.socket] = {}
        else:
            self._listener = None
            self.addr = f"{self._host}:{self._port}"
            self._conn: socket.socket | None = None

    # -- rank 0 ------------------------------------------------------------
    def _accept_peers(self) -> None:
        while len(self._peers) < self.n_hosts - 1:
            conn, _ = self._listener.accept()
            conn.settimeout(self.timeout)
            hello = recv_frame(conn)
            if self.token and not check_auth(hello, self.token):
                send_frame(conn, {"ok": False, "error": "unauthorized"})
                conn.close()
                continue
            peer_rank = int(hello["args"]["rank"])
            self._peers[peer_rank] = conn
            send_frame(conn, {"ok": True, "result": {"rank": peer_rank}})

    def _coordinate(self, arrays):
        if len(self._peers) < self.n_hosts - 1:
            self._accept_peers()
        partials = {0: [np.asarray(a, np.float32) for a in arrays]}
        for rank, conn in self._peers.items():
            msg = recv_frame(conn)
            step = int(msg["step"])
            if step != self._step:
                raise RuntimeError(
                    f"reduce step skew: rank {rank} at {step}, "
                    f"coordinator at {self._step}"
                )
            partials[rank] = [codec.unpack_array(d) for d in msg["arrays"]]
        # rank-order sum: ONE float association, every host gets the same
        # bytes
        totals = [a.copy() for a in partials[0]]
        for rank in range(1, self.n_hosts):
            for i, a in enumerate(partials[rank]):
                totals[i] = totals[i] + a.astype(np.float32)
        packed = [codec.pack_array(t) for t in totals]
        for conn in self._peers.values():
            send_frame(conn, {"step": self._step, "arrays": packed})
        return totals

    # -- rank > 0 ----------------------------------------------------------
    def _participant(self, arrays):
        if self._conn is None:
            self._conn = socket.create_connection((self._host, self._port),
                                                  timeout=self.timeout)
            self._conn.settimeout(self.timeout)
            hello = {"op": "hello", "args": {"rank": self.rank}}
            if self.token:
                hello = attach_auth(hello, self.token)
            send_frame(self._conn, hello)
            ack = recv_frame(self._conn)
            if ack is None or not ack.get("ok"):
                raise ConnectionError("reduce coordinator refused hello")
        send_frame(self._conn, {
            "step": self._step,
            "arrays": [codec.pack_array(np.asarray(a, np.float32)) for a in arrays],
        })
        msg = recv_frame(self._conn)
        if msg is None:
            raise ConnectionError("reduce coordinator went away")
        return [codec.unpack_array(d) for d in msg["arrays"]]

    def allreduce(self, arrays):
        with self._lock:
            out = self._coordinate(arrays) if self.rank == 0 else self._participant(arrays)
            self._step += 1
            return out

    def close(self) -> None:
        socks = (list(self._peers.values()) + [self._listener] if self.rank == 0
                 else [self._conn] if self._conn is not None else [])
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


def make_reducer(
    rank: int = 0,
    n_hosts: int = 1,
    addr: str | None = None,
    token: str | None = None,
    device=None,
):
    """One interface, three transports: a no-op for a fleet of one, the
    mesh psum where a process group is up (on ``device``), the socket
    allreduce where it is not."""
    if n_hosts <= 1:
        return LocalReducer()
    if MeshReducer.available():
        return MeshReducer(device)
    if addr is None:
        raise ValueError("SocketReducer needs the coordinator addr")
    return SocketReducer(rank, n_hosts, addr, token=token)


# -- host-level MapReduce entrants -----------------------------------------

def fleet_pool_stats(x, y, scores, reducer, device=None) -> dict:
    """Host-level twin of ``mesh/retrain.mapreduce_pool_stats``: every host
    maps its OWN labeled pool through the local body on ``device`` (``cuda``
    unless the caller asks for the CPU), the fleet merges once, and the
    summary finishes in float64 on the host. Same summary keys, plus
    ``hosts``."""
    x_np = np.asarray(x, np.float32)
    if x_np.ndim == 1:
        x_np = x_np[None, :]
    n, d = x_np.shape
    if n:
        dev = resolve_device(device)

        def put(a):
            return torch.from_numpy(np.array(a, np.float32)).to(dev)

        parts = _host_partial_pool(put(x_np), put(np.asarray(y, np.float32).reshape(-1)),
                                   put(np.asarray(scores, np.float32).reshape(-1)),
                                   put(np.ones((n,), np.float32)))
        parts = [p.cpu().numpy() for p in parts]
    else:
        parts = [np.zeros((), np.float32)] * 3 + [np.zeros((d,), np.float32)] * 2
    cnt, n_pos, s_sum, fx, fx2 = reducer.allreduce(parts)
    cnt_f = max(float(cnt), 1.0)
    mean = np.asarray(fx, np.float64) / cnt_f
    var = np.maximum(np.asarray(fx2, np.float64) / cnt_f - mean**2, 0.0)
    return {
        "rows": int(round(float(cnt))),
        "positives": int(round(float(n_pos))),
        "label_rate": float(n_pos) / cnt_f,
        "score_mean": float(s_sum) / cnt_f,
        "feature_mean": mean,
        "feature_std": np.sqrt(var),
        "hosts": reducer.n_hosts,
    }


def fleet_sgd_fit(
    x,
    y,
    reducer,
    c: float = 1.0,
    epochs: int = 5,
    batch_size: int = 4096,
    lr: float = 0.3,
    momentum: float = 0.9,
    sample_weight=None,
    seed: int = 0,
    warm_start=None,
    device=None,
):
    """Host-level data-parallel minibatch SGD: each host holds ITS data
    partition, computes local gradient sums with the map body on ``device``
    (``cuda`` unless the caller asks for the CPU), and applies the
    IDENTICAL update after one fleet merge per step — the 2004.13336
    contract with the fleet as the data axis. Every host must call with the
    same hyperparameters and seed; the permutation is seeded per host
    (rank-salted) so partitions shuffle independently while the weights
    stay fleet-replicated. The update runs in numpy float32 on the host, as
    the JAX package's does, so given the same merged gradient bytes every
    host — and the JAX package — applies the same floats. Returns
    ``ops/logistic.LogisticParams`` on ``device``."""
    from fraud_detection_tpu_torch.ops.logistic import LogisticParams

    dev = resolve_device(device)
    x_np = np.asarray(x, np.float32)
    y_np = np.asarray(y)
    n, d = x_np.shape
    sw = (np.asarray(sample_weight, np.float32) if sample_weight is not None
          else np.ones((n,), np.float32))
    y_pm = np.where(y_np > 0, 1.0, -1.0).astype(np.float32)

    # fleet geometry first: the step count derives from n_total, which
    # every host learns from the same reduce — lockstep by construction
    geom = reducer.allreduce([np.asarray([n], np.float32)])[0]
    n_total = int(round(float(geom[0])))
    steps = max(1, n_total // (reducer.n_hosts * max(batch_size, 1)))

    coef = np.zeros((d,), np.float32)
    b = np.float32(0.0)
    if warm_start is not None:
        coef[:] = torch.as_tensor(warm_start.coef).detach().cpu().numpy().astype(np.float32)
        b = np.float32(torch.as_tensor(warm_start.intercept).detach().cpu().item())
    vel = np.zeros((d,), np.float32)
    vel_b = np.float32(0.0)

    def put(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    rng = np.random.default_rng(seed * 1000 + reducer.rank)
    for e in range(epochs):
        lr_e = np.float32(lr * 0.5 * (1.0 + np.cos(np.pi * e / max(epochs, 1))))
        perm = rng.permutation(n)
        for s in range(steps):
            # wraparound slice keeps every host in lockstep even when
            # partitions are ragged
            start = (s * batch_size) % max(n, 1)
            idx = np.take(
                perm, np.arange(start, start + batch_size) % max(n, 1)
            ) if n else np.zeros((0,), np.int64)
            g_coef, g_b = _host_grad(put(coef), put(b), put(x_np[idx]), put(y_pm[idx]),
                                     put(sw[idx]))
            g_coef, g_b, bc = reducer.allreduce(
                [g_coef.cpu().numpy(), g_b.cpu().numpy(),
                 np.asarray(float(idx.size), np.float32)]
            )
            # mesh_sgd_fit's objective: c/|global batch| on the data term,
            # 1/n_total on the L2
            scale = np.float32(c) / np.float32(max(float(bc), 1.0))
            g_w = scale * g_coef + coef / np.float32(max(n_total, 1))
            g_bi = scale * g_b
            vel = momentum * vel - lr_e * g_w
            vel_b = np.float32(momentum * vel_b - lr_e * g_bi)
            coef = coef + vel
            b = np.float32(b + vel_b)
    return LogisticParams(coef=torch.from_numpy(np.asarray(coef, np.float32)).to(dev),
                          intercept=torch.tensor(b, dtype=torch.float32, device=dev))
