"""Collectives over the data axis: the JAX package's ``parallel/
collectives.py`` (``psum_data``, ``pmean_data``, ``all_gather_data``,
``data_parallel``) with ``psum_scatter`` and ``pmax`` beside them, and the
model axis's (:func:`psum_model`, :func:`all_gather_blocks`,
:func:`psum_scatter_blocks`).

Inside ``shard_map`` a JAX collective reduces one value a device. Here a
process holds its shards' values stacked on a leading *local shard axis*
— ``(mesh.data, ...)``, shard ``s`` at index ``s`` — and a collective
reduces them over every process's shards (:mod:`.mesh`: global shard
``rank·data + s``). :func:`data_parallel` maps a function over that axis.

Order. A float :func:`psum` folds the global shards' partials left to
right in global shard order — ``((p0 + p1) + p2) + …`` — after gathering
them (``all_gather``; the backend's own reduction, whose order is its own,
never touches a float). So one process with 8 shards and two with 4 each
give the same bits, and a one-shard ``psum`` returns its partial unchanged:
a sharded fit over one shard is bitwise the unsharded fit. Integer sums
and maxima are exact in any order, and reduce locally, then across
processes with the backend's ``SUM`` / ``MAX``.

Gradients. :func:`psum` and :func:`replicate` are each other's transpose,
as ``psum`` and its broadcast are in JAX: the gradient of a ``psum`` reaches
every local partial unchanged, and the gradient of a replicated tensor is
the ``psum`` (the same fold) of its shards' gradients, so autograd through
per-shard partials gives every process the gradient of the global sum.

The model axis. A wide program's state is a local ``(data, model, ...)``
grid (the second axis the mesh's ``model``), and the model axis lies
inside a process: ranks split the data axis only. :func:`psum_model`
folds over it in model order with no backend; :func:`all_gather_blocks`
and :func:`psum_scatter_blocks` are the data-axis collectives inside each
model group. At a model axis of 1 each is its data-axis counterpart's
bits.

Across processes the backend is ``nccl`` (a card a rank: the tensors stay
on the card) or ``gloo`` (the CPU, or ranks sharing a card: the partials
go through the host), :func:`.mesh.choose_backend`.

Counts. Every public collective adds one to a module-level count keyed by
``(kind, axis)`` where it is entered — ``psum``/``pmean`` as ``("psum",
"data")``, ``all_gather``/``all_gather_blocks`` as ``("all_gather",
"data")``, ``psum_scatter``/``psum_scatter_blocks`` as ``("psum_scatter",
"data")``, ``pmax`` as ``("pmax", "data")``, ``psum_model`` as ``("psum",
"model")`` — once, whatever it calls inside, and at one shard too: the
count is the program's, not the backend's. :func:`reset_collective_counts`
and :func:`collective_counts` zero and read them, as ``ops/kernels`` does
its launch counts; ``analysis/contracts`` holds programs to budgets of
them.
"""

from __future__ import annotations

import threading

import torch

from fraud_detection_tpu_torch.parallel.mesh import Mesh, backend, default_mesh


_count_lock = threading.Lock()
#: collective calls since the last reset, by ``(kind, axis)``
COLLECTIVE_CALLS: dict[tuple[str, str], int] = {}


def _count(kind: str, axis: str = "data") -> None:
    with _count_lock:
        COLLECTIVE_CALLS[kind, axis] = COLLECTIVE_CALLS.get((kind, axis), 0) + 1


def reset_collective_counts() -> None:
    with _count_lock:
        COLLECTIVE_CALLS.clear()


def collective_counts() -> dict[tuple[str, str], int]:
    """The calls since the last :func:`reset_collective_counts`, by ``(kind,
    axis)`` (a kind never called is absent)."""
    with _count_lock:
        return dict(COLLECTIVE_CALLS)


def _mesh(mesh: Mesh | None) -> Mesh:
    return mesh if mesh is not None else default_mesh()


def _check(parts: torch.Tensor, mesh: Mesh) -> None:
    if parts.dim() < 1 or parts.shape[0] != mesh.data:
        raise ValueError(
            f"a collective over {mesh.data} local shards wants a leading shard "
            f"axis of {mesh.data}, got shape {tuple(parts.shape)}"
        )


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend moves it: on the card under ``nccl``, through
    the host under ``gloo``."""
    t = t.contiguous()
    return t.cpu() if backend() == "gloo" and t.device.type != "cpu" else t


def _gather(parts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(mesh.data, ...)`` → ``(mesh.global_data, ...)``: every process's
    local shard axis, in global shard order."""
    if mesh.processes == 1:
        return parts
    import torch.distributed as dist

    x = _wire(parts)
    bufs = [torch.empty_like(x) for _ in range(mesh.processes)]
    dist.all_gather(bufs, x)
    return torch.cat(bufs).to(parts.device)


def _reduce(t: torch.Tensor, mesh: Mesh, op: str) -> torch.Tensor:
    """An exact reduction (integer ``sum``, ``max``) across processes."""
    if mesh.processes == 1:
        return t
    import torch.distributed as dist

    x = _wire(t).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
    return x.to(t.device)


def _fold(parts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    g = _gather(parts, mesh)
    if g.shape[0] == 1:
        return g[0].clone()
    out = g[0] + g[1]
    for i in range(2, g.shape[0]):
        out = out + g[i]
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, parts, mesh):
        ctx.shape = parts.shape
        return _fold(parts.detach(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.unsqueeze(0).expand(ctx.shape), None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.detach().unsqueeze(0).expand(mesh.data, *t.shape).clone()

    @staticmethod
    def backward(ctx, grad):
        return _fold(grad, ctx.mesh), None


def psum(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over every shard of the data axis: ``parts`` ``(mesh.data,
    ...)`` → ``(...)``, the same on every process. Floats fold in global
    shard order (differentiable: the gradient reaches every local partial);
    integers and booleans sum exactly in any order."""
    _count("psum")
    return _psum(parts, _mesh(mesh))


def _psum(parts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:func:`psum` uncounted: the reduction inside another collective."""
    _check(parts, mesh)
    if not (parts.is_floating_point() or parts.is_complex()):
        if mesh.global_data == 1:
            return parts[0]
        return _reduce(parts.sum(0), mesh, "sum")
    if parts.requires_grad and torch.is_grad_enabled():
        return _Psum.apply(parts, mesh)
    return _fold(parts, mesh)


def pmean(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """:func:`psum` over the global shard count."""
    _count("psum")
    mesh = _mesh(mesh)
    return _psum(parts, mesh) / mesh.global_data


def pmax(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Maximum over every shard of the data axis, exact in any order."""
    _count("pmax")
    mesh = _mesh(mesh)
    _check(parts, mesh)
    if mesh.global_data == 1:
        return parts[0]
    return _reduce(parts.amax(0), mesh, "max")


def all_gather(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Every shard's piece, in global shard order: ``(mesh.data, ...)`` →
    ``(mesh.global_data, ...)``. ``.reshape(-1)`` of a ``(data, k)`` result
    is JAX's tiled ``all_gather`` of ``k`` elements a shard."""
    _count("all_gather")
    mesh = _mesh(mesh)
    _check(parts, mesh)
    return _gather(parts, mesh)


def psum_scatter(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Reduce and scatter in one: ``parts`` ``(mesh.data, m, ...)`` (every
    shard's full-length partial, ``m`` a multiple of the global shard
    count) → ``(mesh.data, m / global_data, ...)``, each local shard's
    slice of the :func:`psum` (global shard ``g`` owns slice ``g``) — JAX's
    tiled ``psum_scatter`` over ``scatter_dimension=0``, with the fold's
    bits."""
    _count("psum_scatter")
    mesh = _mesh(mesh)
    _check(parts, mesh)
    m = parts.shape[1]
    if m % mesh.global_data:
        raise ValueError(f"psum_scatter: {m} does not split over {mesh.global_data} shards")
    total = _psum(parts, mesh)
    k = m // mesh.global_data
    own = total.reshape(mesh.global_data, k, *total.shape[1:])
    return own[mesh.shard_offset:mesh.shard_offset + mesh.data]


def replicate(t: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """``t`` once a local shard, ``(mesh.data, *t.shape)``: the shards'
    copies of a replicated value. Its gradient is the :func:`psum` of the
    copies' gradients, folded in global shard order on every process."""
    mesh = _mesh(mesh)
    if t.requires_grad and torch.is_grad_enabled():
        return _Replicate.apply(t, mesh)
    return t.unsqueeze(0).expand(mesh.data, *t.shape)


def _check_grid(parts: torch.Tensor, mesh: Mesh | None) -> None:
    if parts.dim() < 2 or (
            mesh is not None and tuple(parts.shape[:2]) != (mesh.data, mesh.model)):
        raise ValueError(
            f"a model-axis collective over a {mesh.data}x{mesh.model} local grid "
            f"wants leading axes ({mesh.data}, {mesh.model}), got shape "
            f"{tuple(parts.shape)}"
        )


def psum_model(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over the model axis: ``parts`` ``(mesh.data, mesh.model, ...)``
    → ``(mesh.data, ...)``, folded left to right in model order (``((m0 +
    m1) + m2) + …``). A process holds its whole model axis, so nothing
    crosses processes, and without ``mesh`` the grid's own leading axes
    are taken as they are; at a model axis of 1 the partial comes back
    unchanged."""
    _count("psum", "model")
    _check_grid(parts, mesh)
    out = parts[:, 0]
    for m in range(1, parts.shape[1]):
        out = out + parts[:, m]
    return out


def all_gather_blocks(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Each model group's column block: ``parts`` ``(mesh.data, mesh.model,
    k)`` (shard ``(d, m)``'s ``k`` columns) → ``(mesh.model,
    mesh.global_data·k)``, row ``m`` the group's data shards' pieces in
    global shard order — JAX's tiled ``all_gather`` over the data axis
    inside a model group. At a model axis of 1, :func:`all_gather` of the
    pieces, flattened."""
    _count("all_gather")
    mesh = _mesh(mesh)
    _check_grid(parts, mesh)
    g = _gather(parts, mesh)  # (global_data, model, k)
    return g.transpose(0, 1).reshape(mesh.model, -1)


def psum_scatter_blocks(parts: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """:func:`psum_scatter` inside each model group: ``parts`` ``(mesh.data,
    mesh.model, n, ...)`` (every shard's partial over its group's ``n``
    columns, ``n`` a multiple of the global data count) → ``(mesh.data,
    mesh.model, n / global_data, ...)``: the group's partials reduced over
    the data axis in global shard order, data shard ``g`` receiving slice
    ``g`` of its group's block. No model-axis collective: a group's columns
    take gradient only from its own partials."""
    _count("psum_scatter")
    mesh = _mesh(mesh)
    _check_grid(parts, mesh)
    n = parts.shape[2]
    if n % mesh.global_data:
        raise ValueError(f"psum_scatter_blocks: {n} does not split over "
                         f"{mesh.global_data} data shards")
    total = _psum(parts, mesh)  # (model, n, ...)
    k = n // mesh.global_data
    own = total.reshape(mesh.model, mesh.global_data, k, *total.shape[2:])
    return own[:, mesh.shard_offset:mesh.shard_offset + mesh.data].transpose(0, 1)


# the JAX package's names
psum_data = psum
pmean_data = pmean
all_gather_data = all_gather


def data_parallel(fn, mesh: Mesh | None = None):
    """``fn(*shard_args) -> tensor`` mapped over the local shard axis: the
    returned function takes arguments with a leading ``(mesh.data, ...)``
    axis (``ShardLayout.segments`` of row-split tensors; ``None`` or a
    non-tensor passes through to every shard) and stacks ``fn``'s results
    on that axis, one call a shard. ``fn`` reduces over the data axis
    itself, with these collectives, where it must — as under JAX's
    ``shard_map``."""
    def mapped(*args):
        m = _mesh(mesh)
        outs = [fn(*(a[s] if isinstance(a, torch.Tensor) else a for a in args))
                for s in range(m.data)]
        return torch.stack(outs)

    return mapped
