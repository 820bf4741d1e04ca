"""Shard-axis layouts: row padding and the segments of a staged batch.

The JAX package's ``NamedSharding``s place rows on devices. On the port's
one-device grid (:mod:`.mesh`) a layout says how a tensor's leading axis
splits over the shards instead: :func:`batch_sharding` into ``mesh.size``
equal row segments (segment ``s`` is shard ``s``'s rows, ``[s·b/N,
(s+1)·b/N)``), :func:`data_sharding` into ``mesh.data`` segments each
replicated over the model axis (the wide program's rows), :func:`replicated`
not at all (every shard reads the whole tensor). :func:`split_segments`
checks every split (a count that does not divide the rows raises, naming
the shape and the count); :func:`pad_to_multiple` and :func:`shard_batch`
resolve the even row count a split needs on the host first, as in JAX. Inside a process
group every process is given the same rows and keeps its own shards'
segments (:func:`shard_batch`), as JAX's ``device_put`` of one global
array onto a mesh spanning every process does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fraud_detection_tpu_torch.parallel.mesh import Mesh, default_mesh


@dataclass(frozen=True)
class ShardLayout:
    """How a tensor's leading axis lies over a mesh's shards: ``split``
    into ``mesh.size`` equal segments (``over_model=False``: into
    ``mesh.data`` segments, each replicated over the model axis), or
    replicated."""

    mesh: Mesh
    split: bool
    over_model: bool = True

    @property
    def parts(self) -> int:
        """The segments a split tensor has: the flattened grid, or the data
        axis alone."""
        return self.mesh.size if self.over_model else self.mesh.data

    def segments(self, t: torch.Tensor) -> torch.Tensor:
        """A split tensor as ``(shards, rows a shard, ...)`` (a view, checked
        by :func:`split_segments`); a replicated one as it is."""
        if not self.split:
            return t
        return split_segments(t, self.parts)


def split_segments(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t``'s leading axis as ``n`` equal segments, ``(n, rows a segment,
    ...)`` (a view): every split of rows over shards goes through here. A
    count ``n`` does not divide raises ``ValueError`` naming the shape and
    the count, as JAX's ``meshcheck`` pre-check of a ``NamedSharding``
    does, before any row is dropped or misplaced."""
    if t.shape[0] % n:
        raise ValueError(
            f"dimension 0 of shape {tuple(t.shape)} not divisible by {n} shards: "
            f"{t.shape[0]} rows do not split over {n} shards; pad them first"
        )
    return t.view(n, t.shape[0] // n, *t.shape[1:])


def batch_sharding(mesh: Mesh | None = None) -> ShardLayout:
    """Rows split over the flattened grid, features whole."""
    return ShardLayout(mesh or default_mesh(), split=True)


def data_sharding(mesh: Mesh | None = None) -> ShardLayout:
    """Rows split over the data axis only, replicated over the model axis
    (JAX's ``P(DATA_AXIS)`` on a 2-D mesh: the wide program's rows, which
    every model shard of a data shard reads whole)."""
    return ShardLayout(mesh or default_mesh(), split=True, over_model=False)


def replicated(mesh: Mesh | None = None) -> ShardLayout:
    return ShardLayout(mesh or default_mesh(), split=False)


def pad_to_multiple(x, multiple: int, axis: int = 0, value: float = 0.0):
    """Pad ``x`` (a numpy array or a tensor) along ``axis`` to a multiple of
    ``multiple``. Returns ``(padded, n_valid)``; callers mask the padded
    rows out of reductions with ``n_valid``."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        pad = [0, 0] * (x.dim() - 1 - axis) + [0, rem]
        return torch.nn.functional.pad(x, pad, value=value), n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, constant_values=value), n


def shard_batch(x, mesh: Mesh | None = None, value: float = 0.0,
                over_model: bool = True):
    """Pad rows to a multiple of the grid's global size (every process's
    shards) and place this process's part on the mesh's device, split into
    its shards' segments (:func:`batch_sharding`): rows ``[o·b, (o + p)·b)``
    of the padded rows, ``b`` rows a shard, ``p`` the process's segments
    and ``o`` its first segment's global index. ``over_model=False`` splits
    over the data axis only (:func:`data_sharding`). Returns ``(tensor,
    n_valid)``, ``n_valid`` the global count of real rows."""
    mesh = mesh or default_mesh()
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    parts = ShardLayout(mesh, True, over_model).parts
    shards = parts * mesh.processes
    padded, n_valid = pad_to_multiple(x, shards, axis=0, value=value)
    if mesh.processes > 1:
        b = padded.shape[0] // shards
        first = mesh.process * parts * b
        padded = padded[first:first + parts * b]
    return padded.to(mesh.device).contiguous(), n_valid
