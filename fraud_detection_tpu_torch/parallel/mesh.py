"""The shard grid: the port's counterpart of the JAX package's device mesh.

The JAX package lays a ``(data, model)`` mesh over devices (on the CPU,
the virtual host devices that ``--xla_force_host_platform_device_count``
makes). PyTorch has no virtual devices, and NCCL does not put two ranks on
one card, so here a :class:`Mesh` is a ``(data, model)`` grid of *shards
that all live on one device*: the serving device, ``cuda:0`` on the card
or the CPU when the caller asks for it. A shard owns a slice of a leading
shard axis — its drift window, its ledger sub-table, its segment of a
staged bucket (``parallel/sharding``). The axis names are the JAX
package's, so the serving mesh's shapes read the same in both.

:func:`create_mesh` takes a device list that repeats one device; a list
naming two distinct devices raises ``NotImplementedError`` (a shard a card
waits for a machine with several cards, ROADMAP item 12b). Collectives and
``initialize_distributed`` are item 12b too: a grid on one device needs
none.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fraud_detection_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshSpec:
    """Static description of a mesh shape."""

    data: int
    model: int = 1

    @property
    def size(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of shards on one device. ``shape`` maps the
    axis names to their sizes, as a JAX mesh's does; ``size`` is the
    flattened grid, the length of every shard axis."""

    device: torch.device
    data: int
    model: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


def device_count(device: str | torch.device | None = None) -> int:
    """Physical devices of the serving device's kind: the cards on a CUDA
    machine, 1 for the CPU. The shards of a mesh are not bounded by it."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def create_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """A ``(data, model)`` grid over ``devices``: one entry a shard, every
    entry the same device (default: the serving device, once a shard of
    ``spec``; ``spec`` None puts every given device on the data axis, as
    JAX does). ``spec.data == 0`` takes the data axis from the list's
    length, as in JAX."""
    if devices is None:
        n = spec.size if spec is not None and spec.data > 0 else 1
        devices = [resolve_device()] * n
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device entry")
    distinct = set(devices)
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a mesh over {len(distinct)} distinct devices ({sorted(map(str, distinct))}): "
            "every shard of the port's mesh lives on one device; a shard a "
            "card is ROADMAP item 12b"
        )
    n = len(devices)
    if spec is None:
        spec = MeshSpec(data=n, model=1)
    if spec.data == 0:
        spec = MeshSpec(data=n // spec.model, model=spec.model)
    if spec.size != n:
        raise ValueError(f"mesh spec {spec} needs {spec.size} devices, have {n}")
    return Mesh(resolve_device(devices[0]), spec.data, spec.model)


_default_mesh: Mesh | None = None


def default_mesh() -> Mesh:
    """The process-wide default grid: one shard on the serving device, built
    lazily so importing the package never touches the device."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = create_mesh()
    return _default_mesh
