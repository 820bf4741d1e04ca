"""The shard grid: the port's counterpart of the JAX package's device mesh.

The JAX package lays a ``(data, model)`` mesh over devices (on the CPU,
the virtual host devices that ``--xla_force_host_platform_device_count``
makes). PyTorch has no virtual devices, and NCCL does not put two ranks on
one card, so here a :class:`Mesh` is a ``(data, model)`` grid of *shards
that live on one device per process*: the serving device, ``cuda:0`` on
the card or the CPU when the caller asks for it. A shard owns a slice of a
leading shard axis — its drift window, its ledger sub-table, its segment of
a staged bucket or of a training set (``parallel/sharding``). The axis
names are the JAX package's, so the meshes' shapes read the same in both.

Several processes (:func:`initialize_distributed`, one per card or several
sharing one) make one data axis of ``processes × data`` global shards:
global shard ``rank·data + s`` is local shard ``s`` of rank ``rank``, as a
JAX mesh over ``jax.devices()`` spans every process's devices. The
collectives over that axis are :mod:`.collectives`.

The model axis (the wide family's column-sharded table) lies inside a
process: shard ``(d, m)`` of a process is index :meth:`Mesh.flat_index` of
its flattened grid, and ranks split the data axis only
(:func:`global_mesh` refuses a grid whose model groups would span them).

:func:`create_mesh` takes a device list that repeats one device; a list
naming two distinct devices raises ``NotImplementedError``: a process
drives one device, and a card a process is :func:`initialize_distributed`.
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass

import torch

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

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
    """A ``(data, model)`` grid of shards on one device, in each of
    ``processes`` processes (this one is ``process``). ``shape`` maps the
    axis names to their local sizes, ``size`` is the flattened local grid
    (the length of every local shard axis); ``global_data`` counts the data
    axis over every process, and this process's shards start at global
    shard ``shard_offset``."""

    device: torch.device
    data: int
    model: int = 1
    processes: int = 1
    process: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def global_data(self) -> int:
        return self.data * self.processes

    @property
    def shard_offset(self) -> int:
        return self.process * self.data

    def flat_index(self, d: int, m: int) -> int:
        """Local shard ``(d, m)``'s index on the flattened grid, data-major
        (``d·model + m``: JAX's ``P((DATA_AXIS, MODEL_AXIS))``): the leading
        axis of the per-shard windows and sub-tables."""
        return d * self.model + m


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

_backend: str | None = None


def _dist():
    import torch.distributed as dist

    return dist


def initialized() -> bool:
    """Whether a process group is up. A group needs ``torch.distributed``
    imported, so a process that never imported it answers without paying
    the import."""
    if "torch.distributed" not in sys.modules:
        return False
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return _dist().get_rank() if initialized() else 0


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return _dist().get_world_size() if initialized() else 1


def backend() -> str | None:
    """The backend :func:`initialize_distributed` chose — ``"nccl"`` or
    ``"gloo"`` — or ``None`` when no process group is up."""
    if not initialized():
        return None
    return _backend or _dist().get_backend()


def choose_backend(device: torch.device, local_world: int) -> str:
    """The one rule for the collectives' backend: ``nccl`` when every rank
    of this host has a card of its own (``device`` is CUDA and the host has
    at least ``local_world`` cards), else ``gloo`` — on the CPU, or when
    ranks share a card (NCCL refuses two ranks on one card), with the
    partials moved through the host."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def initialize_distributed() -> None:
    """Join a ``torch.distributed`` process group when this process is one
    rank of several; a no-op otherwise, and when the group is already up.

    Reads PyTorch's launcher variables, as ``torchrun`` sets them
    (:func:`config.distributed_env`): ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` — the
    JAX package reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``. Without ``MASTER_ADDR`` nothing happens, as JAX's
    does nothing without its coordinator's address. The backend follows
    :func:`choose_backend` on the serving device (``DEVICE``); under
    ``nccl`` rank ``LOCAL_RANK`` drives card ``LOCAL_RANK``. The choice is
    logged and :func:`backend` returns it; a backend that fails to start
    raises, and is never retried with the other one."""
    global _backend, _default_meshes
    env = config.distributed_env()
    if env is None or initialized():
        return
    dist = _dist()
    dev = resolve_device()
    be = choose_backend(dev, env["local_world_size"])
    if be == "nccl":
        torch.cuda.set_device(env["local_rank"])
    dist.init_process_group(
        be, init_method=f"tcp://{env['master_addr']}:{env['master_port']}",
        world_size=env["world_size"], rank=env["rank"],
    )
    _backend = be
    _default_meshes = {}
    log.info(
        "torch.distributed initialized: process %d/%d, backend %s (%s), device %s",
        dist.get_rank(), dist.get_world_size(), be,
        "a card a rank" if be == "nccl" else
        ("ranks share a card; partials through the host" if dev.type == "cuda"
         else "CPU"),
        resolve_device(),
    )


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    global _backend, _default_meshes
    if initialized():
        _dist().destroy_process_group()
    _backend = None
    _default_meshes = {}


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


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
    length, as in JAX. Inside a process group the grid is this process's
    part of one spanning every process (:attr:`Mesh.global_data`)."""
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
            "every shard of a process lives on one device; run one process a "
            "card and join them with initialize_distributed() (MASTER_ADDR, "
            "WORLD_SIZE, RANK, as torchrun sets them)"
        )
    n = len(devices)
    if spec is None:
        spec = MeshSpec(data=n, model=1)
    if spec.data == 0:
        spec = MeshSpec(data=n // spec.model, model=spec.model)
    if spec.size != n:
        raise ValueError(f"mesh spec {spec} needs {spec.size} devices, have {n}")
    return Mesh(resolve_device(devices[0]), spec.data, spec.model,
                processes=process_count(), process=process_index())


def global_mesh(spec: MeshSpec, device: str | torch.device | None = None) -> Mesh:
    """A ``(spec.data × spec.model)`` grid over every process of the group
    (one process without one) on the serving device (or ``device``): the
    data axis splits evenly over the processes, each holding ``spec.data /
    processes`` data shards and the whole model axis. The model axis stays
    inside a process, so a data axis the processes do not divide — a model
    group that would span processes — raises ``ValueError``."""
    procs = process_count()
    if spec.data < 1 or spec.model < 1 or spec.data % procs:
        raise ValueError(
            f"a {spec.data}x{spec.model} grid over {procs} processes: ranks split "
            "the data axis only and the model axis stays inside a process, so the "
            f"data axis must be a positive multiple of {procs}"
        )
    local = MeshSpec(data=spec.data // procs, model=spec.model)
    return create_mesh(local, devices=[resolve_device(device)] * local.size)


_default_meshes: dict = {}


def default_mesh(device: str | torch.device | None = None) -> Mesh:
    """The process-wide default grid: one shard a process on the serving
    device (or ``device``), spanning every process of the group — the JAX
    package's mesh over ``jax.devices()``. Built lazily, so importing the
    package never touches the device."""
    dev = resolve_device(device)
    key = (str(dev), process_count(), process_index())
    mesh = _default_meshes.get(key)
    if mesh is None:
        mesh = _default_meshes[key] = create_mesh(devices=[dev])
    return mesh
