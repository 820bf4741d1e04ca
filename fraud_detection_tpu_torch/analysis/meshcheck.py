"""The shape pass: every program of the port at every mesh size (the JAX
package's ``analysis/meshcheck.py``, its runner).

JAX registers each jitted entry point with a builder of abstract inputs
and evaluates it with ``jax.eval_shape`` under CPU meshes of sizes 1, 2
and 8 (the broadside entry points on four ``data × model`` grids),
pre-checking each ``NamedSharding`` for divisibility; an error is the
row's result, never the end of the pass.

The port runs eagerly over virtual shards (``parallel/mesh``), so the pass
runs each program once, on ``DEVICE`` (``cuda`` unless the caller asks for
the CPU), at JAX's meshcheck shapes (1024 rows × 30 features, the Kaggle
schema) through the builders of :mod:`.contracts` (``PROGRAMS``: one a
JAX entry point, and the conductor's pool). Virtual shards need no device
count. The pre-check of the inputs' layout is the check every split
already passes: ``parallel/sharding.split_segments`` (through
``ShardLayout.segments``) for rows and
``MeshDriftMonitor._placed_wide_table`` for the column-sharded cross
table, each raising "not divisible" with the shape and the count. A row's
``out`` lists the result's leaves as ``(shape):dtype``, as JAX's does.

Registering a new program is one row of ``contracts.PROGRAMS``; the pass
then runs it at every mesh size.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Iterable

import torch

from fraud_detection_tpu_torch.analysis.contracts import PROGRAMS, Shape, dtype_name, leaves
from fraud_detection_tpu_torch.device import resolve_device
from fraud_detection_tpu_torch.parallel.mesh import Mesh, MeshSpec, create_mesh

DEFAULT_MESH_SIZES = (1, 2, 8)

#: 2-D (data × model) factorizations the grid programs are proven on — a
#: non-trivial model axis up to 8 shards, both orientations of the grid
WIDE_MESH_SHAPES = ((1, 1), (2, 2), (4, 2), (2, 4))

#: batch rows, divisible by every mesh size under test
_ROWS = 1024
_FEATURES = 30  # the Kaggle credit-card schema the whole repo is built on

#: the programs' shapes in this pass: a flush and the ledger flush take
#: every row, as JAX's builders do
SHAPE = Shape(rows=_ROWS, features=_FEATURES, flush=_ROWS, ledger=_ROWS)


@dataclass(frozen=True)
class Entrypoint:
    name: str
    build: Callable[[Mesh], tuple[Callable[[], object], int]] = field(repr=False)
    mesh_sizes: tuple = DEFAULT_MESH_SIZES


_ENTRYPOINTS: dict[str, Entrypoint] = {}


def register_entrypoint(name: str, mesh_sizes: tuple = DEFAULT_MESH_SIZES):
    """Decorator: register ``build(mesh) -> (run, units)`` under ``name``."""

    def deco(build):
        if name in _ENTRYPOINTS:
            raise ValueError(f"duplicate entrypoint {name!r}")
        _ENTRYPOINTS[name] = Entrypoint(name=name, build=build, mesh_sizes=mesh_sizes)
        return build

    return deco


def iter_entrypoints() -> list[Entrypoint]:
    return list(_ENTRYPOINTS.values())


for _program in PROGRAMS:
    register_entrypoint(
        _program.entrypoint, WIDE_MESH_SHAPES if _program.grid else DEFAULT_MESH_SIZES
    )(functools.partial(_program.build, shape=SHAPE))


def _out_summary(out) -> str:
    found = leaves(out)
    return ", ".join(
        f"{tuple(leaf.shape)}:{dtype_name(leaf)}" for leaf in found[:8]
    ) + ("..." if len(found) > 8 else "")


def verify_entrypoint(ep: Entrypoint, sizes: Iterable | None = None,
                      device=None) -> list[dict]:
    """``ep`` once at each of ``sizes`` (default its own) on ``device``:
    one row a size, ``{"entrypoint", "mesh_size", "ok", "error", "out"}``.
    An int size is a ``(size, 1)`` mesh, a tuple ``(data, model)``,
    labelled ``"DxM"``; an exception in the build or the run is the row's
    ``error`` (``"Type: message"``)."""
    dev = resolve_device(device)
    results = []
    for size in sizes if sizes is not None else ep.mesh_sizes:
        if isinstance(size, tuple):
            d_ax, m_ax = size
            label: int | str = f"{d_ax}x{m_ax}"
        else:
            d_ax, m_ax = size, 1
            label = size
        res = {"entrypoint": ep.name, "mesh_size": label, "ok": False,
               "error": None, "out": None}
        try:
            mesh = create_mesh(MeshSpec(data=d_ax, model=m_ax), devices=[dev] * (d_ax * m_ax))
            run, _units = ep.build(mesh)
            out = run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            res["ok"] = True
            res["out"] = _out_summary(out)
        except Exception as e:  # lockcheck: ignore[silent-except] — the row's result
            res["error"] = f"{type(e).__name__}: {e}"
        results.append(res)
    return results


def verify_all(sizes: Iterable | None = None, device=None) -> list[dict]:
    """Every registered entry point at its sizes (or every one at
    ``sizes``) on ``device``."""
    out: list[dict] = []
    for ep in iter_entrypoints():
        out.extend(verify_entrypoint(ep, sizes, device))
    return out
