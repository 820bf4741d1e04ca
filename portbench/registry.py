"""Finds every part of a cell by its name: the entries of ``BENCHMARK.json``
at the checkout's root, and the files under this folder —

- ``workloads/<cell>.json``: the cell's configuration, traffic mix and
  the limits of its checks;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/mixes/<mix>.json``: a traffic mix's parameters, read by the
  generator ``traffic/<kind>.py`` that its ``kind`` names;
- ``metrics/<metric>.py``: the reader of a metric, ``read(run)``;
- ``costs/<name>.py``: ``cost(**shape) -> (operations, bytes)``.

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def workload(name: str, pkg: Path = PKG) -> dict:
    return _json(Path(pkg) / "workloads" / f"{name}.json")


def config(name: str, pkg: Path = PKG) -> dict:
    return _json(Path(pkg) / "configs" / f"{name}.json")


def mix(name: str, pkg: Path = PKG) -> dict:
    return _json(Path(pkg) / "traffic" / "mixes" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str, pkg: Path = PKG):
    return _module(Path(pkg) / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")


def metric_reader(name: str, pkg: Path = PKG):
    return _module(Path(pkg) / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def cost(name: str, pkg: Path = PKG):
    return _module(Path(pkg) / "costs" / f"{name}.py", f"portbench_cost_{name}")


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics a run of the cell reports: those that list
    it, and those without a list (``setup_s``)."""
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics a traced run of the cell reports: those that
    list it. Every per-layer entry lists its cells."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]
