"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder and
of ``BENCHMARK.json`` in which every size is cut to what a test holds (the
cells, mixes and configurations keep their names), so a whole run of a
cell takes seconds on the CPU. Both copies carry the lane cells held out
of ``BENCHMARK.json`` (``unresolved/lanes.json``), so their harness stays
tested."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def with_held_out(bench: dict) -> dict:
    """``bench`` with the entries of ``unresolved/lanes.json`` added."""
    held = json.loads((PKG / "unresolved" / "lanes.json").read_text())
    out = json.loads(json.dumps(bench))
    for key, entries in held.items():
        out[key] = out[key] + entries
    return out


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def shrink(root: Path) -> Path:
    """Copy the benchmark under ``root`` at test sizes; returns the copy's
    package folder."""
    pkg = root / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = with_held_out(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    def lane(m):
        # one frame a flush, as at the cells' own size
        m.update(connections=2, frame_rows=128, frames=4, trace_seconds=0.5, warm_frames=1)
        m["server_env"]["SCORER_MAX_BATCH"] = 128

    _edit(pkg / "traffic" / "mixes" / "lane1024.json", lane)

    def lane64(m):  # several frames a flush, as at the cell's own size
        m.update(connections=4, frame_rows=16, frames=8, trace_seconds=0.5, warm_frames=1)

    _edit(pkg / "traffic" / "mixes" / "lane64.json", lane64)
    _edit(pkg / "workloads" / "lr.lane64.json", lambda w: w["check"].update(sample_frames=8))
    _edit(pkg / "traffic" / "mixes" / "fit_kaggle.json", lambda m: m.update(trace_fits=1))
    for name in ("xgb_kaggle_100x5", "lr_kaggle_d30"):
        def cut(c):
            c["data"].update(rows=6000, fit_rows=2048, profile_rows=1024)
            if "n_trees" in c["model"]:
                c["model"].update(n_trees=6)
        _edit(pkg / "configs" / f"{name}.json", cut)
    for cell in ("xgb.lane1024", "lr.lane1024"):
        _edit(pkg / "workloads" / f"{cell}.json",
              lambda w: w["check"].update(sample_frames=2))
    return pkg


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> Path:
    """The package folder of a test-size copy (its root is the parent)."""
    return shrink(tmp_path_factory.mktemp("portbench_small"))


@pytest.fixture(scope="session")
def full_root(tmp_path_factory) -> Path:
    """A root whose ``BENCHMARK.json`` also holds the held-out lane cells,
    for runs at the cells' own sizes with this folder as the package."""
    root = tmp_path_factory.mktemp("portbench_full")
    bench = with_held_out(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
