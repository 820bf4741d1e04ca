"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (inputs and weights from the seed, the program loaded
and warmed), the measured window, then the comparison with the plain
reference. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled stretch of the window; its last key,
``checks``, holds each number compared beside its limit, which also end
standard error. The run fails, and prints no result, without a CUDA card
(or fewer than the cell asks for), without the program, or when a module
of JAX or of the JAX package is loaded once set-up is done or at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import nojax, peaks, registry  # noqa: E402


class RunFailed(Exception):
    """A run that must end without a result line, with this exit code."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


@dataclass
class Context:
    """What a traffic session is given."""

    cell_name: str
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    device: str
    work: str
    pkg: Path
    env: dict = field(default_factory=dict)
    fit_override: object = None


@dataclass
class Run:
    """What a metric's reader is given (``metrics/<name>.py``: ``read(run)``,
    returning a number or None when it finds nothing to read)."""

    cell_name: str
    cfg: dict
    mix: dict
    seconds: float
    setup_s: float
    window: dict
    device_name: str | None
    pkg: Path

    @property
    def trace(self):
        return self.window.get("trace")

    @property
    def peaks(self) -> dict | None:
        return peaks.peaks_for(self.device_name)

    def cost(self, name: str):
        return registry.cost(name, self.pkg)


def _check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunFailed("no CUDA device: torch.cuda.is_available() is False", 2)
    if torch.cuda.device_count() < chips:
        raise RunFailed(f"the cell needs {chips} cards, {torch.cuda.device_count()} present", 2)


def _check_nojax(when: str) -> None:
    found = nojax.forbidden_modules()
    if found:
        raise RunFailed(f"JAX loaded {when}: {', '.join(found[:20])}", 3)


def _power_line(device: str) -> str | None:
    """The card's name and power limit, from nvidia-smi where it runs."""
    if device != "cuda" or shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return f"card: {out}" if out else None


def _number(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             env: dict | None = None, fit_override=None, pkg: Path = registry.PKG,
             root: Path = registry.ROOT, t_start: float | None = None, log=print) -> dict:
    """One run of a cell → the result object (the last line's content).
    ``env`` and ``fit_override`` exist for the controls, ``device="cpu"``
    (which skips the look for cards) for the tests: the benchmark's own
    runs pass none of them."""
    t_start = T_START if t_start is None else t_start
    bench = registry.benchmark(root)
    entry = registry.cell_entry(bench, cell_name)
    cell = registry.workload(cell_name, pkg)
    if device == "cuda":
        _check_card(int(entry["chips"]))
    import torch

    cfg = registry.config(cell["config"], pkg)
    mix = registry.mix(cell["traffic"], pkg)
    kind = registry.traffic(mix["kind"], pkg)
    work = tempfile.mkdtemp(prefix="portbench-")
    ctx = Context(cell_name, cell, cfg, mix, int(seed), float(seconds), device, work, Path(pkg),
                  dict(env or {}), fit_override)
    session = kind.Session(ctx)
    try:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        session.setup()
        _check_nojax("after set-up")
        tracer = None
        if trace:
            from portbench.traceread import Tracer

            tracer = Tracer(device)
            tracer.warm()
        setup_s = time.perf_counter() - t_start
        window = session.window(float(seconds), tracer)
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
               "count": int(entry["chips"]),
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
               if device == "cuda" else 0}
    finally:
        session.teardown()
        gc.collect()
    try:
        numbers = session.check()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run = Run(cell_name, cfg, mix, float(seconds), setup_s, window,
              dev["kind"] if device == "cuda" else None, Path(pkg))
    wanted = registry.per_layer(bench, cell_name) if trace else registry.end_to_end(bench, cell_name)
    metrics = {}
    for m in wanted:
        value = registry.metric_reader(m["name"], pkg).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = cell["check"]["limits"]
    checks = {name: {"value": _number(v), "limit": limits.get(name)} for name, v in numbers.items()}
    correct = (window["failed"] == 0 and set(checks) >= set(limits)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": bool(correct), "attempted": int(window["attempted"]),
              "failed": int(window["failed"]), "metrics": metrics, "device": dev}
    if trace and window.get("trace") is not None:
        tr = window["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = checks
    power = _power_line(device)
    if power:
        log(power)
    _check_nojax("at the end")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except RunFailed as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    except Exception:
        traceback.print_exc()
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the program's daemon threads (drift monitor, lane, tracer) end with
    # the process; skip interpreter teardown that could wait on them
    os._exit(code)
