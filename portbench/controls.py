"""Read the numbers a cell's comparison decides by, for the program, its
control and each planted fault, over seeds, at the cell's own size.

    python3 portbench/controls.py --cell <cell> --variant program|control|fault:<name> \\
        --seeds 11,12,13 --seconds 5 [--out chiprun_out/controls]

Each seed is one run of the cell (set-up, a short window at the cell's
own load, the comparison) in this process; one JSON line a seed: the
variant, the seed, ``correct`` and each number beside its limit. The
limits in ``workloads/<cell>.json`` are set from these readings (the
largest the program gives, the smallest the control and the faults
give); the benchmark's own runs read none of the stand-ins.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, registry, run  # noqa: E402


def read(cell: str, variant: str, seed: int, seconds: float, device: str = "cuda",
         pkg: Path = registry.PKG, root: Path = registry.ROOT) -> dict:
    kind = registry.mix(registry.workload(cell, pkg)["traffic"], pkg)["kind"]
    env, fit_override, patch = faults.variant(kind, variant)
    with patch:
        result = run.run_cell(cell, seed, seconds, False, device=device, env=env,
                              fit_override=fit_override, pkg=pkg, root=root,
                              t_start=time.perf_counter(),
                              log=lambda *_: None)
    return {"cell": cell, "variant": variant, "seed": seed, "correct": result["correct"],
            "failed": result["failed"], "checks": result["checks"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    out = None
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        out = open(os.path.join(a.out, f"{a.cell}_{a.variant.replace(':', '_')}.jsonl"), "a")
    try:
        for s in a.seeds.split(","):
            line = json.dumps(read(a.cell, a.variant, int(s), a.seconds))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
