"""Hold an earlier design of the ``knn_topk`` kernel against the current one
on one card: bitwise-equal indices on every fixture of ``chip_smoke.py``'s
phase 2b, then times in turns (earlier, current, current, earlier).

    python -m fraud_detection_tpu_torch.knn_topk_turns \\
        --earlier-source fraud_detection_tpu_torch/build/knn_topk_earlier.cu

Run from the repository's root (it reuses ``chip_smoke.py``'s fixtures and
timing helpers). ``--earlier-source`` is a copy of ``csrc/knn_topk.cu``
with either the one-launch interface it had before the split-and-merge
design, ``knn_topk_launch(xc, sq, out, m, d, k, device, stream)``, or the
current one (a source that defines ``knn_topk_plan``: a variant of this
design); it is built with the port's nvcc flags into the git-ignored
``build/``. Every phase-2b
fixture (m = 2 … 100,000, the duplicated rows, the lattice), and three
wide ones of this script's own (m = 20,000 at d = 37, 64 and 128), is
compared in full: the two kernels must return the same int32 indices bit
for bit. At m = 126, 158, 4096 and 100,000 at d = 30, and at the three
wide fixtures (k = 5 throughout), each design is timed as CUDA events over
launches replayed from one CUDA graph, and the current one's kernels one
by one under ``torch.profiler``. Prints one line per fixture and size and
a JSON line, which it also writes to ``chiprun_out/knn_topk_turns.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from fraud_detection_tpu_torch.ops import kernels

ROOT = kernels.BUILD_DIR.parent.parent
#: timed (m, d), all at k = 5: the training sizes and the scale of phase
#: 2b at d = 30, and more than 32 features at a size that takes the large
#: tiles' place
SIZES = ((126, 30), (158, 30), (4096, 30), (100_000, 30),
         (20_000, 37), (20_000, 64), (20_000, 128))
WIDE = tuple((m, d) for m, d in SIZES if d > 32)

#: the earlier design's C interface
EARLIER_SIGNATURES = {
    "knn_topk_launch": (
        [ctypes.c_void_p] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-source", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("knn_topk_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (card_line, graph_ms, knn_bound, knn_fixtures, knn_inputs,
                            profiled_kernels)

    from fraud_detection_tpu_torch.device import resolve_device

    resolve_device("cuda")
    card = card_line()
    split = "knn_topk_plan" in args.earlier_source.read_text()
    lib, _ = kernels.build_library(
        args.earlier_source, "knn_topk_earlier",
        kernels._SIGNATURES["knn_topk"] if split else EARLIER_SIGNATURES)
    kernels.build_kernels(["knn_topk"])
    result = {"card": card, "fixtures": {}, "sizes": {}}
    timed = {}
    rng = np.random.default_rng(args.seed + 1)
    wide = [(f"m={m} d={d} k=5", rng.standard_normal((m, d), dtype=np.float32), 5)
            for m, d in WIDE]
    for label, x, k in knn_fixtures(args.seed) + wide:
        xc, sq = knn_inputs(x)
        m, d = xc.shape
        out = torch.empty((m, k), dtype=torch.int32, device=xc.device)
        scratch = None
        if split:
            plan = (ctypes.c_int * 4)()
            if lib.knn_topk_plan(m, d, k, xc.device.index, ctypes.cast(plan, ctypes.c_void_p)):
                raise RuntimeError(f"earlier knn_topk refuses (m, d, k) = ({m}, {d}, {k})")
            scratch = torch.empty((plan[0], m, k), dtype=torch.int64, device=xc.device)

        def earlier(xc=xc, sq=sq, out=out, m=m, d=d, k=k, scratch=scratch):
            stream = torch.cuda.current_stream().cuda_stream
            if scratch is None:
                rc = lib.knn_topk_launch(xc.data_ptr(), sq.data_ptr(), out.data_ptr(), m, d, k,
                                         xc.device.index, stream)
            else:
                rc = lib.knn_topk_launch(xc.data_ptr(), sq.data_ptr(), scratch.data_ptr(),
                                         scratch.numel() * 8, out.data_ptr(), m, d, k,
                                         xc.device.index, stream)
            if rc != 0:
                raise RuntimeError(f"earlier knn_topk launch failed: {rc}")
            return out

        def current(xc=xc, sq=sq, k=k):
            return kernels.knn_topk(xc, sq, k)

        old = earlier().clone()
        new = current()
        torch.cuda.synchronize()
        rows = int((old != new).any(dim=1).sum())
        print(f"knn_topk_turns {label}: {rows} of {m} rows differ from the earlier kernel")
        result["fixtures"][label] = rows
        if rows:
            raise AssertionError(f"knn_topk {label}: {rows} rows differ from the earlier kernel")
        if (m, d) in SIZES and k == 5:
            timed[m, d] = (earlier, current, k)
        else:
            del xc, sq, out, old, new, scratch
    for m, d in SIZES:
        earlier, current, k = timed[m, d]
        big = m >= 20_000
        turns = [graph_ms(fn, iters=3 if big else 200, replays=3 if big else 5)
                 for fn in (earlier, current, current, earlier)]
        by_kernel: dict[str, float] = {}
        for name, us in profiled_kernels(current):
            key = "knn_topk_merge" if "merge" in name else (
                "knn_topk_split" if "split" in name else name[:32])
            by_kernel[key] = by_kernel.get(key, 0.0) + us
        plan = kernels.knn_topk_plan(m, d, k, torch.device("cuda"))
        bound, by, _, _ = knn_bound(m, d, k)
        row = {"earlier_ms": (turns[0] + turns[3]) / 2, "current_ms": (turns[1] + turns[2]) / 2,
               "turns_ms": turns, "bound_ms": bound, "bound_by": by, "plan": plan,
               "current_kernels_us": by_kernel}
        result["sizes"][f"m={m} d={d}"] = row
        print(f"knn_topk_turns m={m} d={d} k={k}: earlier {row['earlier_ms']:.6f} ms, current "
              f"{row['current_ms']:.6f} ms (turns earlier, current, current, earlier: "
              + ", ".join(f"{t:.6f}" for t in turns) + f"), bound {bound:.6f} ms ({by}); "
              f"grid {plan['query_tiles']} x {plan['splits']} splits of "
              f"{plan['keys_per_split']} keys, {plan['tile']}-row tiles; current by kernel "
              "(profiler, one call): " + ", ".join(f"{k_} {v:.3f} us" for k_, v in by_kernel.items()))
    del timed
    torch.cuda.empty_cache()
    print(card)
    line = json.dumps(result)
    print(line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "knn_topk_turns.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
