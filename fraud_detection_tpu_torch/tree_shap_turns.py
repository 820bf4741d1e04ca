"""Time an earlier design of the ``tree_shap`` kernel against the current
one on one card, in turns (earlier, current, current, earlier), at the
sizes the GBT served path gives it.

    python -m fraud_detection_tpu_torch.tree_shap_turns \\
        --earlier-source build/tree_shap_earlier.cu

Run from the repository's root (it reuses ``chip_smoke.py``'s timing and
forest helpers). ``--earlier-source`` is a copy of ``csrc/tree_shap.cu``
with the one-block-a-row interface it had before the tree-group design:
``tree_shap_launch(bins, path_feat, path_thr, leaf_sums (T, L, V, D),
node_order, node_start, node_count, phi, n, d, n_trees, depth, device,
stream)``; it is built with the port's nvcc flags into the git-ignored
``build/``. On the recipe's shapes (a seeded synthetic forest of 100 trees
of depth 5 over d = 30, 256 bins) each design is timed as CUDA events over
50 launches replayed from one CUDA graph, and the two must agree within
rtol 1e-4 / atol 2e-5; the current design's kernels are also timed one by
one under ``torch.profiler``. Prints one line per size and a JSON line,
which it also writes to ``chiprun_out/tree_shap_turns.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from fraud_detection_tpu_torch.ops import kernels
from fraud_detection_tpu_torch.ops.gbt import bin_features
from fraud_detection_tpu_torch.ops.tree_shap import build_tree_explainer

ROOT = kernels.BUILD_DIR.parent.parent
SIZES = (8, 64, 1024)


#: the earlier design's C interface
EARLIER_SIGNATURES = {
    "tree_shap_launch": (
        [ctypes.c_void_p] * 8
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _earlier_tables(tables):
    """The earlier design's tables, from the current ones."""
    from chip_smoke import path_tables

    d = tables.group_start.shape[1]
    sf = tables.split_feature.long()
    path_feat, path_thr = path_tables(tables)
    counts = (sf[:, :, None] == torch.arange(d, device=sf.device)).sum(dim=1)
    return [t.to(torch.int32).contiguous() if t.dtype != torch.float32 else t.contiguous()
            for t in (path_feat, path_thr, tables.leaf_sums.transpose(2, 3),
                      torch.sort(sf, dim=1, stable=True).indices,
                      torch.cumsum(counts, 1) - counts, counts)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-source", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tree_shap_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (F32_FLOPS_PER_S, HBM_BYTES_PER_S, card_line, graph_ms,
                            profiled_kernels, shap_work, synthetic_forest)

    from fraud_detection_tpu_torch.device import resolve_device

    resolve_device("cuda")
    card = card_line()
    lib, _ = kernels.build_library(args.earlier_source, "tree_shap_earlier",
                                   EARLIER_SIGNATURES)
    kernels.build_kernels(["tree_shap"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    d = 30
    model = synthetic_forest(rng, 100, 5, d, 256, dev)
    e = build_tree_explainer(model, rng.standard_normal((128, d)).astype(np.float32))
    old_tables = _earlier_tables(e.tables)
    result = {"card": card, "trees": 100, "depth": 5, "d": d, "sizes": {}}
    for n in SIZES:
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        binned = bin_features(x, model.bin_edges)
        out = torch.empty((n, d), dtype=torch.float32, device=dev)

        def earlier():
            rc = lib.tree_shap_launch(binned.data_ptr(), *(t.data_ptr() for t in old_tables),
                                      out.data_ptr(), n, d, 100, 5, dev.index or 0,
                                      torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"earlier tree_shap launch failed: {rc}")
            return out

        def current():
            return kernels.tree_shap(binned, e.tables)

        torch.testing.assert_close(current(), earlier().clone(), rtol=1e-4, atol=2e-5)
        turns = [graph_ms(fn, iters=50) for fn in (earlier, current, current, earlier)]
        n_ops, n_bytes = shap_work(e.tables, binned)
        # the current design's two kernels, by name (profiler, one call)
        by_kernel: dict[str, float] = {}
        for name, us in profiled_kernels(current):
            key = next(iter(re.findall(r"tree_shap_\w+", name)), name[:32])
            by_kernel[key] = by_kernel.get(key, 0.0) + us
        row = {"earlier_ms": (turns[0] + turns[3]) / 2, "current_ms": (turns[1] + turns[2]) / 2,
               "turns_ms": turns,
               "bound_ms": max(n_ops / F32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3,
               "current_kernels_us": by_kernel}
        result["sizes"][n] = row
        print(f"tree_shap_turns n={n}: earlier {row['earlier_ms']:.6f} ms, current "
              f"{row['current_ms']:.6f} ms (turns earlier, current, current, earlier: "
              + ", ".join(f"{t:.6f}" for t in turns) + f"), bound {row['bound_ms']:.6f} ms; "
              "current by kernel (profiler, one call): "
              + ", ".join(f"{k} {v:.3f} us" for k, v in by_kernel.items()))
    print(card)
    line = json.dumps(result)
    print(line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tree_shap_turns.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
