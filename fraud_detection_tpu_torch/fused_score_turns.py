"""Hold the earlier design of the ``fused_score`` kernel against the current
one on one card: bitwise-equal f32 scores on every fixture of
``chip_smoke.py``'s phase 2, then times in turns.

    python -m fraud_detection_tpu_torch.fused_score_turns \\
        --earlier-source fraud_detection_tpu_torch/build/fused_score_earlier.cu

Run from the repository's root (it reuses ``chip_smoke.py``'s fixtures and
timing helpers). ``--earlier-source`` is a copy of ``csrc/fused_score.cu``
with the interface it had before bf16 rows, ``fused_score_launch(x, w, b,
out, n, d, device, stream)`` on f32 rows (a warp a row at every n); it is
built with the port's nvcc flags into the git-ignored ``build/``. Three
kernels take part: the earlier one, the current one (the launcher picks a
warp a row or a thread a row of a tile by n and d) and the current source
built with ``-DFUSED_SCORE_TILE_MIN_ROWS=1`` ("tiles": a thread a row at
every n, d <= 64), which shows where the tiles start to pay. Every phase-2
fixture (n = 1 … 284,807, d = 30 and 37, the offset views) is compared in
full: the current and the tiles kernel must return the earlier one's f32
bits, on the f32 rows and, in bf16, on the rows' values in f32. Then, at
d = 30, each is timed as CUDA events over launches replayed from one CUDA
graph, in the order earlier, current, tiles, tiles, current, earlier, at n
= 8 … 284,807 (f32; at 284,807 the launches rotate over enough copies of
the rows to exceed the 50 MB L2, so the rows come from device memory) and
on bf16 rows at n = 1024 and 20,000 (the earlier kernel on the same rows
in f32); beside them ``sigmoid(addmv)``, the bytes bound and a one-thread
empty kernel built with the same flags (the harness's launch floor, timed
first and last). Prints one line per fixture and size and a JSON line,
which it also writes to ``chiprun_out/fused_score_turns.json``.
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
D = 30
#: timed row counts at d = 30: buckets of the ladder, the sizes around the
#: launcher's switch to tiles, the committed dataset and its padded bucket,
#: the Kaggle file's full row count
SIZES = (8, 64, 1024, 4096, 8192, 16_384, 20_000, 32_768, 284_807)
BF16_SIZES = (1024, 20_000)
L2_BYTES = 50 * 2**20
#: the earlier design's C interface
EARLIER_SIGNATURES = {
    "fused_score_launch": (
        [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
#: the build flag that sends every launch with d <= 64 to the tiles
TILES_FLAGS = ("-DFUSED_SCORE_TILE_MIN_ROWS=1",)


def rotated_copies(n: int, elem_bytes: int) -> int:
    """How many copies of an (n, D) input the timed launches rotate over:
    one while they fit in L2 twice over, else enough to exceed it twice."""
    size = n * D * elem_bytes
    return 1 if 2 * size <= L2_BYTES else -(-2 * L2_BYTES // size)


def launcher(lib: ctypes.CDLL, name: str, with_dtype: bool):
    """``fn(w, b, x) -> scores`` over a library's ``fused_score_launch``;
    ``with_dtype`` passes x's dtype code (the current interface)."""

    def call(w, b, x):
        out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        dtype = (kernels.FUSED_SCORE_DTYPES[x.dtype],) if with_dtype else ()
        rc = lib.fused_score_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    x.shape[0], x.shape[1], *dtype, x.device.index,
                                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} fused_score launch failed: {rc}")
        return out

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-source", type=Path, required=True)
    ap.add_argument("--tiles-source", type=Path, default=kernels.CSRC_DIR / "fused_score.cu",
                    help="the source of the tiles kernel (default: the current one; a "
                         "variant with the same interface to time it in its place)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_score_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (card_line, fused_score_bound, fused_score_fixtures, graph_ms,
                            launch_floor_fn)

    from fraud_detection_tpu_torch.device import resolve_device

    resolve_device("cuda")
    card = card_line()
    old_lib, _ = kernels.build_library(args.earlier_source, "fused_score_earlier",
                                       EARLIER_SIGNATURES)
    tiles_lib, _ = kernels.build_library(args.tiles_source,
                                         "fused_score_tiles", kernels._SIGNATURES["fused_score"],
                                         TILES_FLAGS)
    kernels.build_kernels(["fused_score"])
    earlier = launcher(old_lib, "earlier", with_dtype=False)
    tiles = launcher(tiles_lib, "tiles", with_dtype=True)
    dev = torch.device("cuda")

    def differ(a, b_):
        return int((a.view(torch.int32) != b_.view(torch.int32)).sum())

    result = {"card": card, "fixtures": {}, "sizes": {}}
    for label, x, w, b in fused_score_fixtures(args.seed):
        xb = x.bfloat16()
        old, old_b = earlier(w, b, x), earlier(w, b, xb.float())
        counts = {"current": differ(old, kernels.fused_score(w, b, x)),
                  "tiles": differ(old, tiles(w, b, x)),
                  "current_bf16": differ(old_b, kernels.fused_score(w, b, xb)),
                  "tiles_bf16": differ(old_b, tiles(w, b, xb))}
        print(f"fused_score_turns {label}: scores that differ in bits from the earlier kernel "
              f"(of {x.shape[0]}; bf16 rows against it on their values in f32): "
              + ", ".join(f"{k} {v}" for k, v in counts.items()))
        result["fixtures"][label] = counts
        if any(counts.values()):
            raise AssertionError(f"fused_score {label}: scores differ from the earlier "
                                 f"kernel: {counts}")
    del x, xb, w, b, old, old_b

    floor_fn = launch_floor_fn()
    floors = [graph_ms(floor_fn)]
    rng = np.random.default_rng(args.seed + 1)
    w = torch.from_numpy((rng.standard_normal(D) / np.sqrt(D)).astype(np.float32)).to(dev)
    b = torch.tensor(-0.5, dtype=torch.float32, device=dev)
    timed = [(n, torch.float32) for n in SIZES] + [(n, torch.bfloat16) for n in BF16_SIZES]
    for n, dtype in timed:
        elem = torch.tensor([], dtype=dtype).element_size()
        copies = [torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32))
                  .to(dev).to(dtype) for _ in range(rotated_copies(n, elem))]
        as_f32 = [c.float() for c in copies]

        def rotating(fn, inputs):
            state = [0]

            def call():
                i = state[0]
                state[0] = (i + 1) % len(inputs)
                return fn(w, b, inputs[i])

            return call

        old_fn = rotating(earlier, as_f32)
        new_fn = rotating(kernels.fused_score, copies)
        tiles_fn = rotating(tiles, copies)
        lib_fn = rotating(lambda w_, b_, x_: torch.sigmoid(torch.addmv(b_, x_.float(), w_)),
                          copies)
        iters = 60 if n >= 100_000 else 200
        turns = [graph_ms(fn, iters=iters)
                 for fn in (old_fn, new_fn, tiles_fn, tiles_fn, new_fn, old_fn)]
        library = graph_ms(lib_fn, iters=iters)
        bound, by, n_bytes, _ = fused_score_bound(n, D, elem)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        row = {"earlier_ms": (turns[0] + turns[5]) / 2, "current_ms": (turns[1] + turns[4]) / 2,
               "tiles_ms": (turns[2] + turns[3]) / 2, "turns_ms": turns,
               "library_ms": library, "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
               "copies": len(copies)}
        result["sizes"][f"n={n} d={D} {name}"] = row
        print(f"fused_score_turns n={n} d={D} {name} rows (earlier on the same rows in f32): "
              f"earlier {row['earlier_ms']:.6f} ms, current {row['current_ms']:.6f} ms, "
              f"tiles {row['tiles_ms']:.6f} ms (turns earlier, current, tiles, tiles, "
              "current, earlier: " + ", ".join(f"{t:.6f}" for t in turns)
              + f"), sigmoid(addmv{'(x.float())' if name == 'bf16' else ''}) {library:.6f} ms, "
              f"bound {bound:.6f} ms ({by}: {n_bytes} B); {len(copies)} cop"
              f"{'y' if len(copies) == 1 else 'ies'} rotated")
        del copies, as_f32, old_fn, new_fn, tiles_fn, lib_fn
        torch.cuda.empty_cache()
    floors.append(graph_ms(floor_fn))
    result["launch_floor_ms"] = floors
    print(f"fused_score_turns launch floor (one-thread empty kernel, first and last): "
          f"{floors[0]:.6f} ms, {floors[1]:.6f} ms")
    print(card)
    line = json.dumps(result)
    print(line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fused_score_turns.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
