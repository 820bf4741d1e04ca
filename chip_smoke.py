#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``fraud_detection_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py

Run from anywhere with the repository beside this file; it needs one CUDA
card, ``nvcc`` (``NVCC``/``CUDA_HOME``/``PATH``) and no network. It imports
nothing of JAX or of the JAX package. Phases, each fatal on failure:

1. **build** — compile every kernel under ``fraud_detection_tpu_torch/
   csrc/`` (one ``nvcc`` per source, started together, and ``g++`` for the
   native CSV reader beside them) and load it; print
   ``ptxas -v``'s registers, stack frame and spills for every
   instantiation of ``fused_score``'s and ``knn_topk``'s kernels, and fail
   on a spill or a stack frame there.
2. **fused_score against its plain version** — the wrapper on CUDA
   tensors at n = 1, 8, 33, 64, 256, 1000, 1024, 4096, 8192, 20,000,
   32,768, 65,536 and 284,807 (d = 30), n = 33, 1024 and 10,000 at d = 37, n = 10,000 at
   d = 65, and views whose base is not 16-byte aligned (``x[1:]`` and a
   flat buffer one element in, n = 1000 and 10,000, d = 30 and 37), so
   both of the kernel's shapes (a warp a row below 8192 rows or above 64
   features, a thread a row of a tile otherwise) are held: max |kernel −
   plain| ≤ 1e-6, on the f32 rows and on the same rows in bf16, whose
   scores must equal the kernel's on ``x.float()`` bit for bit. Then times
   the kernel at n = 8, 64, 1024, 4096, 8192, 20,000, 32,768, 65,536 and
   284,807 (f32; 4096, 8192 and 65,536 are the offline tools' buckets; the
   Kaggle file's rows stay in the 50 MB L2 across launches) and 1024 and
   20,000 (bf16), the plain version, one library call computing the
   same function (``sigmoid(addmv)``; bf16 rows are upcast first) and a
   one-thread empty kernel built with the same flags (the launch floor),
   all as CUDA events over 200 calls replayed from one CUDA graph, so the
   host's launch cost is out of the number (eager per-call times are
   printed beside), against the least time the card could take (bytes over
   3.35 TB/s, operations over the f32 peak). The int8 wire's linear score
   at n = 1024: int8 codes upcast by ``codes.float()`` (exact) into the
   kernel, held against the plain version; the upcast, the kernel on the
   upcast rows, the two together and ``sigmoid(addmv(codes.float()))``
   timed (the bound reads the rows as int8).
2b. **knn_topk against its plain version** — rows from
   ``np.random.default_rng(seed)`` at (m, d, k) = (2, 30, 1), (6, 30, 5),
   (126, 30, 5), (158, 30, 5), (394, 30, 5), (1000, 37, 5), (4096, 30, 5),
   (20000, 30, 5) and (100000, 30, 5), a duplicated-rows fixture and a
   lattice fixture (integer points closed under x → −x: every distance
   exact). Exact index equality everywhere below m = 20,000; from there
   the plain version runs on 4,096 sampled query rows against all keys,
   and a mismatched row must be a near-tie (the float64 distances of the
   two selections agree within 1e-5 relative). Times the kernel at
   m = 126 (a training fold's), 158 (the default training run's final fit),
   394 (``preprocess`` on a Kaggle-sized set), 4096, 100,000 (the 10M-row
   configuration's minority set) and 20,000 at d = 37, 64 and 128, the plain
   version, the operations bound, and — as orientation only, since no
   single PyTorch call has this tie rule — ``torch.topk(torch.cdist(xc,
   xc), k + 1, largest=False)``; prints the grid and key-split count the
   kernel chose at each.
2c. **gbt_hist against its plain version** — the histogram kernel on CUDA
   tensors at the GBT recipe's shapes (31,684 rows × 30 features × 256
   bins, 1 to 16 nodes: every level of the final fit), an odd row count,
   a 16-bin model, the leaf sums (d = 1, 32 bins), a leaf whose rows all
   carry the fit's floor h = 1e-16, and all-zero weight rows, with
   zero-weight rows and rows outside the level mixed in: two launches
   bitwise equal, bitwise equal to the kernel's fixed-point model
   (``gbt_hist_fixed_point_reference``, the same quanta), every cell of
   the kernel and of the plain version within 1e-6·Σ|value| of its float64
   sum (the floored leaf's H: > 0 and within rows · quantum). Times the
   kernel at the five levels and the leaf sums, the plain version, one
   ``index_put_(..., accumulate=True)`` over precomputed cell ids (the
   library column; the port never calls it) and the byte bound, and the
   launch-weighted mean per call over a tree.
2d. **tree_shap against its plain version** — seeded synthetic forests
   (100 trees of depth 5 over d = 30 at n ∈ {1, 8, 9, 64, 1024, 4000,
   20,000}; depths 2 and 3; every node on feature 0): within rtol 1e-4 /
   atol 2e-5, equal top-3 indices (from 4,000 rows a row may differ only
   across a 3rd/4th tie within 2e-5), additivity Σφ + E[f] = f(x);
   ``bin_features`` on the card equals the host's numpy binning on a
   NaN/±inf fixture. Times the kernel at n = 8 (a lone request's bucket), 64,
   1024 (the flush cap), 4000 and 20,000 (``explain``'s batches),
   the plain version and the bound of the compact form at each (the
   tables' bytes this run's rows touch, or its operations), and, as
   orientation beside a null library column, the TPU kernel's dense
   three-product form as ``torch.matmul`` (TF32 off) at n = 1024.
3. **the served path** — copies ``models/``, builds the drift baseline
   from the first 20,000 rows of ``data/creditcard.csv`` with the port's
   ``build_baseline_profile``, serves the port's app over HTTP on
   localhost from that directory (an empty tracking store, so the loader
   falls to ``native:<dir>``, which is checked; its results DB and broker
   in the run's temp directory:
   every ``/predict`` persists and enqueues its explanation, which phase 7
   drains) with ``SCORER_EXPLAIN=topk`` and the default
   ``SCORER_MAX_BATCH``, sends 256 ``/predict`` requests with real rows
   from 64 threads of a separate client process, then 64 one at a time,
   and checks every score against a float64 numpy computation
   from ``model.npz`` (atol 1e-5), every reason-code list against a numpy
   ranking with the same tie rule, that the fused flush (not the split
   one) served them, that ``/monitor/status`` counted the rows, and that
   every kernel of the path launched during the run (its launch count is
   zeroed just before the requests and read just after).
4. **the trained path** — the port's trainer (``train()``, what
   ``python -m fraud_detection_tpu_torch.train`` runs) on the card over
   the committed CSV with its defaults (5 folds, SMOTE, L-BFGS), its
   models and tracking store in a temporary directory; the launch counts
   are zeroed just before and read just after, and ``knn_topk`` must have
   launched exactly 6 times (5 folds + the final fit). The same trainer
   with ``device="cpu"`` must agree on test AUC and CV mean within 2e-3,
   both runs must pass the 0.95 gate and register version 1 in their own
   registries, ``models:/fraud@prod`` must resolve to the card run's
   artifact, and that artifact, loaded on the card, must score 1024 CSV
   rows within 1e-5 of a float64 numpy computation from its ``model.npz``.
   Prints the wall time of each stage (host clock, the device synchronised
   at stage boundaries) and the L-BFGS iterations of each fit.
5. **the GBT trained path** — ``train(model_family="gbt")`` with its
   defaults (100 trees, depth 5, 256 bins, 5 folds with SMOTE) on the card
   and on the CPU over the committed CSV: ``gbt_hist`` launches exactly
   3,600 times (6 fits × 100 trees × 6) and ``knn_topk`` 6 times; card −
   CPU test AUC and CV mean within 5e-3 (a near-tie split may go the other
   way), the same gate verdict; stage times.
6. **the GBT served path** — the card-trained registered artifact served
   over HTTP from phase 5's registry (the loader's source is checked:
   ``registry:models:/fraud@prod``) with ``SCORER_EXPLAIN=topk`` (256 concurrent and 64 sequential
   ``/predict``): scores within 1e-5 of a float64 numpy walk of the forest
   in ``model.npz``; reason codes equal the port's plain TreeSHAP on the
   CPU except across a k-th/(k+1)-th tie within 2e-5 (counted); every
   flush fused; ``tree_shap`` launched at least once per flush; five
   1024-row flushes profiled (busy as the union of device intervals, so a
   programmatic dependent launch that overlaps its primary counts once;
   ``tree_shap`` from its group pass's start to its group sum's end) and
   30 timed on the host's clock. The margin's sum over trees, by halving
   (served) and by one reduction kernel: the rows whose bits change alone
   or in a bucket of 8 against the 1024-row batch (the served form must
   change none), and the 1024-row flush with each, in turns.
7. **the explain path** — for phase 3's logistic directory (an empty
   tracking store: ``native:<dir>``) and phase 5's forest (its registry:
   ``registry:models:/fraud@prod``), each source checked in the app and in
   the worker's log: the app with a results DB and a broker (sqlite files in the
   run's temp directory) answers ``/health`` 200 ``healthy`` and 128
   ``/predict`` with ``explanation_status: "queued"``; one poison task (a
   row of the wrong width, no retries) joins the queue; the worker's entry
   point (``python -m fraud_detection_tpu_torch.service.worker --max-batch
   64``, its own process, the default device) drains it until every
   ``/explain/{id}`` reads COMPLETED and the poison FAILED, within 300 s,
   and exits 0 on SIGTERM; its ``/metrics`` show no explain-consistency
   failure, 128 successes and 1 failure; the queue is empty. Every stored
   score is within 1e-5 of float64 numpy (``model.npz``; the float64
   forest walk), every φ within 1e-5 of the float64 closed form
   coef·(x − μ) (logistic) or within rtol 1e-4 / atol 2e-5 of the port's
   CPU plain TreeSHAP (GBT), and Σφ + E[f] within 1e-4 of the score's
   logit. Then, in process, one ``run_batch`` of 64 tasks under zeroed
   launch counts must launch ``fused_score`` (logistic) or ``tree_shap``
   (GBT), three more run under the profiler (device busy a batch) and 20
   more are timed on the host's clock, by stage (claim, score, explain,
   upserts, acks); prints the drain's seconds, the ``/explain`` readback
   latency and ``run_batch``'s p50.
8. **the offline tools** — in the run's temp directory, each tool under
   zeroed launch counts checked against ``TOOL_LAUNCHES``, its wall time
   on the host clock with the device synchronised: ``preprocess`` on the
   committed CSV (``X_test``/``y_test`` bit for bit a CPU run's, SMOTE
   balanced); ``evaluate`` on phase 4's logistic artifact and phase 5's
   forest (confusion matrix equal to a CPU run's, AUC within 1e-6, scores
   within 1e-5 of float64 numpy); ``explain`` on the forest over the 4,000
   test rows (φ within rtol 1e-4 / atol 2e-5 of the CPU run's plain
   TreeSHAP on every row, additivity within 1e-4 of the float64 forest
   walk, the top 10 equal but across a 2e-5 tie); at the Kaggle file's
   scale (284,807 rows, 492 frauds expected, generated into the temp
   directory): ``preprocess`` (``knn_topk`` at m ≈ 394), ``evaluate``
   (56,962 rows, the 65,536 bucket) and ``explain`` at ``max_rows`` =
   20,000 (``tree_shap`` at n = 20,000; 1,024 sampled rows against the
   CPU plain TreeSHAP); ``validate_auc`` on phase 4's registry through the
   file store and through the port's tracking server (its entry point, own
   process; the artifact unpacked into ``FRAUD_REGISTRY_CACHE``): equal
   AUCs that pass, the CLI at ``--threshold 1.01`` exits 1, the runs read
   back over HTTP; ``predict_single`` in process and through its CLI
   (label and P(fraud) of ``_DEMO_ROW`` within 1e-5 of float64, the log
   naming ``registry:models:/fraud@prod``); ``eda`` without plots (counts
   and the processed CSV parsed back).
9. **the quantized wires** — ``SCORER_WIRE=int8`` and then ``bfloat16``
   with ``SCORER_EXPLAIN=topk``, each family served over HTTP (phase 3's
   logistic directory from an empty store: ``native:<dir>``, with no
   stamped calibration, so the int8 wire derives one from the scaler;
   phase 5's forest from its registry, its calibration stamped): 128
   ``/predict`` from 32 threads, then 32 one at a time, under zeroed
   launch counts. Every score within 1e-5 of float64 numpy on the values
   the wire delivers (the dequantized codes or the bf16-rounded rows, from
   the scorer's own host encode), within JAX's gate of the f32 wire's
   scores (max 5e-2, mean below 1e-2), reason codes as the
   numpy ranking or the port's CPU plain TreeSHAP over the same values but
   across a 2e-5 tie; ``scorer_wire_fused 1`` and ``scorer_explain_fused
   1`` in ``/metrics``, every flush fused, ``fused_score`` (logistic) or
   ``tree_shap`` (GBT, once a flush) launched. Then a 1024-row fused flush
   with explain per wire (f32, bf16, int8) and family: host time (p50 of
   30), its stream time (CUDA events), device busy and launches
   (profiler), h2d bytes. Then ``predict_proba_stream`` over the
   Kaggle-sized set's 284,807 rows (chunk 32,768, 8 in flight): the three
   h2d wires × the three return wires (logistic) and f32 and int8 (the
   forest), timed on the host's clock with the device synchronised, nine
   rounds taking every combination in turn (the flushes too run the wires
   in turns),
   each f32 return within 1e-5 of float64 on the wire's values, each
   narrow return within its step of the f32 return; against the f32
   wire's logistic scores every stream's mean gap below JAX's 1e-2, the
   bf16 wire's largest within JAX's 5e-2, and the int8 wire's rows whose
   codes do not clip within half a lattice step a feature through the
   weights (JAX's 5e-2 is a gate of its test fixture: the rows above it
   are counted and printed).
10. **ingest, shadow, spyglass, native CSV** — the native CSV reader
   (``data/native.py``) on the committed and the Kaggle-sized CSV, bitwise
   ``np.loadtxt(float64).astype(float32)``, on 20,000 × 31 values of 16-18
   significant digits within 1 ulp (the values that differ counted), no
   fall-through (``NATIVE_CSV_FALLBACKS`` 0); the reader and
   ``np.loadtxt`` timed in turns (median of 5) and the Kaggle-scale
   ``preprocess``, ``evaluate`` and ``explain`` with ``NATIVE_CSV=0`` and
   ``=1`` in turns. Then each family (phase 3's logistic directory, phase
   5's forest from its registry; explain on, f32 wire) served with the
   binary lane on an ephemeral ``INGEST_PORT``: 8 frames of 1024 rows are
   8 flushes and 8 ``fused_score`` (or ``tree_shap``) launches; the same
   1024 rows through the lane in frames of 1, 64 and 1024, through ``POST
   /ingest/batch`` as one frame and through ``/predict`` score bitwise
   alike with equal reason codes; an int8-layout frame within JAX's gate
   of f32 (the forest, with no scaler on the f32 wire, refuses it as the
   JAX lane does); a NaN frame and a truncated frame refused, the lane
   still scoring; no staging allocation over 100 frames; the lane's rows/s
   from 4 connections (a client process) beside ``/predict``'s requests/s,
   both on the host clock; ``/debug/flightrecorder``'s records with six
   stages and their p50s over the 1024-row frames; a 1024-row flush's host
   time with spyglass off and on, in turns. Then phase 4's model at
   ``@shadow`` beside phase 3's at ``@prod`` (``WATCHTOWER_SHADOW_SAMPLE=1``):
   8 frames, 8 shadow batches, 8 challenger ``fused_score`` launches, the
   window's disagreement, mean |Δscore| and score PSI within 1e-6 of a
   numpy recomputation; a drift episode under
   ``WATCHTOWER_RETRAIN_TRIGGER=1`` enqueuing one
   ``watchtower.trigger_retrain``; the legacy app answering ``POST
   /predict`` with ``/predict``'s probability through ``fused_score``.

11. **the ledger** — ``fused_score`` at n = 1024, d = 34 (the ledger
   flush's width) and ``knn_topk`` at m = 158, d = 34 (the final fit's
   SMOTE) held against their plain versions and timed as in phases 2 and
   2b. ``train --ledger`` (``ledger=True``; 8,192 slots, half-life 3,600 s,
   the Amount column, 50 events a pseudo-entity) on the card and on the CPU
   over the committed CSV: ``knn_topk`` launches exactly 6 times, card −
   CPU test AUC within 5e-3. The card's replay of the 20,000 rows twice:
   bitwise equal, and bitwise the trainer's stamped table; against the
   CPU's: ``last_ts``, fingerprints and counts equal, the float columns
   within rtol/atol 1e-5. Then the card run's directory served over HTTP
   on the f32 and the int8 wire (``SCORER_EXPLAIN=topk``,
   ``SCORER_MAX_INFLIGHT=1``): the table after start-up bitwise the
   stamped one; 144 ``/predict`` with ``entity_id`` over 36 entities (most
   with a ``timestamp``) and 24 without, half from 16 threads of a client
   process, then one 256-row ``/ingest/batch`` frame with fingerprints and
   timestamps (every 9th row entity-less); every flush recorded and
   replayed through the ledger body: the served table bitwise the replay,
   every score within 1e-5 of float64 numpy on the replayed widened rows,
   ``fused_score`` launched once a flush, ``ledger_null_entity_rows`` up by
   the entity-less rows sent, ``ledger_active 1`` in ``/metrics`` and a
   ``ledger`` body in ``/monitor/status``. Then a 1024-row ledger flush and
   the stateless flush (phase 3's model), in turns: host p50, stream p50
   (CUDA events), device busy and launches (profiler); the read-update
   alone (its launches and device busy); the replay of the Kaggle-sized
   CSV (284,807 rows), its wall time on the card.

Output: the card's ``nvidia-smi`` name and power limit, per-phase lines,
one ``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi`` line again
(as the tool prints it), and as the last line ``{"ok": true, "device":
{...}}``. Without a card, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_TOL = 1e-6
SCORE_ATOL = 1e-5
N_REQUESTS = 256  # concurrent /predict requests
CLIENTS = 64  # client threads sending them
N_SEQUENTIAL = 64  # then one client, one request at a time
PROFILE_ROWS = 20_000
TIMED_LAUNCHES = 200
#: phase 2's fused_score fixtures (n, d), besides the offset views
FUSED_SCORE_SHAPES = ((1, 30), (8, 30), (33, 30), (64, 30), (256, 30), (1000, 30), (1024, 30),
                      (4096, 30), (8192, 30), (20000, 30), (32768, 30), (65536, 30),
                      (284807, 30), (33, 37), (1024, 37), (10000, 37), (10000, 65))
FUSED_SCORE_VIEW_N = (1000, 10000)  # rows of the offset views: both of the kernel's shapes
#: f32 rows at d = 30: the worker's smallest and largest bucket (8, 64), the
#: flush cap, the ladder's top (and evaluate's bucket on the committed CSV),
#: validate_auc's bucket, the CSV, the profile's bucket, evaluate's bucket
#: on the Kaggle-sized test split
FUSED_SCORE_TIMED_N = (8, 64, 1024, 4096, 8192, 20000, 32768, 65536, 284807)
FUSED_SCORE_BF16_TIMED_N = (1024, 20000)  # bf16 rows at d = 30
TIMING_SUFFIX = {"bfloat16": "_bf16", "int8": "_int8_codes"}  # the kernels line's keys
KNN_SAMPLE_ROWS = 4096  # plain-version queries at m >= KNN_SAMPLED_FROM
KNN_SAMPLED_FROM = 20_000
KNN_NEAR_TIE_RTOL = 1e-5
TRAIN_AUC_TOL = 2e-3  # card vs CPU training run
TRAIN_SCORED_ROWS = 1024
KNN_LAUNCHES_PER_RUN = 6  # 5 folds + the final fit
#: (m, d) timed: a fold's minority rows, the final fit's, preprocess's on
#: the Kaggle-sized set, m = 4096, the 10M-row configuration's minority set,
#: and m = 20,000 at three widths (each one of the kernel's tile shapes)
KNN_TIMED = ((126, 30), (158, 30), (394, 30), (4096, 30), (100000, 30),
             (20000, 37), (20000, 64), (20000, 128))
HIST_REL_TOL = 1e-6  # |cell − float64 sum| ≤ this · Σ_rows |value|
SHAP_RTOL, SHAP_ATOL = 1e-4, 2e-5  # tree_shap against its plain version
SHAP_TIE = 2e-5  # a reason-code row may differ only across a tie this close
#: tree_shap's recipe rows against plain, up to explain's batches: the
#: committed CSV's test split and max_rows on the Kaggle-sized split
SHAP_CHECKED_N = (1, 8, 9, 64, 1024, 4000, 20000)
#: a lone request's bucket, a small flush, the cap, explain's two batches
SHAP_TIMED_N = (8, 64, 1024, 4000, 20000)
SHAP_TIES_FROM = 4000  # from here a top-3 row may differ only across a tie
# card vs CPU GBT training run: the card's histograms sum in another order
# than the CPU's, so a split whose two best gains lie within float32
# rounding of each other may go the other way and change the trees after it
GBT_TRAIN_AUC_TOL = 5e-3
#: 6 fits (5 folds + the final fit) x 100 trees x (5 levels + 1 leaf sum)
GBT_HIST_LAUNCHES_PER_RUN = 6 * 100 * 6

#: phase 8: each tool's kernel launches (its counts zeroed just before it):
#: preprocess one SMOTE (one knn_topk); a logistic evaluate or validate_auc
#: one predict_proba (one fused_score at its bucket); a GBT evaluate scores
#: by the forest walk (no kernel of the port); explain one explain_batch
#: (one tree_shap); predict_single's predict and predict_proba one
#: fused_score each; eda none (two scaler fits)
TOOL_LAUNCHES = {
    "preprocess": {"knn_topk": 1},
    "evaluate_logistic": {"fused_score": 1},
    "evaluate_gbt": {},
    "explain_gbt": {"tree_shap": 1},
    "validate_auc": {"fused_score": 1},
    "predict_single": {"fused_score": 2},
    "eda": {},
}
KAGGLE_ROWS, KAGGLE_FRAUDS = 284_807, 492  # the Kaggle file's rows and frauds
TOOL_EXPLAIN_ROWS = 20_000  # explain's max_rows
TOOL_SAMPLED_ROWS = 1024  # rows of the 20,000 held against the CPU plain TreeSHAP
TOOL_ADDITIVITY = 1e-4  # |Σφ + E[f] − f(x)|, f(x) the float64 forest walk

EXPLAIN_REQUESTS = 128  # phase 7: /predict requests whose explanations the worker drains
EXPLAIN_DRAIN_TIMEOUT_S = 300  # worker start-up, warm-up and the drain
EXPLAIN_TIMED_BATCHES = 20  # in-process run_batch(64) calls timed

#: the kernels each path must launch (its counts zeroed just before it)
SERVED_KERNELS = ("fused_score",)
TRAINED_KERNELS = ("knn_topk",)
GBT_TRAINED_KERNELS = ("gbt_hist", "knn_topk")
GBT_SERVED_KERNELS = ("tree_shap",)
#: phase 7: the kernel the worker's batch must launch, by family
EXPLAIN_KERNELS = {"logistic": "fused_score", "gbt": "tree_shap"}
WIRE_NAMES = ("float32", "bfloat16", "int8")  # the h2d wires
RETURN_WIRE_NAMES = ("float32", "float16", "uint8")  # the d2h return wires
#: a narrow return wire's score against the f32 return: half an f16 step
#: below 1, half a uint8 code
RETURN_WIRE_TOL = {"float16": 2.5e-4, "uint8": 0.5 / 255 + 1e-6}
WIRE_GATE_ATOL, WIRE_GATE_MEAN = 5e-2, 1e-2  # JAX's int8-vs-f32 score gate (linear)
WIRE_REQUESTS = 128  # phase 9: /predict a (family, wire) from WIRE_CLIENTS threads
WIRE_CLIENTS = 32
WIRE_SEQUENTIAL = 32  # then one at a time
WIRE_FLUSH_TIMED = 30  # 1024-row flushes timed a (family, wire)
STREAM_CHUNK, STREAM_INFLIGHT = 32768, 8  # predict_proba_stream's defaults
STREAM_ROUNDS = 9  # timed rounds of every stream combination, in turns

#: every ported kernel: name → (route, source, the TPU kernel it replaces)
KERNELS = {
    "fused_score": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/fused_score.cu",
        "fraud_detection_tpu/ops/pallas_kernels.py:113",
    ),
    "knn_topk": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/knn_topk.cu",
        "fraud_detection_tpu/ops/pallas_kernels.py:179",
    ),
    "gbt_hist": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/gbt_hist.cu",
        "fraud_detection_tpu/ops/gbt.py:275",
    ),
    "tree_shap": (
        "cuda",
        "fraud_detection_tpu_torch/csrc/tree_shap.cu",
        "fraud_detection_tpu/ops/pallas_kernels.py:544",
    ),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = TIMED_LAUNCHES, warm: int = 20) -> float:
    """Per-call time from CUDA events around ``iters`` back-to-back eager
    calls, after ``warm`` untimed ones. For a kernel shorter than its
    launch this reads the host's enqueue rate, not the device."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = TIMED_LAUNCHES, replays: int = 5) -> float:
    """Per-call device time: ``iters`` calls captured into one CUDA graph,
    each replay timed with CUDA events (host launch overhead is out of the
    measurement); the median over ``replays`` replays after one warm one."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[replays // 2]


def profiled_intervals(fn) -> list[tuple[str, float, float]]:
    """(name, start µs, end µs) of every device activity ``fn`` ran, from
    ``torch.profiler``; empty when the profiler saw no device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "device_time", None)
            if us is None:
                us = getattr(evt, "cuda_time", 0.0)
            start = float(evt.time_range.start)
            out.append((evt.name, start, start + float(us)))
    return out


def profiled_kernels(fn) -> list[tuple[str, float]]:
    """(name, device µs) of every device activity ``fn`` ran."""
    return [(name, end - start) for name, start, end in profiled_intervals(fn)]


def union_us(intervals) -> float:
    """The time covered by (start, end) intervals: device activities that
    overlap (a programmatic dependent launch) count once."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def check_ptxas_resources(kernels, name: str) -> None:
    """ptxas's registers, stack frame and spills for every instantiation of
    a kernel's entry functions; a spill or a stack frame fails the phase.
    The log is the build's own, or a rebuild's when the library was already
    there."""
    log = kernels.BUILD_LOGS.get(name)
    if log is None:
        _, log = kernels.build_library(kernels.CSRC_DIR / f"{name}.cu",
                                       f"{name}_resources", {})
    usage = [u for u in kernels.ptxas_usage(log) if name in u["function"]]
    if not usage:
        raise AssertionError(f"ptxas reported no {name} kernel")
    for u in usage:
        short = re.sub(rf"^_ZN\w*?_GLOBAL__N__\w+?_{name}_cu_\w+?\d+({name})", r"\1",
                       u["function"])
        print(f"phase1: ptxas {name} {short}: {u.get('registers')} registers, "
              f"{u.get('stack')} bytes stack frame, {u.get('spill_stores')} bytes spill "
              f"stores, {u.get('spill_loads')} bytes spill loads")
        if u.get("stack") or u.get("spill_stores") or u.get("spill_loads"):
            raise AssertionError(f"{name} instantiation {short} spills or has a stack frame")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def fused_score_fixtures(seed: int) -> list[tuple[str, object, object, object]]:
    """(label, x, w, b) on the card for phase 2, all from one seed: a lone
    request's bucket and the ladder's, the committed dataset's 20,000 rows
    and its padded bucket, the Kaggle file's 284,807, n < 32 and n = 33 past
    a warp, widths that are not a multiple of 32 (one past the tiles' 64),
    and contiguous views whose base is not 16-byte aligned — ``x[1:]`` (one
    row in) and a flat buffer one element (4 bytes) in — at d = 30 and 37,
    on each side of the kernel's switch to tiles."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    b = torch.tensor(-0.5, dtype=torch.float32, device=dev)

    def coef(d):
        return torch.from_numpy((rng.standard_normal(d) / math.sqrt(d)).astype(np.float32)).to(dev)

    out = []
    for n, d in FUSED_SCORE_SHAPES:
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        out.append((f"n={n} d={d}", x, coef(d), b))
    for d, n in ((d, n) for d in (30, 37) for n in FUSED_SCORE_VIEW_N):
        buf = torch.from_numpy(rng.standard_normal((n + 1) * d + 1, dtype=np.float32)).to(dev)
        w = coef(d)
        out.append((f"x[1:] n={n} d={d}", buf[: (n + 1) * d].view(n + 1, d)[1:], w, b))
        out.append((f"flat[1:] n={n} d={d}", buf[1 : 1 + n * d].view(n, d), w, b))
    return out


def fused_score_bound(n: int, d: int, elem_bytes: int = 4) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, operations): x read once at
    ``elem_bytes`` an element, w and b read once, one f32 score written;
    a multiply-add an element, then bias, exp, add and divide a row."""
    n_bytes = elem_bytes * n * d + 4 * d + 4 + 4 * n
    n_ops = 2 * n * d + 4 * n
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, n_ops


LAUNCH_FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void launch_floor_kernel() {}
extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def launch_floor_fn():
    """A one-thread empty kernel built with the port's nvcc flags, as a
    callable on the current stream: the launch floor of this timing
    harness."""
    import ctypes

    import torch

    from fraud_detection_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "launch_floor.cu"
    src.write_text(LAUNCH_FLOOR_SOURCE)
    lib, _ = kernels.build_library(
        src, "launch_floor", {"launch_floor": ([ctypes.c_void_p], ctypes.c_int)})

    def call():
        if lib.launch_floor(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the empty kernel did not launch")

    return call


def check_fused_score(seed: int) -> dict:
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    worst = 0.0
    inputs = {}
    for label, x, w, b in fused_score_fixtures(seed):
        n, d = x.shape
        got = kernels.fused_score(w, b, x)
        want = kernels.fused_score_reference(w, b, x)
        # bf16 rows: bitwise the f32 path on the same values, and the plain
        # version on the bf16 rows
        xb = x.bfloat16()
        got_b = kernels.fused_score(w, b, xb)
        via_f32 = kernels.fused_score(w, b, xb.float())
        want_b = kernels.fused_score_reference(w, b, xb)
        torch.cuda.synchronize()
        for out in (got, got_b):
            if out.shape != (n,) or out.dtype != torch.float32 or not torch.isfinite(out).all():
                raise AssertionError(f"fused_score {label}: bad output {out.shape} {out.dtype}")
        err = float((got - want).abs().max())
        err_b = float((got_b - want_b).abs().max())
        bits = int((got_b.view(torch.int32) != via_f32.view(torch.int32)).sum())
        print(f"phase2: fused_score {label} max_abs_err={err:.3e}; bf16 rows "
              f"max_abs_err={err_b:.3e}, {bits} of {n} scores differ in bits from the "
              f"f32 kernel on x.float()")
        if max(err, err_b) > KERNEL_TOL:
            raise AssertionError(
                f"fused_score {label} differs from its plain version by "
                f"{max(err, err_b):.3e} > {KERNEL_TOL}"
            )
        if bits:
            raise AssertionError(f"fused_score {label}: bf16 rows are not bitwise the f32 path")
        worst = max(worst, err, err_b)
        if label == f"n={n} d=30" and n in FUSED_SCORE_TIMED_N:
            inputs[n] = (x, w, b)
        del got, want, xb, got_b, via_f32, want_b

    floor_fn = launch_floor_fn()
    floor = graph_ms(floor_fn)
    print(f"phase2: launch floor (a one-thread empty kernel, same flags, CUDA events over "
          f"{TIMED_LAUNCHES} launches replayed from a CUDA graph): {floor:.6f} ms")
    rows = {}
    timed = [(n, "float32") for n in FUSED_SCORE_TIMED_N]
    timed += [(n, "bfloat16") for n in FUSED_SCORE_BF16_TIMED_N]
    for n, dtype in timed:
        x, w, b = inputs[n]
        d = x.shape[1]
        if dtype == "bfloat16":
            x = x.bfloat16()
        kernel_fn = lambda: kernels.fused_score(w, b, x)  # noqa: E731
        plain_fn = lambda: kernels.fused_score_reference(w, b, x)  # noqa: E731
        # one PyTorch call for f32 rows; bf16 rows need the upcast first
        library_fn = lambda: torch.sigmoid(torch.addmv(b, x.float(), w))  # noqa: E731
        ms, plain, library = (graph_ms(f) for f in (kernel_fn, plain_fn, library_fn))
        eager = [eager_ms(f) for f in (kernel_fn, plain_fn, library_fn)]
        bound, by, n_bytes, n_ops = fused_score_bound(n, d, x.element_size())
        prof = [
            us for name, us in profiled_kernels(
                lambda: [kernels.fused_score(w, b, x) for _ in range(20)]
            ) if "fused_score" in name
        ]
        dev_us = f"{sum(prof) / len(prof):.3f}" if prof else "not measured"
        rows[(n, dtype)] = {
            "ms": ms, "plain_ms": plain, "library_ms": library if dtype == "float32" else None,
            "bound_ms": bound, "bound_by": by, "launch_floor_ms": floor,
        }
        print(
            f"phase2: fused_score timing n={n} d={d} {dtype} (CUDA events over "
            f"{TIMED_LAUNCHES} launches replayed from a CUDA graph): kernel "
            f"{ms:.6f} ms, launch floor {floor:.6f} ms, plain {plain:.6f} ms, "
            f"{'library sigmoid(addmv)' if dtype == 'float32' else 'sigmoid(addmv(x.float()))'} "
            f"{library:.6f} ms, bound {bound:.6f} ms ({by}: {n_bytes} B, {n_ops} ops); "
            f"kernel device time {dev_us} us (profiler); eager calls (CUDA events, "
            f"host-bound): kernel {eager[0]:.6f} ms, plain {eager[1]:.6f} ms, "
            f"library {eager[2]:.6f} ms"
        )
    rows[(1024, "int8")] = fused_score_on_codes(floor)
    worst = max(worst, rows[(1024, "int8")]["max_abs_err"])
    return {"max_abs_err": worst, "timing": rows, "launch_floor_ms": floor}


def fused_score_on_codes(floor: float, n: int = 1024, d: int = 30) -> dict:
    """The int8 wire's linear score at the flush cap: int8 codes upcast by
    ``codes.float()`` (exact) into the kernel with the dequant-folded
    weights. Times the upcast launch, the kernel on the upcast rows, the
    two together, the plain version, and ``sigmoid(addmv(codes.float()))``
    as the library column; the bound counts int8 rows read once."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8)).to(dev)
    w = torch.from_numpy((rng.standard_normal(d) * 0.01).astype(np.float32)).to(dev)
    b = torch.tensor(-0.5, dtype=torch.float32, device=dev)
    xf = codes.float()
    got = kernels.fused_score(w, b, codes.float())
    want = kernels.fused_score_reference(w, b, codes)
    err = float((got - want).abs().max())
    upcast = graph_ms(lambda: codes.float())
    kernel = graph_ms(lambda: kernels.fused_score(w, b, xf))
    both = graph_ms(lambda: kernels.fused_score(w, b, codes.float()))
    plain = graph_ms(lambda: kernels.fused_score_reference(w, b, codes))
    library = graph_ms(lambda: torch.sigmoid(torch.addmv(b, codes.float(), w)))
    bound, by, n_bytes, n_ops = fused_score_bound(n, d, 1)
    print(f"phase2: fused_score on int8 codes n={n} d={d} (CUDA events over {TIMED_LAUNCHES} "
          f"launches replayed from a CUDA graph): max_abs_err={err:.3e}; upcast codes.float() "
          f"{upcast:.6f} ms, kernel on the upcast rows {kernel:.6f} ms, the two {both:.6f} ms, "
          f"launch floor {floor:.6f} ms, plain {plain:.6f} ms, library "
          f"sigmoid(addmv(codes.float())) {library:.6f} ms, bound {bound:.6f} ms ({by}: "
          f"{n_bytes} B, {n_ops} ops)")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"fused_score on upcast codes differs from its plain version "
                             f"by {err:.3e}")
    return {"ms": both, "kernel_ms": kernel, "upcast_ms": upcast, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": by, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 2b: knn_topk against its plain version
# ---------------------------------------------------------------------------


def knn_fixtures(seed: int) -> list[tuple[str, object, int]]:
    """(label, rows (m, d) float32, k) for phase 2b, all from one seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for m, d, k in [(2, 30, 1), (6, 30, 5), (126, 30, 5), (158, 30, 5),
                    (394, 30, 5), (1000, 37, 5), (4096, 30, 5), (20000, 30, 5),
                    (20000, 37, 5), (20000, 64, 5), (20000, 128, 5), (100000, 30, 5)]:
        out.append((f"m={m} d={d} k={k}", rng.standard_normal((m, d), dtype=np.float32), k))
    base = rng.standard_normal((40, 30), dtype=np.float32)
    out.append(("duplicated rows (109 = 40 x 2 + 29)",
                np.concatenate([base, base, base[:29]]), 5))
    half = rng.integers(-3, 4, (150, 30))
    out.append(("lattice (300 integer points, closed under x -> -x)",
                np.concatenate([half, -half]).astype(np.float32), 5))
    return out


def knn_inputs(x):
    """Centred rows and their |x|^2 on the card, as ops/smote.py makes them."""
    import torch

    xt = torch.from_numpy(x).cuda()
    xc = (xt - xt.mean(dim=0)).contiguous()
    return xc, (xc * xc).sum(dim=1)


def knn_selection_gap(xc, queries, got, want) -> tuple[int, float, float]:
    """(mismatched rows, max |d64(kernel pick) − d64(plain pick)| over all
    rows and slots, max relative gap over the mismatched rows), the
    distances recomputed in float64 from the centred rows."""
    import torch

    x64 = xc.double()
    q = x64[queries]
    dg = ((x64[got.long()] - q[:, None, :]) ** 2).sum(-1)
    dw = ((x64[want.long()] - q[:, None, :]) ** 2).sum(-1)
    gap = (dg - dw).abs()
    bad = (got != want).any(dim=1)
    rel = (gap / dw.abs().clamp_min(1e-30))[bad]
    return int(bad.sum()), float(gap.max()), float(rel.max()) if rel.numel() else 0.0


def knn_bound(m: int, d: int, k: int) -> tuple[float, str, int, int]:
    # a dot per unordered pair (fmaf's product is the same bits either way
    # round), then the combine and compare per ordered pair
    n_ops = m * (m - 1) * d + 3 * m * m
    n_bytes = 4 * (m * d + m + m * k)  # xc, sq read once; indices written
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), n_ops, n_bytes


def check_knn_topk(seed: int) -> dict:
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    worst = 0.0
    inputs = {}
    for label, x, k in knn_fixtures(seed):
        m = x.shape[0]
        xc, sq = knn_inputs(x)
        got = kernels.knn_topk(xc, sq, k)
        torch.cuda.synchronize()
        if got.shape != (m, k) or got.dtype != torch.int32:
            raise AssertionError(f"knn_topk {label}: bad output {got.shape} {got.dtype}")
        if m >= KNN_SAMPLED_FROM:
            g = torch.Generator().manual_seed(seed)
            rows = torch.randperm(m, generator=g)[:KNN_SAMPLE_ROWS].sort().values.to(xc.device)
        else:
            rows = torch.arange(m, device=xc.device)
        want = kernels.knn_topk_reference(xc, sq, k, rows=rows)
        mism, gap, rel = knn_selection_gap(xc, rows, got[rows], want)
        print(
            f"phase2b: knn_topk {label}: {mism} of {rows.numel()} checked rows "
            f"mismatched (max |d64 kernel pick - d64 plain pick| {gap:.3e}, "
            f"max relative gap of a mismatched row {rel:.3e})"
        )
        if m < KNN_SAMPLED_FROM and mism:
            raise AssertionError(f"knn_topk {label}: {mism} rows differ from the plain version")
        if rel > KNN_NEAR_TIE_RTOL:
            raise AssertionError(
                f"knn_topk {label}: a mismatched row is no near-tie "
                f"(relative gap {rel:.3e} > {KNN_NEAR_TIE_RTOL})"
            )
        worst = max(worst, gap)
        if (m, x.shape[1]) in KNN_TIMED and k == 5 and label.startswith("m="):
            inputs[m, x.shape[1]] = (xc, sq, k)
        else:
            del xc, sq, got, want

    rows = {}
    for m, d in KNN_TIMED:
        xc, sq, k = inputs.pop((m, d))
        plan = kernels.knn_topk_plan(m, d, k, xc.device)
        kernel_fn = lambda: kernels.knn_topk(xc, sq, k)  # noqa: E731
        plain_fn = lambda: kernels.knn_topk_reference(xc, sq, k)  # noqa: E731
        big = m >= KNN_SAMPLED_FROM
        ms = graph_ms(kernel_fn, iters=3 if big else TIMED_LAUNCHES,
                      replays=3 if big else 5)
        eager = eager_ms(kernel_fn, iters=3 if big else TIMED_LAUNCHES,
                         warm=1 if big else 20)
        plain = eager_ms(plain_fn, iters=1 if big else 50, warm=1 if big else 5)
        torch.cuda.empty_cache()
        orient_fn = lambda: torch.topk(  # noqa: E731
            torch.cdist(xc, xc), k + 1, largest=False
        )
        orient = eager_ms(orient_fn, iters=2 if big else 50, warm=1 if big else 5)
        torch.cuda.empty_cache()
        bound, by, n_ops, n_bytes = knn_bound(m, d, k)
        rows[m, d] = {"ms": ms, "plain_ms": plain, "orientation_ms": orient,
                      "bound_ms": bound, "bound_by": by, "eager_ms": eager, "plan": plan}
        print(
            f"phase2b: knn_topk grid m={m} d={d}: {plan['query_tiles']} query tiles x "
            f"{plan['splits']} key splits of {plan['keys_per_split']} keys, "
            f"{plan['tile']}-key tiles"
            + (", a merging second launch" if plan["splits"] > 1 else ", one launch")
        )
        print(
            f"phase2b: knn_topk timing m={m} d={d} k={k}: kernel {ms:.6f} ms "
            f"(CUDA events over launches replayed from a CUDA graph; eager "
            f"through the wrapper {eager:.6f} ms), plain {plain:.6f} ms "
            f"(eager, CUDA events), bound {bound:.6f} ms ({by}: {n_ops} ops, "
            f"{n_bytes} B); orientation only, two calls "
            f"topk(cdist(xc, xc), k+1): {orient:.6f} ms"
        )
    del inputs
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "timing": rows}


# ---------------------------------------------------------------------------
# phase 2c: gbt_hist against its plain version
# ---------------------------------------------------------------------------


def hist_inputs(rng, n: int, d: int, n_nodes: int, n_bins: int, dev, zero_every: int = 5):
    """Bins, node, g and h on the card as a level of the fit sees them:
    g = p − y, h = p(1 − p) from random margins; every ``zero_every``-th row
    has zero weight and every 11th lies outside the level (inert)."""
    import numpy as np
    import torch

    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(n)))
    yv = (rng.random(n) < 0.5).astype(np.float64)
    g = (p - yv).astype(np.float32)
    h = (p * (1.0 - p)).astype(np.float32)
    g[::zero_every] = 0.0
    h[::zero_every] = 0.0
    local = rng.integers(0, n_nodes, n).astype(np.int32)
    local[::11] = -1
    bins = rng.integers(0, n_bins, (n, d)).astype(np.uint8)
    return tuple(torch.from_numpy(a).to(dev) for a in (bins, local, g, h))


def hist_float64(bins, local, g, h, n_nodes: int, n_bins: int):
    """(float64 sum, float64 Σ|value|) per cell, (d, n_nodes, n_bins, 2)."""
    import torch

    n, d = bins.shape
    keep = (local >= 0)
    seg = ((local.long()[:, None] * n_bins + bins.long())
           + torch.arange(d, device=bins.device)[None, :] * (n_nodes * n_bins))[keep].reshape(-1)
    gh = torch.stack([g, h], 1).double()[keep][:, None, :].expand(-1, d, 2).reshape(-1, 2)
    out = torch.zeros((d * n_nodes * n_bins, 2), dtype=torch.float64, device=bins.device)
    absum = torch.zeros_like(out)
    out.index_add_(0, seg, gh)
    absum.index_add_(0, seg, gh.abs())
    shape = (d, n_nodes, n_bins, 2)
    return out.reshape(shape), absum.reshape(shape)


def hist_bound(n: int, d: int, n_nodes: int, n_bins: int) -> tuple[float, str, int, int]:
    n_bytes = n * d + 12 * n + 8 * d * n_nodes * n_bins  # bins, node/g/h; out
    n_ops = 2 * n * d  # one add of g and one of h per (row, feature)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, n_ops


def check_gbt_hist(seed: int) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    # (label, n, d, n_nodes, n_bins): the final fit's 31,684 rows at every
    # level of the recipe, a fold's odd row count, a 16-bin model, and the
    # leaf sums (one uint8 column of leaf ids, one node, 32 bins) at the
    # final fit's and a fold's row count
    cases = [(f"n=31684 d=30 nodes={nn} bins=256", 31684, 30, nn, 256)
             for nn in (1, 2, 4, 8, 16)]
    cases += [("odd n=25351 d=30 nodes=16 bins=256", 25351, 30, 16, 256),
              ("16 bins n=4099 d=30 nodes=1", 4099, 30, 1, 16),
              ("leaf sums n=31684 d=1 nodes=1 bins=32", 31684, 1, 1, 32),
              ("leaf sums n=25351 d=1 nodes=1 bins=32", 25351, 1, 1, 32)]
    # and the leaf sums with one leaf whose rows all carry the fit's floor
    # h = 1e-16 (its H must come out > 0)
    cases.append(("floored-h leaf sums n=31684 d=1 nodes=1 bins=32", 31684, 1, 1, 32))
    worst = 0.0
    timed = {}
    for label, n, d, nn, nb in cases:
        args = hist_inputs(rng, n, d, nn, nb, dev)
        floored = label.startswith("floored")
        if floored:
            args[3][args[0][:, 0] == 0] = 1e-16
        a, quanta = kernels.gbt_hist_and_quanta(*args, nn, nb)
        b = kernels.gbt_hist(*args, nn, nb)
        plain = kernels.gbt_hist_reference(*args, nn, nb)
        model, model_q = kernels.gbt_hist_fixed_point_reference(*args, nn, nb)
        want, absum = hist_float64(*args, nn, nb)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"gbt_hist {label}: two launches differ")
        if a.shape != (d, nn, nb, 2) or not torch.isfinite(a).all():
            raise AssertionError(f"gbt_hist {label}: bad output {tuple(a.shape)}")
        quanta = tuple(quanta.cpu().tolist())
        if quanta != model_q or not torch.equal(a, model):
            raise AssertionError(f"gbt_hist {label}: not bitwise its fixed-point model "
                                 f"(quanta {quanta} vs {model_q})")
        rel = (a.double() - want).abs() / absum.clamp_min(1e-300)
        rel_p = (plain.double() - want).abs() / absum.clamp_min(1e-300)
        empty = absum == 0
        if bool((a[empty] != 0).any()):
            raise AssertionError(f"gbt_hist {label}: an empty cell is not 0")
        err = float((a - plain).abs().max())
        cpu_plain = kernels.gbt_hist_reference(*(t.cpu() for t in args), nn, nb)
        extra = f"; plain on the card bitwise the CPU's: {torch.equal(plain.cpu(), cpu_plain)}"
        if floored:
            # a floored row rounds up to one quantum (q > 1e-16 here): the
            # floored leaf's H is held to its fixed-point bound, rows · q
            rows_0 = int((args[0][:, 0] == 0).sum())
            h0 = float(a[0, 0, 0, 1])
            if not (h0 > 0.0 and abs(h0 - float(want[0, 0, 0, 1])) <= rows_0 * quanta[1]):
                raise AssertionError(f"gbt_hist {label}: floored leaf H {h0} "
                                     f"({rows_0} rows, q {quanta[1]})")
            extra += f"; floored leaf H {h0:.6e} > 0 ({rows_0} rows at h=1e-16)"
            rel, rel_p = rel[0, 0, 1:], rel_p[0, 0, 1:]
        rel_k, rel_p = float(rel.max()), float(rel_p.max())
        print(f"phase2c: gbt_hist {label}: bitwise equal over two launches and to "
              f"its fixed-point model (quanta g {quanta[0]:.6e}, h {quanta[1]:.6e}); "
              f"max |cell - f64|/sum|v| kernel {rel_k:.3e}, plain {rel_p:.3e}; "
              f"max |kernel - plain| {err:.3e}{extra}")
        # the floored case gates the kernel; the plain version's float32
        # row-order sums are gated on every other case
        if rel_k > HIST_REL_TOL or (rel_p > HIST_REL_TOL and not floored):
            raise AssertionError(
                f"gbt_hist {label}: off its float64 sum by more than "
                f"{HIST_REL_TOL} of sum|v| (kernel {rel_k:.3e}, plain {rel_p:.3e})"
            )
        worst = max(worst, err)
        if n == 31684 and not floored:
            timed[nn if d == 30 else "leaf"] = args
    zero = hist_inputs(rng, 1000, 30, 4, 256, dev, zero_every=1)
    if bool(kernels.gbt_hist(*zero, 4, 256).any()):
        raise AssertionError("gbt_hist: all-zero weight rows gave a nonzero cell")
    print("phase2c: gbt_hist all-zero weight rows (n=1000): every cell 0")

    rows = {}
    for key, args in timed.items():
        bins, local, g, h = args
        n, d = bins.shape
        nn, nb = (1, 32) if key == "leaf" else (key, 256)
        flat = ((local.long()[:, None] * nb + bins.long())
                + torch.arange(d, device=dev)[None, :] * (nn * nb))
        keep = (local >= 0)[:, None].expand(-1, d)
        idx = torch.stack([flat * 2, flat * 2 + 1], -1)[keep].reshape(-1)
        vals = torch.stack([g, h], 1)[:, None, :].expand(-1, d, 2)[keep].reshape(-1)
        kernel_fn = lambda: kernels.gbt_hist(bins, local, g, h, nn, nb)  # noqa: E731
        plain_fn = lambda: kernels.gbt_hist_reference(bins, local, g, h, nn, nb)  # noqa: E731
        library_fn = lambda: torch.zeros(  # noqa: E731
            d * nn * nb * 2, device=dev).index_put_((idx,), vals, accumulate=True)
        ms = graph_ms(kernel_fn)
        eager = eager_ms(kernel_fn)
        plain = eager_ms(plain_fn, iters=50, warm=5)
        library = eager_ms(library_fn, iters=50, warm=5)
        bound, by, n_bytes, n_ops = hist_bound(n, d, nn, nb)
        rows[key] = {"ms": ms, "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound, "bound_by": by, "eager_ms": eager}
        print(f"phase2c: gbt_hist timing n={n} d={d} nodes={nn} bins={nb}: kernel "
              f"{ms:.6f} ms (CUDA events over launches replayed from a CUDA graph; "
              f"eager through the wrapper {eager:.6f} ms), plain {plain:.6f} ms "
              f"(eager), library index_put_(accumulate=True) on precomputed cell "
              f"ids {library:.6f} ms (eager), bound {bound:.6f} ms ({by}: "
              f"{n_bytes} B, {n_ops} ops)")
    # a tree launches each of the six shapes once (5 levels + the leaf sums),
    # so over 100 trees the launch-weighted mean is the plain mean of six
    mean = {k: sum(r[k] for r in rows.values()) / len(rows)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    print(f"phase2c: gbt_hist launch-weighted mean per call over one tree of the "
          f"final fit (100 trees x {len(rows)} shapes): kernel {mean['ms']:.6f} ms, "
          f"plain {mean['plain_ms']:.6f} ms, library {mean['library_ms']:.6f} ms, "
          f"bound {mean['bound_ms']:.6f} ms")
    return {"max_abs_err": worst, "timing": rows, "mean": mean}


# ---------------------------------------------------------------------------
# phase 2d: tree_shap against its plain version
# ---------------------------------------------------------------------------


def synthetic_forest(rng, trees: int, depth: int, d: int, n_bins: int, dev,
                     one_feature: bool = False):
    """A forest at the recipe's shapes with random splits (or every node on
    feature 0), leaf values and sorted edges, on the card."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops.gbt import GBTModel

    nodes = 2**depth - 1
    sf = (np.zeros((trees, nodes)) if one_feature
          else rng.integers(0, d, (trees, nodes))).astype(np.int32)
    return GBTModel(
        split_feature=torch.from_numpy(sf),
        split_bin=torch.from_numpy(rng.integers(0, n_bins - 1, (trees, nodes)).astype(np.int32)),
        leaf_value=torch.from_numpy((0.1 * rng.standard_normal((trees, 2**depth))).astype(np.float32)),
        bin_edges=torch.from_numpy(np.sort(rng.standard_normal((d, n_bins - 1)), axis=1).astype(np.float32)),
        base_logit=torch.tensor(-1.0),
    ).to(dev)


def path_tables(tables):
    """Each leaf's ancestors' split feature and bin, (T, L, D) int64."""
    import torch

    from fraud_detection_tpu_torch.ops.tree_shap import _tree_static

    D = tables.leaf_sums.shape[2]
    anc = torch.as_tensor(_tree_static(D)[0], device=tables.split_feature.device).long()
    return tables.split_feature.long()[:, anc], tables.split_bin.long()[:, anc]


def shap_work(tables, binned) -> tuple[int, int]:
    """(operations, bytes) this run's data needs in compact form: per (row,
    tree) L·D compares and L·D adds (each leaf's level values summed to
    its nodes, the nodes to their features); the tables read once, of
    ``leaf_sums`` only the (tree, leaf, pattern) entries this run's rows
    hit, the bins read and φ written once."""
    import torch

    n, d = binned.shape
    T, L, D, _ = tables.leaf_sums.shape
    dev = binned.device
    path_feat, path_thr = path_tables(tables)
    want = (torch.arange(L, device=dev)[:, None] >> (D - 1 - torch.arange(D, device=dev))[None, :]) & 1
    touched = 0
    for t in range(T):
        right = (binned.long()[:, path_feat[t]] > path_thr[t]).long()
        viol = ((right != want).long() << torch.arange(D, device=dev)).sum(-1)  # (n, L)
        touched += int(torch.unique(viol * L + torch.arange(L, device=dev)).numel())
    n_ops = 2 * n * T * L * D
    n_bytes = 4 * (touched * D + sum(int(getattr(tables, k).numel()) for k in (
        "node_key", "group_order", "group_start", "group_count"))) + 4 * n * d * 2
    return n_ops, n_bytes


def dense_shap_form(tables, mask_bits, coef, d: int):
    """The TPU kernel's dense three-product form as matrices: the signed
    one-hot gather (T, d, L·D) with its bias, the block-diagonal subset
    matrix (T, L·D, M·L), and the dense coefficients (T, M·L, d), from the
    Shapley coefficients ``mask_bits`` (T, M, L) and ``coef`` (T, M, D, L).
    Used only to time torch.matmul beside the kernel."""
    import torch

    T, L, D, _ = tables.leaf_sums.shape
    M = L
    dev = coef.device
    path_feat, path_thr = path_tables(tables)
    sgn = (2.0 * ((torch.arange(L, device=dev)[:, None]
                   >> (D - 1 - torch.arange(D, device=dev))[None, :]) & 1) - 1.0).reshape(-1)
    onehot = (path_feat.reshape(T, -1, 1)
              == torch.arange(d, device=dev)[None, None, :]).float()  # (T, LD, d)
    gmat = (onehot * sgn[None, :, None]).transpose(1, 2).contiguous()  # (T, d, LD)
    bias = sgn[None, :] * (path_thr.reshape(T, -1).float() + 0.5)  # (T, LD)
    bits = ((mask_bits[:, :, :, None] >> torch.arange(D, device=dev)) & 1).float()
    bfull = torch.zeros((T, L * D, M * L), device=dev)
    for l in range(L):
        bfull[:, l * D:(l + 1) * D, l::L] = bits[:, :, l, :].transpose(1, 2)
    cmat = torch.einsum("tmkl,tlkj->tmlj", coef, onehot.reshape(T, L, D, d))
    return gmat, bias, bfull, cmat.reshape(T, M * L, d).contiguous()


def check_tree_shap(seed: int) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.ops.gbt import bin_features, bin_features_host, gbt_predict_logits
    from fraud_detection_tpu_torch.ops.linear_shap import topk_reasons
    from fraud_detection_tpu_torch.ops.tree_shap import _shapley_coefficients, build_tree_explainer

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    d = 30
    cases = [("recipe (100 trees, depth 5)", 100, 5, False, SHAP_CHECKED_N),
             ("depth 2, 16 trees", 16, 2, False, (33,)),
             ("depth 3, 16 trees", 16, 3, False, (33,)),
             ("duplicate feature (every node on feature 0), depth 3", 4, 3, True, (9,))]
    worst = 0.0
    timed = {}
    for label, trees, depth, one, sizes in cases:
        model = synthetic_forest(rng, trees, depth, d, 256, dev, one_feature=one)
        e = build_tree_explainer(model, rng.standard_normal((128, d)).astype(np.float32))
        for n in sizes:
            x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
            binned = bin_features(x, model.bin_edges)
            got = kernels.tree_shap(binned, e.tables)
            want = kernels.tree_shap_reference(binned, model.split_feature, model.split_bin,
                                               model.leaf_value, e.bg_table)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            over = float(((got - want).abs() - SHAP_RTOL * want.abs()).max())
            k = 3
            differ = (topk_reasons(got, k)[0] != topk_reasons(want, k)[0]).any(dim=1)
            srt = want.sort(dim=1, descending=True).values
            tie = (srt[:, k - 1] - srt[:, k]).abs() <= SHAP_TIE
            # below SHAP_TIES_FROM rows every row's top-k must be equal; from
            # there a row may differ only across a k-th/(k+1)-th near-tie
            same_topk = (not bool(differ.any()) if n < SHAP_TIES_FROM
                         else bool((~differ | tie).all()))
            add = float((got.sum(1) + e.expected_value - gbt_predict_logits(model, x)).abs().max())
            print(f"phase2d: tree_shap {label} n={n}: max |kernel - plain| {err:.3e}, "
                  f"top-{k} indices equal {same_topk} ({int(differ.sum())} rows differ "
                  f"across a tie within {SHAP_TIE}), additivity max |sum phi + E[f] "
                  f"- f(x)| {add:.3e}")
            if over > SHAP_ATOL or not same_topk or not torch.isfinite(got).all():
                raise AssertionError(f"tree_shap {label} n={n}: off its plain version")
            if add > 1e-4 + 1e-3 * float(want.abs().sum(1).max()):
                raise AssertionError(f"tree_shap {label} n={n}: not additive ({add:.3e})")
            if one and bool((got[:, 1:] != 0).any()):
                raise AssertionError("tree_shap: attribution off feature 0")
            worst = max(worst, err)
            if trees == 100 and n in SHAP_TIMED_N:
                timed[n] = (model, e, binned)

    # NaN/±inf binning on the card against the host's numpy binning
    edges = np.sort(rng.standard_normal((d, 255)), axis=1).astype(np.float32)
    xb = rng.standard_normal((64, d)).astype(np.float32)
    xb[::3, 0], xb[1::3, 1], xb[2::3, 2] = np.nan, np.inf, -np.inf
    xb[5, 7] = edges[7, 100]
    on_card = bin_features(torch.from_numpy(xb).to(dev), torch.from_numpy(edges).to(dev))
    host = bin_features_host(xb, edges, 256).astype(np.int32)
    if not np.array_equal(on_card.cpu().numpy(), host) or int(host[0, 0]) != 255:
        raise AssertionError("bin_features on the card differs from the host on NaN/inf")
    print("phase2d: bin_features on the card equals the host's numpy binning on a "
          "NaN/+inf/-inf fixture (NaN -> bin 255)")

    rows = {}
    for n in SHAP_TIMED_N:
        model, e, binned = timed[n]
        kernel_fn = lambda: kernels.tree_shap(binned, e.tables)  # noqa: E731
        plain_fn = lambda: kernels.tree_shap_reference(  # noqa: E731
            binned, model.split_feature, model.split_bin, model.leaf_value, e.bg_table)
        ms = graph_ms(kernel_fn, iters=50)
        eager = eager_ms(kernel_fn, iters=50)
        big = n >= SHAP_TIES_FROM  # the plain version takes seconds a call
        plain = eager_ms(plain_fn, iters=1 if big else 3, warm=1)
        n_ops, n_bytes = shap_work(e.tables, binned)
        t_ops = n_ops / F32_FLOPS_PER_S * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        rows[n] = {"ms": ms, "plain_ms": plain, "eager_ms": eager,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"phase2d: tree_shap timing n={n} (100 trees, depth 5, d=30): kernel "
              f"{ms:.6f} ms (CUDA events over launches replayed from a CUDA graph; "
              f"eager through the wrapper {eager:.6f} ms), plain {plain:.6f} ms (eager), "
              f"bound {rows[n]['bound_ms']:.6f} ms ({rows[n]['bound_by']}: {n_ops} ops in "
              f"compact form, {n_bytes} B of tables this run's rows touch)")

    # orientation only: the TPU kernel's dense three-product form at 1024
    model, e, binned = timed[1024]
    gmat, bias, bfull, cmat = dense_shap_form(
        e.tables, *_shapley_coefficients(model, e.bg_table), binned.shape[1])
    bf = binned.float()

    def dense_fn():
        notc = (torch.matmul(bf, gmat) <= bias[:, None, :]).float()  # (T, n, LD)
        ind = (torch.matmul(notc, bfull) == 0).float()  # (T, n, ML)
        return torch.matmul(ind, cmat).sum(dim=0)

    orient = eager_ms(dense_fn, iters=5, warm=2)
    dense_err = float((dense_fn() - kernels.tree_shap(binned, e.tables)).abs().max())
    del gmat, bfull, cmat
    torch.cuda.empty_cache()
    rows[1024]["orientation_ms"] = orient
    print(f"phase2d: tree_shap orientation only, the dense three-product form as "
          f"torch.matmul (TF32 off) at n=1024: {orient:.6f} ms (max |dense - kernel| "
          f"{dense_err:.3e})")
    return {"max_abs_err": worst, "timing": rows}


# ---------------------------------------------------------------------------
# phase 3: the served path
# ---------------------------------------------------------------------------


class ServerThread(threading.Thread):
    """The port's app on its stdlib HTTP server, in its own event loop."""

    def __init__(self, app, port: int):
        super().__init__(name="chip-smoke-server", daemon=True)
        self.app = app
        self.port = port
        self.ready = threading.Event()
        self.error: BaseException | None = None
        self.loop: asyncio.AbstractEventLoop | None = None

    def run(self) -> None:
        from fraud_detection_tpu_torch.service.http import start_server

        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)
        try:
            server = self.loop.run_until_complete(
                start_server(self.app, "127.0.0.1", self.port)
            )
        except BaseException as e:  # reported to the main thread
            self.error = e
            self.ready.set()
            return
        self.ready.set()
        try:
            self.loop.run_forever()
        finally:
            server.close()
            self.loop.run_until_complete(server.wait_closed())
            self.loop.run_until_complete(self.app.shutdown())
            self.loop.close()

    def stop(self) -> None:
        if self.loop is not None and self.is_alive():
            self.loop.call_soon_threadsafe(self.loop.stop)
        self.join(timeout=60)
        if self.is_alive():
            raise RuntimeError("server thread did not stop")


#: the HTTP client, run as its own process so that its threads do not share
#: the server's interpreter: POSTs ``rows`` (a .npy file) to /predict from
#: ``clients`` threads; prints one JSON object of (status, body, seconds)
#: per row in row order, and the wall time
CLIENT = r"""
import http.client, json, sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np

port, rows, clients = int(sys.argv[1]), np.load(sys.argv[2]), int(sys.argv[3])

def one(i):
    t = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/predict", body=json.dumps({"features": rows[i].tolist()}),
                     headers={"content-type": "application/json", "connection": "close"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode(), time.perf_counter() - t
    finally:
        conn.close()

t0 = time.perf_counter()
with ThreadPoolExecutor(max_workers=clients) as pool:
    results = list(pool.map(one, range(len(rows))))
print(json.dumps({"wall": time.perf_counter() - t0, "results": results}))
"""


def drive_clients(port: int, rows, clients: int, work: Path) -> tuple[list, float]:
    """Send ``rows`` to /predict from a client process; returns the
    per-row (status, body, seconds) and the wall time."""
    import numpy as np

    path = work / f"rows_{clients}.npy"
    np.save(path, rows)
    out = subprocess.run(
        [sys.executable, "-c", CLIENT, str(port), str(path), str(clients)],
        capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        raise RuntimeError(f"client process failed: {out.stderr[-2000:]}")
    res = json.loads(out.stdout)
    return res["results"], res["wall"]


def latency_line(lat: list[float]) -> str:
    lat = sorted(lat)
    return (
        f"p50 {lat[len(lat) // 2] * 1e3:.3f} ms, "
        f"p90 {lat[int(len(lat) * 0.9)] * 1e3:.3f} ms, "
        f"max {lat[-1] * 1e3:.3f} ms"
    )


def http_call(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        payload = None if body is None else json.dumps(body)
        headers = {"content-type": "application/json", "connection": "close"}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def topk_total_order(phi, k: int):
    """Top-k indices by IEEE total order, ties to the lower index — the
    rule of the port's topk_reasons, in numpy."""
    import numpy as np

    bits = np.ascontiguousarray(phi, np.float32).view(np.int32)
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).astype(np.int64)
    return np.argsort(-key, axis=1, kind="stable")[:, :k]


def metric_value(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    raise AssertionError(f"{series} missing from /metrics")


def pin_tracking_store(store: Path, work: Path) -> str:
    """Point the loader at ``store`` (an empty one serves ``MODEL_PATH``'s
    directory; one whose ``@prod`` is the artifact serves that), so a
    served phase never loads what an earlier phase registered. Child
    processes inherit it."""
    uri = f"file:{store}"
    os.environ.update(MLFLOW_TRACKING_URI=uri,
                      FRAUD_REGISTRY_CACHE=str(work / "registry_cache"))
    for knob in ("MLFLOW_MODEL_NAME", "MLFLOW_MODEL_STAGE", "REQUIRE_REGISTRY_MODEL"):
        os.environ.pop(knob, None)
    return uri


def check_source(tag: str, got: str, want: str) -> None:
    """The loader's source string: which artifact the phase serves."""
    print(f"{tag}: the loader served {got}")
    if got != want:
        raise AssertionError(f"{tag}: the loader served {got}, not {want}")


def served_path(work: Path) -> dict:
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.monitor.baseline import (
        build_baseline_profile,
        save_profile,
    )
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.service.app import create_app

    model_dir = work / "models"
    shutil.copytree(ROOT / "models", model_dir)
    data = np.loadtxt(
        ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
        max_rows=PROFILE_ROWS, dtype=np.float64,
    )
    if data.shape != (PROFILE_ROWS, 31):
        raise AssertionError(f"creditcard.csv rows have shape {data.shape}")
    x64 = data[:, :30]
    x = x64.astype(np.float32)
    t0 = time.perf_counter()
    model = load_any_model(str(model_dir), device="cuda")
    scores = model.scorer.predict_proba(x)
    profile = build_baseline_profile(
        x, scores, feature_names=model.feature_names, device="cuda"
    )
    save_profile(str(model_dir), profile)
    print(
        f"phase3: baseline profile over {profile.n_rows} rows built in "
        f"{time.perf_counter() - t0:.3f} s"
    )

    os.environ.update(
        DEVICE="cuda", SCORER_EXPLAIN="topk",
        MODEL_PATH=str(model_dir / "model.npz"),
    )
    for knob in ("SCORER_MAX_BATCH", "SCORER_FUSED_FLUSH", "SCORER_EXPLAIN_K",
                 "SCORER_RETURN_WIRE"):
        os.environ.pop(knob, None)
    pin_tracking_store(work / "empty_mlruns", work)
    app = create_app(database_url=f"sqlite:///{work}/served_fraud.db",
                     broker_url=f"sqlite:///{work}/served_taskq.db")
    port = free_port()
    server = ServerThread(app, port)
    t0 = time.perf_counter()
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"server did not start: {server.error!r}")
    try:
        batcher = app.state["batcher"]
        if batcher is None or app.state["watchtower"] is None:
            raise AssertionError("app started degraded (no batcher/watchtower)")
        print(
            f"phase3: app started (bucket ladder warmed, max_batch "
            f"{batcher.max_batch}) in {time.perf_counter() - t0:.3f} s"
        )
        check_source("phase3", app.state["model_source"], f"native:{model_dir}")
        n_total = N_REQUESTS + N_SEQUENTIAL
        rows = x[:n_total]

        kernels.reset_launch_counts()
        concurrent, wall = drive_clients(port, rows[:N_REQUESTS], CLIENTS, work)
        sequential, wall_seq = drive_clients(port, rows[N_REQUESTS:], 1, work)
        launches = kernels.launch_counts()
        results = concurrent + sequential

        # --- correctness of what came back ---
        z = np.load(model_dir / "model.npz")
        mean, scale = z["scaler_mean"], z["scaler_scale"]
        logit = ((x64[:n_total] - mean) / scale) @ z["coef"] + z["intercept"]
        want = 1.0 / (1.0 + np.exp(-logit))
        w32 = z["coef"].astype(np.float32) / scale.astype(np.float32)
        phi = w32 * (rows - mean.astype(np.float32))
        k = batcher.explain_k
        want_idx = topk_total_order(phi, k)
        names = model.feature_names
        worst = 0.0
        for i, (status, body, _) in enumerate(results):
            if status != 200:
                raise AssertionError(f"/predict {i}: HTTP {status} {body[:200]!r}")
            out = json.loads(body)
            err = abs(out["score"] - want[i])
            worst = max(worst, err)
            if not (err <= SCORE_ATOL):
                raise AssertionError(
                    f"/predict {i}: score {out['score']} vs {want[i]} (f64)"
                )
            got = [rc["feature"] for rc in out["reason_codes"] or []]
            if got != [names[j] for j in want_idx[i]]:
                raise AssertionError(f"/predict {i}: reason codes {got}")
            vals = [rc["attribution"] for rc in out["reason_codes"]]
            if not np.allclose(vals, phi[i, want_idx[i]], rtol=0, atol=1e-6):
                raise AssertionError(f"/predict {i}: attributions {vals}")
        print(
            f"phase3: {N_REQUESTS} /predict from {CLIENTS} client threads (own "
            f"process) in {wall:.3f} s ({N_REQUESTS / wall:.1f} req/s); latency "
            + latency_line([r[2] for r in concurrent]) + " (client clock)"
        )
        print(
            f"phase3: {N_SEQUENTIAL} /predict one at a time in {wall_seq:.3f} s; "
            "latency " + latency_line([r[2] for r in sequential])
            + f" (client clock); max |score - f64| over all {n_total} "
            f"{worst:.3e}"
        )

        status, body = http_call(port, "GET", "/metrics")
        text = body.decode()
        fused = metric_value(text, 'scorer_flushes_total{path="fused",shard="0"}')
        split = metric_value(text, 'scorer_flushes_total{path="split",shard="0"}')
        flush_count = metric_value(text, "scorer_microbatch_size_count")
        flush_rows = metric_value(text, "scorer_microbatch_size_sum")
        if fused < 1 or split != 0:
            raise AssertionError(f"flush paths: fused {fused}, split {split}")
        if flush_count >= flush_rows:
            raise AssertionError("no flush carried more than one row")
        print(
            f"phase3: flushes fused={fused:g} split={split:g}; {flush_rows:g} "
            f"rows in {flush_count:g} flushes ({flush_rows / flush_count:.2f} "
            "rows/flush)"
        )
        status, body = http_call(port, "GET", "/monitor/status")
        mon = json.loads(body)
        if mon["drift"]["rows_seen"] != n_total:
            raise AssertionError(f"/monitor/status rows_seen {mon['drift']}")
        print(
            f"phase3: /monitor/status rows_seen={mon['drift']['rows_seen']} "
            f"window_rows={mon['drift']['window_rows']:.3f} "
            f"status={mon['status']}"
        )
        for name in SERVED_KERNELS:
            if launches.get(name, 0) < 1:
                raise AssertionError(f"kernel {name} never launched on the path")
        print(f"phase3: kernel launches on the served path {launches}")

        # one full 1024-row fused flush (stage → kernels → fetch): its
        # device activities and its host-clock time
        scorer = batcher.scorer
        target = batcher._fused_target(scorer)
        batch = [(x[i], None) for i in range(1024)]  # (row, future) items
        acts = profiled_kernels(lambda: batcher._flush_device(scorer, target, batch))
        copies = sum(1 for name, _ in acts if "Memcpy" in name or "Memset" in name)
        busy_us = sum(us for _, us in acts)
        by_name: dict[str, list[float]] = {}
        for name, us in acts:
            by_name.setdefault(name[:48], []).append(us)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
        print(
            f"phase3: one 1024-row fused flush with explain: {len(acts) - copies} "
            f"kernel launches + {copies} copies/memsets on the device, "
            f"{busy_us:.3f} us of device activity (profiler); by name: "
            + "; ".join(f"{n} x{len(v)} {sum(v):.3f} us" for n, v in top)
        )
        times = []
        for _ in range(50):
            t = time.perf_counter()
            res = batcher._flush_device(scorer, target, batch)
            times.append(time.perf_counter() - t)
            scorer.staging.release(res[-1])
        times.sort()
        print(
            f"phase3: 1024-row fused flush host time p50 {times[25] * 1e3:.3f} "
            f"ms, min {times[0] * 1e3:.3f} ms over 50 flushes"
        )
    finally:
        server.stop()
    return launches


# ---------------------------------------------------------------------------
# phase 4: the trained path
# ---------------------------------------------------------------------------


def trained_path(work: Path) -> tuple[dict, str]:
    """``train()`` on the card and on the CPU; returns the card run's launch
    counts and its tracking store's URI (``@prod`` is its artifact)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.tracking import TrackingClient
    from fraud_detection_tpu_torch.train import train

    csv = str(ROOT / "data" / "creditcard.csv")
    runs = {}
    launches = None
    for dev in ("cuda", "cpu"):
        uri = f"file:{work / dev / 'mlruns'}"
        os.environ["MLFLOW_TRACKING_URI"] = uri
        for knob in ("MLFLOW_AUC_THRESHOLD", "MLFLOW_MODEL_NAME",
                     "MLFLOW_MODEL_STAGE", "MLFLOW_EXPERIMENT"):
            os.environ.pop(knob, None)
        out = str(work / dev / "models")
        t0 = time.perf_counter()
        if dev == "cuda":
            kernels.reset_launch_counts()
        metrics = train(data_csv=csv, out_dir=out, device=dev)
        if dev == "cuda":
            launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        runs[dev] = (metrics, out, uri)
        print(
            f"phase4: train on {dev}: test AUC {metrics['test_auc']:.6f}, CV mean "
            f"{metrics['cv_auc_mean']:.6f}, registered version "
            f"{metrics['registered_version']}, {wall:.3f} s wall; L-BFGS "
            f"iterations per fit {metrics['lbfgs_iters']}"
        )
        print(f"phase4: stages on {dev} (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in metrics["stages"].items()))
    for name in TRAINED_KERNELS:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} never launched on the path")
    if launches["knn_topk"] != KNN_LAUNCHES_PER_RUN:
        raise AssertionError(
            f"knn_topk launched {launches['knn_topk']} times in the card's "
            f"training run, not {KNN_LAUNCHES_PER_RUN}"
        )
    print(f"phase4: kernel launches on the trained path {launches}")
    (card, card_out, card_uri), (cpu, _, cpu_uri) = runs["cuda"], runs["cpu"]
    for key in ("test_auc", "cv_auc_mean"):
        if not abs(card[key] - cpu[key]) <= TRAIN_AUC_TOL:
            raise AssertionError(f"{key}: card {card[key]} vs cpu {cpu[key]}")
    for dev, (m, _, uri) in runs.items():
        if not m["test_auc"] >= 0.95 or m["registered_version"] != 1:
            raise AssertionError(
                f"{dev} run: test AUC {m['test_auc']}, version {m['registered_version']}"
            )
        reg = TrackingClient(uri).registry
        if reg.get_version_by_alias("fraud", "prod") != 1:
            raise AssertionError(f"{dev} registry: @prod is not version 1")
    reg = TrackingClient(card_uri).registry
    art = reg.resolve("models:/fraud@prod")
    if art != reg.artifact_dir("fraud", 1) or not Path(art, "meta.json").exists():
        raise AssertionError(f"models:/fraud@prod resolved to {art}")
    run_id = json.loads(Path(art, "meta.json").read_text())["run_id"]
    with np.load(Path(art) / "model.npz") as z, \
            np.load(Path(card_out) / "model.npz") as o:
        if any(not np.array_equal(z[f], o[f]) for f in z.files):
            raise AssertionError("registered artifact differs from --out-dir's")
    for sidecar in ("quant_calibration.npz", "monitor_profile.npz", "feature_names.json"):
        if not Path(art, sidecar).exists():
            raise AssertionError(f"registered artifact lacks {sidecar}")
    print(
        f"phase4: both runs pass the 0.95 gate as version 1; card - cpu: test "
        f"AUC {card['test_auc'] - cpu['test_auc']:+.3e}, CV mean "
        f"{card['cv_auc_mean'] - cpu['cv_auc_mean']:+.3e}; models:/fraud@prod "
        f"-> {Path(art).relative_to(work)} (run {run_id})"
    )

    model = load_any_model(art, device="cuda")
    data = np.loadtxt(ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
                      max_rows=TRAIN_SCORED_ROWS, dtype=np.float64)
    x64 = data[:, :30]
    got = model.scorer.predict_proba(x64.astype(np.float32))
    with np.load(Path(art) / "model.npz") as z:
        logit = ((x64 - z["scaler_mean"]) / z["scaler_scale"]) @ z["coef"] + z["intercept"]
    want = 1.0 / (1.0 + np.exp(-logit))
    err = float(np.abs(got - want).max())
    if got.shape != (TRAIN_SCORED_ROWS,) or not np.isfinite(got).all() or not err <= SCORE_ATOL:
        raise AssertionError(f"trained artifact scores off by {err:.3e}")
    print(
        f"phase4: the registered artifact on the card scores {TRAIN_SCORED_ROWS} "
        f"CSV rows within {err:.3e} of float64 numpy; on {torch.cuda.get_device_name(0)}"
    )
    return launches, card_uri


# ---------------------------------------------------------------------------
# phase 5: the GBT trained path
# ---------------------------------------------------------------------------


def gbt_trained_path(work: Path) -> tuple[dict, str, str]:
    """``train(model_family="gbt")`` with its defaults on the card and on
    the CPU; returns the card run's launch counts, its registered artifact
    directory and its tracking store's URI (``@prod`` is that artifact)."""
    import numpy as np

    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.tracking import TrackingClient
    from fraud_detection_tpu_torch.train import train

    csv = str(ROOT / "data" / "creditcard.csv")
    runs = {}
    launches = None
    for dev in ("cuda", "cpu"):
        base = work / f"gbt_{dev}"
        os.environ["MLFLOW_TRACKING_URI"] = f"file:{base / 'mlruns'}"
        t0 = time.perf_counter()
        if dev == "cuda":
            kernels.reset_launch_counts()
        metrics = train(data_csv=csv, out_dir=str(base / "models"), device=dev,
                        model_family="gbt")
        if dev == "cuda":
            launches = kernels.launch_counts()
        wall = time.perf_counter() - t0
        runs[dev] = (metrics, base)
        print(f"phase5: train --model gbt on {dev}: test AUC {metrics['test_auc']:.6f}, "
              f"CV mean {metrics['cv_auc_mean']:.6f}, registered version "
              f"{metrics['registered_version']}, {wall:.3f} s wall")
        print(f"phase5: stages on {dev} (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in metrics["stages"].items()))
    for name in GBT_TRAINED_KERNELS:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} never launched on the GBT trained path")
    if launches["gbt_hist"] != GBT_HIST_LAUNCHES_PER_RUN or launches["knn_topk"] != KNN_LAUNCHES_PER_RUN:
        raise AssertionError(f"GBT trained path launched {launches}, not gbt_hist "
                             f"{GBT_HIST_LAUNCHES_PER_RUN} and knn_topk {KNN_LAUNCHES_PER_RUN}")
    print(f"phase5: kernel launches on the GBT trained path {launches}")
    (card, card_base), (cpu, _) = runs["cuda"], runs["cpu"]
    gaps = {k: card[k] - cpu[k] for k in ("test_auc", "cv_auc_mean")}
    for key, gap in gaps.items():
        if not abs(gap) <= GBT_TRAIN_AUC_TOL:
            raise AssertionError(f"GBT {key}: card {card[key]} vs cpu {cpu[key]}")
    verdicts = {dev: m["registered_version"] for dev, (m, _) in runs.items()}
    if verdicts["cuda"] != verdicts["cpu"]:
        raise AssertionError(f"the AUC gate differs: {verdicts}")
    print(f"phase5: card - cpu: test AUC {gaps['test_auc']:+.3e}, CV mean "
          f"{gaps['cv_auc_mean']:+.3e} (tolerance {GBT_TRAIN_AUC_TOL}); the same gate "
          f"verdict on both (registered version {verdicts['cuda']})")
    if verdicts["cuda"] is None:
        raise AssertionError("the GBT run registered nothing: phases 6 and 7 serve @prod")
    store = f"file:{card_base / 'mlruns'}"
    art = Path(TrackingClient(store).registry.resolve("models:/fraud@prod"))
    with np.load(art / "model.npz") as z, np.load(card_base / "models" / "model.npz") as o:
        if any(not np.array_equal(z[f], o[f]) for f in z.files):
            raise AssertionError("registered forest differs from --out-dir's")
    forest_agreement(card_base / "models", runs["cpu"][1] / "models")
    profile_gbt_fit()
    return launches, str(art), store


def forest_agreement(card_models: Path, cpu_models: Path) -> None:
    """Whether the card's forests equal the CPU's: the final fit's, from
    the two runs' ``model.npz``, then each fold's, refit on both devices
    from the card's SMOTE'd rows (the trainer's own split, scaler and
    seeds). The card's histograms are int64 fixed-point sums, the CPU's
    float32 row-order sums, so a split whose two best candidates lie within
    float32 rounding may go the other way. For the first such node of a
    fold: both candidates' gains and the float64 argmax candidate's own, in
    float64 from the CPU forest's g and h at that tree, so each difference
    shows as a tie or a near-tie. Prints; gates nothing (phase 5's AUC gaps
    do)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.data.loader import (
        load_creditcard_csv,
        stratified_kfold_indices,
        stratified_split,
    )
    from fraud_detection_tpu_torch.ops.gbt import (
        GBTConfig,
        bin_features_host,
        compute_bin_edges,
        gbt_fit,
    )
    from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_transform
    from fraud_detection_tpu_torch.ops.smote import smote

    with np.load(card_models / "model.npz") as a, np.load(cpu_models / "model.npz") as b:
        same = all(np.array_equal(a[k], b[k]) for k in ("gbt_split_feature", "gbt_split_bin"))
        leaf_gap = float(np.abs(a["gbt_leaf_value"] - b["gbt_leaf_value"]).max())
    print(f"phase5: final forest card vs cpu: splits equal {same}, max |leaf value "
          f"gap| {leaf_gap:.3e}")
    cfg = GBTConfig()
    seed = 42  # train()'s default
    x, y, _ = load_creditcard_csv(str(ROOT / "data" / "creditcard.csv"))
    tr_idx, _ = stratified_split(y, 0.2, seed)
    x_train, y_train = x[tr_idx], y[tr_idx]
    xs = scaler_transform(scaler_fit(torch.as_tensor(x_train, device="cuda")),
                          torch.as_tensor(x_train, device="cuda"))
    for fold, (tr, _) in enumerate(stratified_kfold_indices(y_train, 5, seed)):
        x_tr, y_tr = smote(xs[torch.as_tensor(tr, device="cuda")], y_train[tr], seed + fold)
        card = gbt_fit(x_tr, y_tr, cfg)
        cpu = gbt_fit(x_tr.cpu(), y_tr, cfg)
        sf_k, sb_k = card.split_feature.cpu().numpy(), card.split_bin.cpu().numpy()
        sf_c, sb_c = cpu.split_feature.numpy(), cpu.split_bin.numpy()
        diff = np.argwhere((sf_k != sf_c) | (sb_k != sb_c))
        if diff.size == 0:
            print(f"phase5: fold {fold} forest card vs cpu: every split equal")
            continue
        t, i = (int(v) for v in diff[0])
        x_np = x_tr.cpu().numpy()
        binned = torch.from_numpy(bin_features_host(
            x_np, compute_bin_edges(x_np, cfg.n_bins), cfg.n_bins)).long()
        yv = torch.as_tensor(np.asarray(y_tr), dtype=torch.float32)
        n_internal, depth = sf_c.shape[1], cfg.max_depth
        logits = cpu.base_logit.expand(len(yv)).clone()
        rows = torch.arange(len(yv))
        for tree in range(t):  # the CPU's boosting up to tree t, in its f32 order
            node = torch.zeros(len(yv), dtype=torch.long)
            for _ in range(depth):
                go = binned[rows, cpu.split_feature[tree].long()[node]] > cpu.split_bin[tree][node]
                node = 2 * node + 1 + go.long()
            logits = logits + cpu.leaf_value[tree][node - n_internal]
        p = torch.sigmoid(logits)
        g = (p - yv).double()
        h = torch.clamp_min(p * (1.0 - p), 1e-16).double()
        node = torch.zeros(len(yv), dtype=torch.long)
        for _ in range((i + 1).bit_length() - 1):  # rows down to node i's level
            go = binned[rows, cpu.split_feature[t].long()[node]] > cpu.split_bin[t][node]
            node = 2 * node + 1 + go.long()
        m = node == i
        gl = torch.stack([torch.bincount(binned[m, f], g[m], cfg.n_bins)
                          for f in range(binned.shape[1])]).cumsum(1)
        hl = torch.stack([torch.bincount(binned[m, f], h[m], cfg.n_bins)
                          for f in range(binned.shape[1])]).cumsum(1)
        gt, ht = gl[:, -1:], hl[:, -1:]
        lam = cfg.reg_lambda
        gain = 0.5 * (gl**2 / (hl + lam) + (gt - gl)**2 / (ht - hl + lam)
                      - gt**2 / (ht + lam)) - cfg.gamma
        valid = (hl >= cfg.min_child_weight) & (ht - hl >= cfg.min_child_weight)
        valid[:, -1] = False
        gain = torch.where(valid, gain, -torch.inf)

        def cand(f, b):
            return f"({f}, {b}) gain " + (f"{float(gain[f, b]):.9e}" if b < cfg.n_bins - 1
                                          else "none (no split)")

        g_k, g_c = float(gain[sf_k[t, i], sb_k[t, i]]), float(gain[sf_c[t, i], sb_c[t, i]])
        rel = abs(g_k - g_c) / max(abs(g_k), abs(g_c), 1e-300)
        best = divmod(int(torch.argmax(gain)), cfg.n_bins)
        print(f"phase5: fold {fold} forest card vs cpu: first split difference at tree {t} "
              f"node {i} ({int(m.sum())} rows); float64 from the CPU's g, h: card "
              f"{cand(sf_k[t, i], sb_k[t, i])}, cpu {cand(sf_c[t, i], sb_c[t, i])}, relative "
              f"gap {rel:.3e} (float32 eps 5.96e-08); float64 best {cand(*best)}; "
              f"{len(diff)} of {sf_c.size} splits differ")


def profile_gbt_fit() -> None:
    """One forest fit with the recipe at the final fit's shape (31,684 × 30
    Gaussian rows from a seed, labels from a seeded linear model) on the
    card: its wall time, then the same fit under ``torch.profiler`` for the
    device's busy time by kernel. Busy share = device busy / unprofiled
    wall. Its launches come after phase 5's counts were read."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops.gbt import GBTConfig, gbt_fit

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((31684, 30), dtype=np.float32)).cuda()
    y = (x.cpu().numpy() @ rng.standard_normal(30).astype(np.float32) > 1.0).astype(np.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    gbt_fit(x, y, GBTConfig())
    wall = time.perf_counter() - t
    acts = profiled_kernels(lambda: gbt_fit(x, y, GBTConfig()))
    busy_us = sum(us for _, us in acts)
    hist_us = [us for name, us in acts if "gbt_hist" in name]
    by_name: dict[str, list[float]] = {}
    for name, us in acts:
        by_name.setdefault(name[:48], []).append(us)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    print(f"phase5: one recipe fit at 31684 x 30 on the card: {wall:.3f} s wall; under "
          f"the profiler {len(acts)} device activities, {busy_us / 1e3:.3f} ms busy "
          f"({100 * busy_us / 1e6 / wall:.1f}% of the unprofiled wall); gbt_hist's "
          f"kernels x{len(hist_us)} {sum(hist_us) / 1e3:.3f} ms; top by name: "
          + "; ".join(f"{n} x{len(v)} {sum(v) / 1e3:.3f} ms" for n, v in top))


# ---------------------------------------------------------------------------
# phase 6: the GBT served path
# ---------------------------------------------------------------------------


def forest_logits_f64(directory: Path, x32):
    """A float64 numpy walk of the forest in ``model.npz``: bins by the
    float32 comparisons the model makes (NaN to the last bin), leaf values
    summed in float64."""
    import numpy as np

    with np.load(directory / "model.npz") as z:
        sf, sb = z["gbt_split_feature"], z["gbt_split_bin"]
        leaf, edges = z["gbt_leaf_value"].astype(np.float64), z["gbt_bin_edges"]
        base = float(z["gbt_base_logit"])
    n, d = x32.shape
    bins = np.stack([np.searchsorted(edges[f], x32[:, f], side="left") for f in range(d)], 1)
    bins[np.isnan(x32)] = edges.shape[1]
    n_internal = sf.shape[1]
    logit = np.full(n, base)
    rows = np.arange(n)
    for t in range(sf.shape[0]):
        node = np.zeros(n, np.int64)
        while True:
            internal = node < n_internal
            if not internal.any():
                break
            go = bins[rows, sf[t, np.minimum(node, n_internal - 1)]] > sb[t, np.minimum(node, n_internal - 1)]
            node = np.where(internal, 2 * node + 1 + go, node)
        logit += leaf[t, node - n_internal]
    return logit


def gbt_served_path(work: Path, art_dir: str, store: str) -> dict:
    """Serve phase 5's registered forest from its registry (``store``'s
    ``@prod``; ``MODEL_PATH`` names a copy of it, which the loader does not
    reach)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.ops.tree_shap import tree_shap
    from fraud_detection_tpu_torch.service.app import create_app

    model_dir = work / "gbt_served"
    shutil.copytree(art_dir, model_dir)
    for f in ("model.npz", "monitor_profile.npz", "feature_names.json"):
        if not (model_dir / f).exists():
            raise AssertionError(f"the trained GBT artifact lacks {f}")
    data = np.loadtxt(ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
                      max_rows=N_REQUESTS + N_SEQUENTIAL, dtype=np.float64)
    x = data[:, :30].astype(np.float32)
    os.environ.update(DEVICE="cuda", SCORER_EXPLAIN="topk",
                      MODEL_PATH=str(model_dir / "model.npz"))
    for knob in ("SCORER_MAX_BATCH", "SCORER_FUSED_FLUSH", "SCORER_EXPLAIN_K",
                 "SCORER_RETURN_WIRE"):
        os.environ.pop(knob, None)
    pin_tracking_store(Path(store.removeprefix("file:")), work)
    app = create_app(database_url=f"sqlite:///{work}/gbt_served_fraud.db",
                     broker_url=f"sqlite:///{work}/gbt_served_taskq.db")
    port = free_port()
    server = ServerThread(app, port)
    t0 = time.perf_counter()
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"server did not start: {server.error!r}")
    try:
        batcher = app.state["batcher"]
        if batcher is None or app.state["watchtower"] is None:
            raise AssertionError("GBT app started degraded (no batcher/watchtower)")
        print(f"phase6: GBT app started (bucket ladder warmed, explainer and its "
              f"kernel tables built) in {time.perf_counter() - t0:.3f} s")
        check_source("phase6", app.state["model_source"], "registry:models:/fraud@prod")
        _, body = http_call(port, "GET", "/metrics")
        before = {key: metric_value(body.decode(), key) for key in (
            'scorer_flushes_total{path="fused",shard="0"}',
            'scorer_flushes_total{path="split",shard="0"}',
            "scorer_microbatch_size_count")}
        kernels.reset_launch_counts()
        concurrent, wall = drive_clients(port, x[:N_REQUESTS], CLIENTS, work)
        sequential, wall_seq = drive_clients(port, x[N_REQUESTS:], 1, work)
        launches = kernels.launch_counts()
        results = concurrent + sequential
        _, body = http_call(port, "GET", "/metrics")
        text = body.decode()
        delta = {key: metric_value(text, key) - v for key, v in before.items()}
        flushes = delta["scorer_microbatch_size_count"]

        want = 1.0 / (1.0 + np.exp(-forest_logits_f64(model_dir, x)))
        ref = load_any_model(str(model_dir), device="cpu")
        phi = tree_shap(ref.raw_explainer(), torch.from_numpy(x)).numpy()
        k = batcher.explain_k
        want_idx = topk_total_order(phi, k)
        srt = -np.sort(-phi, axis=1)
        names = ref.feature_names
        worst, tie_rows = 0.0, 0
        for i, (status, body, _) in enumerate(results):
            if status != 200:
                raise AssertionError(f"/predict {i}: HTTP {status} {body[:200]!r}")
            out = json.loads(body)
            err = abs(out["score"] - want[i])
            worst = max(worst, err)
            if not err <= SCORE_ATOL:
                raise AssertionError(f"/predict {i}: score {out['score']} vs {want[i]} (f64)")
            got = [rc["feature"] for rc in out["reason_codes"] or []]
            if got != [names[j] for j in want_idx[i]]:
                if not abs(srt[i, k - 1] - srt[i, k]) <= SHAP_TIE:
                    raise AssertionError(f"/predict {i}: reason codes {got}")
                tie_rows += 1
            vals = np.array([rc["attribution"] for rc in out["reason_codes"]])
            jidx = [names.index(f) for f in got]
            if not np.allclose(vals, phi[i, jidx], rtol=SHAP_RTOL, atol=SHAP_ATOL):
                raise AssertionError(f"/predict {i}: attributions {vals}")
        n_total = len(results)
        print(f"phase6: {N_REQUESTS} /predict from {CLIENTS} client threads (own "
              f"process) in {wall:.3f} s ({N_REQUESTS / wall:.1f} req/s); latency "
              + latency_line([r[2] for r in concurrent]) + " (client clock)")
        print(f"phase6: {N_SEQUENTIAL} /predict one at a time in {wall_seq:.3f} s; latency "
              + latency_line([r[2] for r in sequential]) + f" (client clock); max "
              f"|score - f64 forest walk| over all {n_total} {worst:.3e}; reason codes "
              f"equal the CPU plain TreeSHAP's on {n_total - tie_rows} rows, {tie_rows} "
              f"rows differ across a k-th/(k+1)-th tie within {SHAP_TIE}")
        if delta['scorer_flushes_total{path="fused",shard="0"}'] != flushes or \
                delta['scorer_flushes_total{path="split",shard="0"}'] != 0 or flushes < 1:
            raise AssertionError(f"GBT flush paths: {delta}")
        for name in GBT_SERVED_KERNELS:
            if launches.get(name, 0) < flushes:
                raise AssertionError(f"{name} launched {launches.get(name)} times in "
                                     f"{flushes:g} explained flushes")
        print(f"phase6: {flushes:g} flushes, all fused; kernel launches on the GBT "
              f"served path {launches}")
        status, body = http_call(port, "GET", "/monitor/status")
        rows_seen = json.loads(body)["drift"]["rows_seen"]
        if rows_seen != n_total or 'scorer_served_family{family="gbt"} 1.0' not in text:
            raise AssertionError(f"GBT monitor rows_seen {rows_seen} / served family")

        scorer = batcher.scorer
        target = batcher._fused_target(scorer)
        rows1024 = np.concatenate([x] * 4)[:1024]
        batch = [(rows1024[i], None) for i in range(1024)]
        def flush():
            scorer.staging.release(batcher._flush_device(scorer, target, batch)[-1])

        reps = 5
        acts = profiled_intervals(lambda: [flush() for _ in range(reps)])
        copies = sum(1 for name, _, _ in acts if "Memcpy" in name or "Memset" in name)
        busy_us = union_us([(a, b) for _, a, b in acts]) / reps
        summed_us = sum(b - a for _, a, b in acts) / reps
        by_name: dict[str, list[float]] = {}
        for name, a, b in acts:
            by_name.setdefault(name[:48], []).append((b - a) / reps)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
        # tree_shap: the group pass and the group sum, its programmatic
        # dependent (which starts early and waits): from the first's start to
        # the second's end, per flush
        calls: list[list[float]] = []
        for a, b, name in sorted((a, b, name) for name, a, b in acts if "tree_shap" in name):
            if "sum_groups" in name and calls:
                calls[-1][1] = max(calls[-1][1], b)
            else:
                calls.append([a, b])
        spans = sorted(b - a for a, b in calls)
        shap = {re.search(r"tree_shap_\w+", key).group(): sum(v)
                for key, v in by_name.items() if "tree_shap" in key}
        print(f"phase6: 1024-row GBT fused flush with explain, mean of {reps} under the "
              f"profiler: {(len(acts) - copies) / reps:g} kernel launches + {copies / reps:g} "
              f"copies/memsets on the device, busy {busy_us:.3f} us (union of device "
              f"intervals; kernel times summed {summed_us:.3f} us); tree_shap from its group "
              f"pass's start to its group sum's end p50 {spans[len(spans) // 2]:.3f} us over "
              f"{len(spans)} (by kernel: "
              + ", ".join(f"{n} {v:.3f} us" for n, v in shap.items())
              + "); top by name: "
              + "; ".join(f"{n} x{len(v)} {sum(v):.3f} us" for n, v in top))
        if len(spans) != reps:
            raise AssertionError(f"tree_shap ran {len(spans)} times in {reps} flushes")
        times = []
        for _ in range(30):
            t = time.perf_counter()
            res = batcher._flush_device(scorer, target, batch)
            times.append(time.perf_counter() - t)
            scorer.staging.release(res[-1])
        times.sort()
        print(f"phase6: 1024-row GBT fused flush host time p50 {times[15] * 1e3:.3f} ms, "
              f"min {times[0] * 1e3:.3f} ms over 30 flushes")
        margin_sum_in_turns(scorer._model, rows1024, flush)
    finally:
        server.stop()
    return launches

def margin_sum_in_turns(model, rows, flush, reps: int = 5, rounds: int = 6) -> None:
    """The forest's margin on the card summed over trees two ways: by
    halving (the served form) and by one reduction kernel over (trees,
    leaves). For each, the rows among the first 64 whose margin bits
    differ alone or in a bucket of 8 from their bits in the 1024-row
    batch; the served form must not differ. Then a 1024-row flush with
    each form, in turns (one, other, other, one): host time p50, device
    busy and launches under the profiler."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import gbt

    def one_reduction(m, x):
        return m.base_logit + gbt._leaf_contrib(m, x).sum(dim=(1, 2))

    served = gbt._predict_logits_dense
    forms = {"halving": served, "one reduction": one_reduction}
    xt = torch.from_numpy(np.ascontiguousarray(rows)).to(model.bin_edges.device)
    differ = {}
    for name, fn in forms.items():
        full = fn(model, xt).view(torch.int32)
        for n in (1, 8):
            differ[name, n] = sum(
                int((fn(model, xt[i:i + n]).view(torch.int32) != full[i:i + n]).sum())
                for i in range(0, 64, n))
    print("phase6: margin bits of the first 64 rows alone / in buckets of 8 against the "
          "1024-row batch, rows that differ: "
          + "; ".join(f"{name} {differ[name, 1]} / {differ[name, 8]}" for name in forms))
    if differ["halving", 1] or differ["halving", 8]:
        raise AssertionError(f"the served margin depends on the batch: {differ}")
    host: dict[str, list[float]] = {name: [] for name in forms}
    prof = {}
    try:
        for name, fn in forms.items():
            gbt._predict_logits_dense = fn
            flush()
            acts = profiled_intervals(lambda: [flush() for _ in range(reps)])
            copies = sum(1 for a, _, _ in acts if "Memcpy" in a or "Memset" in a)
            prof[name] = ((len(acts) - copies) / reps,
                          union_us([(a, b) for _, a, b in acts]) / reps)
        order = list(forms)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                gbt._predict_logits_dense = forms[name]
                for _ in range(reps):
                    t = time.perf_counter()
                    flush()
                    host[name].append(time.perf_counter() - t)
    finally:
        gbt._predict_logits_dense = served
    print("phase6: 1024-row GBT fused flush with each tree sum, in turns: "
          + "; ".join(
              f"{name}: host p50 {sorted(v)[len(v) // 2] * 1e3:.3f} ms over {len(v)}, "
              f"{prof[name][0]:g} launches, busy {prof[name][1]:.3f} us (profiler, mean of "
              f"{reps})" for name, v in host.items()))


# ---------------------------------------------------------------------------
# phase 7: the explain path
# ---------------------------------------------------------------------------


def drain_worker(env: dict, log_path: Path, metrics_port: int) -> subprocess.Popen:
    """The SHAP worker through its entry point, as a deployment starts it:
    its own process, the default device, batches of 64."""
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "fraud_detection_tpu_torch.service.worker",
             "--max-batch", "64", "--metrics-port", str(metrics_port)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        )


def explain_path(work: Path, family: str, model_dir: Path, card: str,
                 store: Path, source: str) -> dict:
    """Serve ``model_dir`` with a results DB and a broker, queue
    ``EXPLAIN_REQUESTS`` explanations through ``/predict`` plus one poison
    task, drain them with the worker's entry point on the card, check every
    stored explanation, then count and time ``run_batch`` in process. The
    app and the worker load from ``store`` (an empty one, or one whose
    ``@prod`` is ``model_dir``) and must name ``source``."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.ops.tree_shap import tree_shap
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.service.worker import XaiWorker

    tag = f"phase7 {family}"
    stores = work / f"explain_{family}"
    stores.mkdir()
    db_url, q_url = f"sqlite:///{stores}/fraud.db", f"sqlite:///{stores}/taskq.db"
    data = np.loadtxt(ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
                      max_rows=EXPLAIN_REQUESTS, dtype=np.float64)
    x64 = data[:, :30]
    x = x64.astype(np.float32)
    os.environ.update(DEVICE="cuda", SCORER_EXPLAIN="topk",
                      MODEL_PATH=str(model_dir / "model.npz"))
    pin_tracking_store(store, work)
    app = create_app(database_url=db_url, broker_url=q_url)
    port = free_port()
    server = ServerThread(app, port)
    server.start()
    worker_proc = None
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"server did not start: {server.error!r}")
    try:
        check_source(f"{tag} app", app.state["model_source"], source)
        status, body = http_call(port, "GET", "/health")
        health = json.loads(body)
        if status != 200 or health["status"] != "healthy":
            raise AssertionError(f"{tag}: /health {status} {health}")
        results, wall = drive_clients(port, x, CLIENTS, work)
        ids = []
        for i, (status, body, _) in enumerate(results):
            out = json.loads(body)
            if status != 200 or out["explanation_status"] != "queued":
                raise AssertionError(f"{tag}: /predict {i}: HTTP {status} {body[:200]!r}")
            ids.append(out["transaction_id"])
        app.state["db"].create_pending("poison", {"wrong": 1.0}, None)
        app.state["broker"].send_task("xai_tasks.compute_shap",
                                      ["poison", {"wrong": 1.0}, None], max_retries=0)
        print(f"{tag}: /health 200 healthy; {len(ids)} /predict answered "
              f"explanation_status=queued in {wall:.3f} s; queue depth "
              f"{app.state['broker'].depth()} with the poison task")

        env = {k: v for k, v in os.environ.items() if k != "DEVICE"}  # the default: cuda
        env.update(DATABASE_URL=db_url, CELERY_BROKER_URL=q_url,
                   PYTHONPATH=str(ROOT))
        metrics_port = free_port()
        t0 = time.perf_counter()
        worker_proc = drain_worker(env, stores / "worker.log", metrics_port)
        # the poison task was queued last: it settles (FAILED) in the last batch
        pending, first = set(ids) | {"poison"}, None
        while pending:
            if time.perf_counter() - t0 > EXPLAIN_DRAIN_TIMEOUT_S:
                raise AssertionError(f"{tag}: {len(pending)} of {len(ids)} rows not "
                                     f"COMPLETED after {EXPLAIN_DRAIN_TIMEOUT_S} s")
            if worker_proc.poll() is not None:
                raise AssertionError(f"{tag}: the worker exited {worker_proc.returncode}: "
                                     + (stores / "worker.log").read_text()[-3000:])
            for tx in sorted(pending):
                status, _ = http_call(port, "GET", f"/explain/{tx}")
                if status == 200:
                    pending.discard(tx)
                    first = first or time.perf_counter()
            if pending:
                time.sleep(0.05)
        drained = time.perf_counter() - t0
        status, body = http_call(port, "GET", "/explain/poison")
        poison = json.loads(body)
        if status != 200 or poison["status"] != "FAILED" or \
                "missing features" not in (poison["error"] or ""):
            raise AssertionError(f"{tag}: poison task {status} {poison}")
        # a row reads COMPLETED before its task is acked and counted
        while True:
            _, body = http_call(metrics_port, "GET", "/metrics")
            wm = body.decode()
            consistency = metric_value(wm, "xai_explain_consistency_failures_total")
            success = metric_value(wm, "xai_task_success_total")
            failures = metric_value(wm, "xai_task_failures_total")
            if success + failures >= len(ids) + 1 or \
                    time.perf_counter() - t0 > EXPLAIN_DRAIN_TIMEOUT_S:
                break
            time.sleep(0.05)
        worker_proc.send_signal(signal.SIGTERM)
        rc = worker_proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"{tag}: the worker exited {rc} on SIGTERM: "
                                 + (stores / "worker.log").read_text()[-3000:])
        if consistency != 0 or success != len(ids) or failures != 1:
            raise AssertionError(f"{tag}: worker counters consistency failures "
                                 f"{consistency}, successes {success}, failures {failures}")
        depth = app.state["broker"].depth()
        if depth != 0:
            raise AssertionError(f"{tag}: queue depth {depth} after the drain")
        up = re.search(r"; model from (\S+)", (stores / "worker.log").read_text())
        check_source(f"{tag} worker", up.group(1) if up else "(no start-up line)", source)
        print(f"{tag}: worker entry point (own process, default device cuda, "
              f"--max-batch 64) drained {len(ids)} tasks + 1 poison in {drained:.3f} s "
              f"from its spawn (host clock; first row COMPLETED at "
              f"{first - t0:.3f} s: start-up, model load and warm-up), then exited "
              f"{rc} on SIGTERM; poison task FAILED with its error body; "
              f"xai_explain_consistency_failures {consistency:g}, successes "
              f"{success:g}, failures {failures:g}; queue depth {depth}; on {card}")

        lat, stored = [], []
        for tx in ids:
            t = time.perf_counter()
            status, body = http_call(port, "GET", f"/explain/{tx}")
            lat.append(time.perf_counter() - t)
            out = json.loads(body)
            if status != 200 or out["status"] != "COMPLETED":
                raise AssertionError(f"{tag}: /explain/{tx}: {status} {out}")
            stored.append(out)
        print(f"{tag}: /explain readback of {len(ids)} COMPLETED rows one at a time: "
              + latency_line(lat) + f" (client clock, in the server's process); on {card}")

        score = np.array([o["prediction_score"] for o in stored])
        phi = np.array([list(o["shap_values"].values()) for o in stored])
        ev = np.array([o["expected_value"] for o in stored])
        names = load_any_model(str(model_dir), device="cpu").feature_names
        if any(list(o["shap_values"]) != names for o in stored):
            raise AssertionError(f"{tag}: stored feature names differ from the model's")
        if family == "logistic":
            z = np.load(model_dir / "model.npz")
            mean, scale = z["scaler_mean"], z["scaler_scale"]
            logit = ((x64 - mean) / scale) @ z["coef"] + z["intercept"]
            phi_want = (z["coef"] / scale) * (x.astype(np.float64) - mean)
            phi_err = float(np.abs(phi - phi_want).max())
            phi_ok = phi_err <= SCORE_ATOL
            phi_what = "the float64 closed form coef·(x − μ)"
        else:
            logit = forest_logits_f64(model_dir, x)
            ref = load_any_model(str(model_dir), device="cpu")
            phi_want = tree_shap(ref.raw_explainer(), torch.from_numpy(x)).double().numpy()
            phi_err = float(np.abs(phi - phi_want).max())
            phi_ok = np.allclose(phi, phi_want, rtol=SHAP_RTOL, atol=SHAP_ATOL)
            phi_what = "the port's CPU plain TreeSHAP"
        score_err = float(np.abs(score - 1.0 / (1.0 + np.exp(-logit))).max())
        additivity = float(np.abs(phi.sum(axis=1) + ev - np.log(score / (1.0 - score))).max())
        if not (score_err <= SCORE_ATOL and phi_ok and additivity <= 1e-4):
            raise AssertionError(f"{tag}: stored scores {score_err:.3e} from float64, "
                                 f"φ {phi_err:.3e} from {phi_what}, additivity "
                                 f"{additivity:.3e}")
        print(f"{tag}: stored results: max |score - float64| {score_err:.3e}; max |φ - "
              f"{phi_what}| {phi_err:.3e}; max |Σφ + E[f] - logit(score)| "
              f"{additivity:.3e}")
    finally:
        if worker_proc is not None and worker_proc.poll() is None:
            worker_proc.kill()
            worker_proc.wait(timeout=60)
        server.stop()

    # in process: the worker's launches a batch and run_batch's host time
    worker = XaiWorker(broker_url=q_url, database_url=db_url, worker_id="phase7")
    try:
        worker.warmup()

        def queue(run: str) -> None:
            for i, row in enumerate(x[:64]):
                feats = dict(zip(names, row.tolist()))
                worker.db.create_pending(f"{run}-{i}", feats, None)
                worker.broker.send_task("xai_tasks.compute_shap", [f"{run}-{i}", feats, None])

        queue("counted")
        kernels.reset_launch_counts()
        handled = worker.run_batch(64)
        launches = kernels.launch_counts()
        kernel = EXPLAIN_KERNELS[family]
        if handled != 64 or launches[kernel] < 1:
            raise AssertionError(f"{tag}: run_batch handled {handled}, launches {launches}")
        reps = 3
        for r in range(reps):
            queue(f"profiled{r}")
        t = time.perf_counter()
        acts = profiled_intervals(lambda: [worker.run_batch(64) for _ in range(reps)])
        profiled_ms = (time.perf_counter() - t) * 1e3 / reps
        copies = sum(1 for name, _, _ in acts if "Memcpy" in name or "Memset" in name)
        busy_us = union_us([(a, b) for _, a, b in acts]) / reps

        # host time by stage: each stage's call wrapped on this worker only
        stages = dict.fromkeys(("claim", "score", "explain", "upserts", "acks"), 0.0)

        def timed_stage(name, fn):
            def wrapped(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    stages[name] += time.perf_counter() - t
            return wrapped

        worker.broker.claim_many = timed_stage("claim", worker.broker.claim_many)
        worker.model.scorer.predict_proba = timed_stage(
            "score", worker.model.scorer.predict_proba)
        worker.model.explain_batch = timed_stage("explain", worker.model.explain_batch)
        worker.db.complete = timed_stage("upserts", worker.db.complete)
        worker.broker.ack = timed_stage("acks", worker.broker.ack)
        times = []
        for r in range(EXPLAIN_TIMED_BATCHES):
            queue(f"timed{r}")
            t = time.perf_counter()
            if worker.run_batch(64) != 64:
                raise AssertionError(f"{tag}: a timed run_batch handled fewer than 64")
            times.append(time.perf_counter() - t)
        mean_ms = {k: v * 1e3 / len(times) for k, v in stages.items()}
        other_ms = sum(times) * 1e3 / len(times) - sum(mean_ms.values())
        times.sort()
        print(f"{tag}: kernel launches in one run_batch of 64 tasks (one dispatch) "
              f"{launches}; run_batch host time p50 "
              f"{times[len(times) // 2] * 1e3:.3f} ms, min {times[0] * 1e3:.3f} ms over "
              f"{len(times)} batches (claim, score, explain, 64 COMPLETED upserts and acks); "
              "mean a batch by stage: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in mean_ms.items())
              + f", the rest {other_ms:.3f} ms; on {card}")
        if acts:
            print(f"{tag}: run_batch of 64 under the profiler, mean of {reps}: "
                  f"{(len(acts) - copies) / reps:g} kernel launches + {copies / reps:g} "
                  f"copies/memsets, device busy {busy_us:.3f} us (union of device "
                  f"intervals) in {profiled_ms:.3f} ms of host time")
        else:  # the launch count above shows the device did run
            print(f"{tag}: run_batch of 64 under the profiler: device busy not measured "
                  f"(the profiler recorded no device activity over {reps} batches)")
    finally:
        worker.close()
    return launches


# ---------------------------------------------------------------------------
# phase 8: the offline tools
# ---------------------------------------------------------------------------


def sync_wall(fn):
    """(fn's result, its seconds on the host clock with the device
    synchronised at both ends)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class ToolRuns:
    """Runs each tool under zeroed launch counts and checks them against
    ``TOOL_LAUNCHES``; sums each kernel's launches over the phase."""

    def __init__(self):
        self.total: dict[str, int] = {}

    def __call__(self, label: str, kind: str, fn):
        from fraud_detection_tpu_torch.ops import kernels

        kernels.reset_launch_counts()
        out, wall = sync_wall(fn)
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        want = TOOL_LAUNCHES[kind]
        print(f"phase8: {label}: {wall:.3f} s wall (host clock, device synchronised); "
              f"kernel launches {got}")
        if got != want:
            raise AssertionError(f"phase8 {label}: launched {got}, not {want}")
        for k, v in got.items():
            self.total[k] = self.total.get(k, 0) + v
        return out, wall


def logistic_scores_f64(model_dir: Path, x32):
    import numpy as np

    with np.load(Path(model_dir) / "model.npz") as z:
        logit = ((x32.astype(np.float64) - z["scaler_mean"]) / z["scaler_scale"]) @ z["coef"] \
            + z["intercept"]
    return 1.0 / (1.0 + np.exp(-logit))


def tool_split(csv: Path) -> tuple:
    """(test rows float32, test labels, minority rows of the training
    split, frauds in the file): the tools' split, seed 42."""
    from fraud_detection_tpu_torch.data.loader import load_creditcard_csv, stratified_split

    x, y, _ = load_creditcard_csv(str(csv))
    train_idx, test_idx = stratified_split(y, 0.2, 42)
    return x[test_idx], y[test_idx], int(y[train_idx].sum()), int(y.sum())


def check_phi(tag: str, phi, ev: float, ref_phi, logits, rows=None) -> tuple[float, float]:
    """φ against the CPU plain TreeSHAP (``ref_phi``, on ``rows`` of φ when
    given) within rtol/atol, and additivity Σφ + E[f] = f(x) on every row.
    Returns (max |card − cpu|, max additivity gap)."""
    import numpy as np

    got = phi if rows is None else phi[rows]
    err = float(np.abs(got - ref_phi).max())
    over = float((np.abs(got - ref_phi) - SHAP_RTOL * np.abs(ref_phi)).max())
    add = float(np.abs(phi.astype(np.float64).sum(1) + ev - logits).max())
    if not np.isfinite(phi).all() or over > SHAP_ATOL or add > TOOL_ADDITIVITY:
        raise AssertionError(f"phase8 {tag}: phi off the CPU plain TreeSHAP by {err:.3e} "
                             f"or not additive ({add:.3e})")
    return err, add


def top10_agree(tag: str, mean_abs, ref_mean_abs) -> int:
    """The top-10 features by mean |φ| equal the reference's, except where
    a swapped pair's reference means lie within ``SHAP_TIE``; returns the
    positions that differ."""
    import numpy as np

    got, want = np.argsort(-mean_abs)[:10], np.argsort(-ref_mean_abs)[:10]
    bad = [i for i in range(10) if got[i] != want[i]
           and abs(ref_mean_abs[got[i]] - ref_mean_abs[want[i]]) > SHAP_TIE]
    if bad:
        raise AssertionError(f"phase8 {tag}: top-10 {got.tolist()} vs the CPU's {want.tolist()}")
    return int((got != want).sum())


def start_tracking_server(root: Path, log_path: Path) -> tuple[subprocess.Popen, str]:
    """The port's tracking server over ``root``, its own process, through
    its entry point; returns it and its URI once ``/health`` answers."""
    port = free_port()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fraud_detection_tpu_torch.tracking.server",
             "--root", str(root), "--host", "127.0.0.1", "--port", str(port)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            stdout=log, stderr=subprocess.STDOUT,
        )
    t0 = time.perf_counter()
    while True:
        try:
            status, _ = http_call(port, "GET", "/health")
            if status == 200:
                return proc, f"http://127.0.0.1:{port}"
        except OSError:
            pass
        if proc.poll() is not None or time.perf_counter() - t0 > 60:
            proc.kill()
            proc.wait(timeout=30)
            raise RuntimeError("the tracking server did not start: "
                               + log_path.read_text()[-2000:])
        time.sleep(0.1)


def tool_cli(module: str, args: list[str], work: Path) -> subprocess.CompletedProcess:
    """A tool through ``python -m``, its own process on the default device."""
    env = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-m", f"fraud_detection_tpu_torch.{module}", *args],
                          cwd=work, env=env, capture_output=True, text=True, timeout=300)


def offline_tools(work: Path, lin_store: str, gbt_dir: str) -> dict:
    """Phase 8: every offline tool on the card, in ``work``: preprocess,
    evaluate, explain, validate_auc, predict_single and eda, held against
    CPU runs and float64 numpy, then preprocess, evaluate and explain at the
    Kaggle file's scale. Returns each kernel's launches over the phase."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.data.synthetic import generate_synthetic_data
    from fraud_detection_tpu_torch.eda import eda
    from fraud_detection_tpu_torch.evaluate import evaluate
    from fraud_detection_tpu_torch.explain import explain
    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.ops.tree_shap import tree_shap
    from fraud_detection_tpu_torch.predict_single import _DEMO_ROW, FraudDetector
    from fraud_detection_tpu_torch.preprocess import preprocess
    from fraud_detection_tpu_torch.tracking import TrackingClient
    from fraud_detection_tpu_torch.validate_auc import validate_auc

    t_phase = time.perf_counter()
    tools = work / "tools"
    tools.mkdir()
    csv = ROOT / "data" / "creditcard.csv"
    lin_root = Path(lin_store.removeprefix("file:"))
    lin_dir = Path(TrackingClient(lin_store).registry.resolve("models:/fraud@prod"))
    gbt_dir = Path(gbt_dir)
    pin_tracking_store(tools / "empty_mlruns", tools)
    os.environ["DEVICE"] = "cuda"
    run = ToolRuns()

    # 1. preprocess on the committed CSV, on the card and on the CPU
    run("preprocess (committed CSV, 20,000 x 30)", "preprocess",
        lambda: preprocess(str(csv), str(tools / "pre_card.npz"), str(tools / "pre_card"),
                           device="cuda"))
    preprocess(str(csv), str(tools / "pre_cpu.npz"), str(tools / "pre_cpu"), device="cpu")
    card, cpu = np.load(tools / "pre_card.npz"), np.load(tools / "pre_cpu.npz")
    same = all(card[k].tobytes() == cpu[k].tobytes() for k in ("X_test", "y_test"))
    differ = int((card["X_test"] != cpu["X_test"]).sum())
    counts = np.bincount(card["y_res"])
    print(f"phase8: preprocess X_test {card['X_test'].shape} and y_test equal the CPU "
          f"run's bit for bit: {same} ({differ} X_test values differ, max gap "
          f"{float(np.abs(card['X_test'] - cpu['X_test']).max()):.3e}); SMOTE: "
          f"{card['X_res'].shape[0]} rows, classes "
          f"{counts.tolist()}; feature list {(tools / 'pre_card' / 'feature_names.json').exists()}")
    if not same or counts.size != 2 or counts[0] != counts[1]:
        raise AssertionError("phase8 preprocess: X_test/y_test differ from the CPU run's "
                             "or SMOTE did not balance the classes")

    # 2. evaluate both families on the committed CSV, on the card and the CPU
    x_test, _, _, _ = tool_split(csv)
    for family, model_dir in (("logistic", lin_dir), ("gbt", gbt_dir)):
        res, _ = run(f"evaluate {family} (committed CSV, {len(x_test)} test rows)",
                     f"evaluate_{family}",
                     lambda: evaluate(str(csv), str(model_dir), None, device="cuda"))
        ref = evaluate(str(csv), str(model_dir), None, device="cpu")
        want = (logistic_scores_f64(model_dir, x_test) if family == "logistic"
                else 1.0 / (1.0 + np.exp(-forest_logits_f64(model_dir, x_test))))
        err = float(np.abs(res["scores"] - want).max())
        print(f"phase8: evaluate {family}: confusion matrix {res['confusion_matrix']} "
              f"(cpu {ref['confusion_matrix']}), AUC {res['auc']:.6f} (card - cpu "
              f"{res['auc'] - ref['auc']:+.3e}), max |score - f64| {err:.3e}")
        if res["confusion_matrix"] != ref["confusion_matrix"] or \
                not abs(res["auc"] - ref["auc"]) <= 1e-6 or not err <= SCORE_ATOL:
            raise AssertionError(f"phase8 evaluate {family}: off the CPU run or float64")

    # 3. explain the forest over the committed CSV's test split
    res, _ = run(f"explain gbt (committed CSV, {len(x_test)} rows)", "explain_gbt",
                 lambda: explain(str(csv), str(gbt_dir), None, device="cuda"))
    ref, cpu_wall = sync_wall(lambda: explain(str(csv), str(gbt_dir), None, device="cpu"))
    err, add = check_phi("explain", res["phi"], res["expected_value"], ref["phi"],
                         forest_logits_f64(gbt_dir, x_test))
    ties = top10_agree("explain", np.abs(res["phi"]).mean(0), np.abs(ref["phi"]).mean(0))
    print(f"phase8: explain gbt: phi ({res['n_rows']} x {res['phi'].shape[1]}) within "
          f"{err:.3e} of the CPU run's plain TreeSHAP on every row ({cpu_wall:.3f} s on "
          f"the CPU), additivity max |sum phi + E[f] - f(x)| {add:.3e}; top-10 "
          f"{list(res['mean_abs_shap'])} equal the CPU's ({ties} positions across a tie)")

    # 4. the Kaggle file's scale: 284,807 rows, 492 frauds expected
    kaggle = tools / "kaggle.csv"
    _, gen_wall = sync_wall(lambda: generate_synthetic_data(
        str(kaggle), n_samples=KAGGLE_ROWS, fraud_ratio=KAGGLE_FRAUDS / KAGGLE_ROWS, seed=0))
    kx, ky, k_min, k_frauds = tool_split(kaggle)
    print(f"phase8: the Kaggle-sized set generated in {gen_wall:.3f} s: {KAGGLE_ROWS} rows, "
          f"{k_frauds} frauds; test split {len(ky)} rows")
    res, _ = run("preprocess (Kaggle-sized)", "preprocess",
                 lambda: preprocess(str(kaggle), str(tools / "kaggle.npz"),
                                    str(tools / "kaggle_models"), device="cuda"))
    print(f"phase8: preprocess (Kaggle-sized): {res['n_resampled']} resampled rows, "
          f"knn_topk at m = {k_min} minority rows")
    res, _ = run(f"evaluate logistic (Kaggle-sized, {len(ky)} test rows: the 65,536 bucket)",
                 "evaluate_logistic",
                 lambda: evaluate(str(kaggle), str(lin_dir), None, device="cuda"))
    err = float(np.abs(res["scores"] - logistic_scores_f64(lin_dir, kx)).max())
    print(f"phase8: evaluate logistic (Kaggle-sized): AUC {res['auc']:.6f}, confusion "
          f"matrix {res['confusion_matrix']}, max |score - f64| {err:.3e}")
    if res["scores"].shape != (len(ky),) or not err <= SCORE_ATOL:
        raise AssertionError(f"phase8 evaluate (Kaggle-sized): scores off by {err:.3e}")
    res, _ = run(f"explain gbt (Kaggle-sized, max_rows {TOOL_EXPLAIN_ROWS})", "explain_gbt",
                 lambda: explain(str(kaggle), str(gbt_dir), None, max_rows=TOOL_EXPLAIN_ROWS,
                                 device="cuda"))
    xs = kx[:TOOL_EXPLAIN_ROWS]
    rows = np.sort(np.random.default_rng(0).choice(len(xs), TOOL_SAMPLED_ROWS, replace=False))
    ref_model = load_any_model(str(gbt_dir), device="cpu")
    ref_phi, cpu_wall = sync_wall(lambda: tree_shap(
        ref_model.raw_explainer(), torch.from_numpy(xs[rows])).numpy())
    err, add = check_phi("explain (Kaggle-sized)", res["phi"], res["expected_value"],
                         ref_phi, forest_logits_f64(gbt_dir, xs), rows)
    ties = top10_agree("explain (Kaggle-sized)", np.abs(res["phi"][rows]).mean(0),
                       np.abs(ref_phi).mean(0))
    print(f"phase8: explain gbt (Kaggle-sized): tree_shap at n = {res['n_rows']}; phi within "
          f"{err:.3e} of the CPU plain TreeSHAP on {len(rows)} rows sampled across the "
          f"batch ({cpu_wall:.3f} s on the CPU), additivity on every row {add:.3e}; the "
          f"sample's top-10 equal the CPU's ({ties} positions across a tie)")

    # 5. validate_auc against phase 4's registry: the file store, then HTTP
    pin_tracking_store(lin_root, tools)
    (auc_file, ok_file), _ = run("validate_auc (file store)", "validate_auc",
                                 lambda: validate_auc(device="cuda"))
    server, uri = start_tracking_server(lin_root, tools / "tracking_server.log")
    try:
        os.environ["MLFLOW_TRACKING_URI"] = uri
        (auc_http, ok_http), _ = run(f"validate_auc (tracking server {uri})", "validate_auc",
                                     lambda: validate_auc(device="cuda"))
        cached = sorted(str(p.relative_to(tools)) for p in
                        (tools / "registry_cache").rglob("model.npz"))
        failed = tool_cli("validate_auc", ["--threshold", "1.01"], tools)
        client = TrackingClient(uri)
        logged = [client.get_run("model-validation", r)
                  for r in client.list_runs("model-validation")]
        tags = sorted(r.tags["validation_pass"] for r in logged)
        print(f"phase8: validate_auc: AUC {auc_file:.6f} through the file store, "
              f"{auc_http:.6f} through the server (artifact unpacked to {cached}); "
              f"pass {ok_file}/{ok_http}; the CLI with --threshold 1.01 exited "
              f"{failed.returncode} ({failed.stdout.strip()}); {len(logged)} "
              f"model-validation runs read back over HTTP, validation_pass {tags}")
        if auc_file != auc_http or not (ok_file and ok_http) or failed.returncode != 1 \
                or not cached or tags != ["False", "True", "True"] \
                or any(r.params != {"model_uri": "models:/fraud@prod"} for r in logged):
            raise AssertionError("phase8 validate_auc: the two gates or the logged runs "
                                 "disagree" + failed.stderr[-2000:])
    finally:
        server.terminate()
        server.wait(timeout=60)

    # 6. predict_single on phase 4's registry: in process, then its CLI
    os.environ["MLFLOW_TRACKING_URI"] = lin_store
    os.environ["MODEL_PATH"] = str(tools / "absent" / "model.npz")  # the registry or nothing
    det = FraudDetector(device="cuda")
    (label, proba), _ = run("predict_single (predict, then predict_proba)", "predict_single",
                            lambda: (det.predict(_DEMO_ROW), det.predict_proba(_DEMO_ROW)))
    row = np.asarray([[_DEMO_ROW[n] for n in det.model.feature_names]], np.float32)
    want = float(logistic_scores_f64(lin_dir, row)[0])
    cli = tool_cli("predict_single", [], tools)
    found = re.search(r"prediction: (\d) .*P\(fraud\) = ([0-9.]+)", cli.stdout)
    print(f"phase8: predict_single: label {label}, P(fraud) {proba:.9f} (f64 {want:.9f}); "
          f"CLI exited {cli.returncode}: {cli.stdout.strip()}")
    if found is None or cli.returncode != 0 or "registry:models:/fraud@prod" not in cli.stderr:
        raise AssertionError(f"phase8 predict_single CLI: {cli.stdout} {cli.stderr[-2000:]}")
    check_source("phase8 predict_single CLI",
                 re.search(r"using model from (\S+)", cli.stderr).group(1),
                 "registry:models:/fraud@prod")
    if not abs(proba - want) <= SCORE_ATOL or label != int(want >= 0.5) or \
            int(found.group(1)) != label or not abs(float(found.group(2)) - want) <= SCORE_ATOL:
        raise AssertionError(f"phase8 predict_single: {label} {proba} vs f64 {want}")

    # 7. eda without plots
    out_csv = tools / "processed_data.csv"
    res, _ = run("eda --no-plots (committed CSV)", "eda",
                 lambda: eda(str(csv), None, str(out_csv), device="cuda"))
    raw = np.loadtxt(csv, delimiter=",", skiprows=1, dtype=np.float64)
    back = np.loadtxt(out_csv, delimiter=",", skiprows=1, dtype=np.float64)
    header = out_csv.read_text().splitlines()[0].split(",")
    x32 = raw[:, :30].astype(np.float32)
    scaled = [(x32[:, c].astype(np.float64) - x32[:, c].mean(dtype=np.float64))
              / x32[:, c].std(dtype=np.float64) for c in (29, 0)]
    gap = max(float(np.abs(back[:, 28 + i] - scaled[i]).max()) for i in range(2))
    print(f"phase8: eda: {res['n_rows']} rows, {res['n_fraud']} frauds; processed CSV "
          f"{back.shape} parses back, header ends {header[-3:]}, scaled columns within "
          f"{gap:.3e} of float64")
    if res != {"n_rows": len(raw), "n_fraud": int(raw[:, 30].sum())} or \
            back.shape != (len(raw), 31) or header[-3:] != ["scaled_amount", "scaled_time",
                                                             "Class"] or \
            back[:, :28].astype(np.float32).tobytes() != x32[:, 1:29].tobytes() or \
            not np.array_equal(back[:, 30], raw[:, 30]) or not gap <= 1e-4:
        raise AssertionError("phase8 eda: counts or the processed CSV are off")
    print(f"phase8: offline tools in {time.perf_counter() - t_phase:.3f} s; kernel launches "
          f"over the phase {run.total}")
    return run.total


# ---------------------------------------------------------------------------
# phase 9: the quantized h2d wires
# ---------------------------------------------------------------------------


def wire_xf(scorer, rows):
    """The values a scorer's wire delivers to the model, from its own host
    encode: the dequantized int8 codes (one float32 multiply, as the flush
    makes it), the bf16-rounded rows, or the rows."""
    import numpy as np
    import torch

    hx = scorer._prepare_host(np.ascontiguousarray(rows, np.float32))
    if isinstance(hx, torch.Tensor):
        return hx.float().numpy()
    if hx.dtype == np.int8:
        return hx.astype(np.float32) * scorer._quant_scale
    return hx


def wire_references(family: str, model_dir: Path, rows, xf):
    """(float64 scores on ``xf``, float64 scores on the raw rows, φ on
    ``xf`` from numpy (logistic) or the port's CPU plain TreeSHAP (GBT),
    the model's feature names)."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.ops.tree_shap import tree_shap

    if family == "logistic":
        z = np.load(model_dir / "model.npz")
        w32 = z["coef"].astype(np.float32) / z["scaler_scale"].astype(np.float32)
        phi = w32 * (xf - z["scaler_mean"].astype(np.float32))
        names = load_any_model(str(model_dir), device="cpu").feature_names
        return logistic_scores_f64(model_dir, xf), logistic_scores_f64(model_dir, rows), phi, names
    ref = load_any_model(str(model_dir), device="cpu")
    phi = tree_shap(ref.raw_explainer(), torch.from_numpy(np.ascontiguousarray(xf))).numpy()
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    return (sig(forest_logits_f64(model_dir, xf)), sig(forest_logits_f64(model_dir, rows)),
            phi, ref.feature_names)


def wire_served(work: Path, family: str, wire: str, model_dir: Path, store: Path,
                source: str, x) -> dict:
    """One family on one narrow wire over HTTP: 128 ``/predict`` from 32
    threads, then 32 one at a time, under zeroed launch counts; checked
    against float64 on the wire's values, the f32 wire's scores (JAX's
    gate) and the reason codes' references."""
    import numpy as np

    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.service.app import create_app

    tag = f"phase9 {family} {wire}"
    os.environ.update(DEVICE="cuda", SCORER_EXPLAIN="topk", SCORER_WIRE=wire,
                      MODEL_PATH=str(model_dir / "model.npz"))
    for knob in ("SCORER_MAX_BATCH", "SCORER_FUSED_FLUSH", "SCORER_EXPLAIN_K",
                 "SCORER_RETURN_WIRE"):
        os.environ.pop(knob, None)
    pin_tracking_store(store, work)
    app = create_app(database_url=f"sqlite:///{work}/wire_{family}_{wire}_fraud.db",
                     broker_url=f"sqlite:///{work}/wire_{family}_{wire}_taskq.db")
    port = free_port()
    server = ServerThread(app, port)
    t0 = time.perf_counter()
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"{tag}: server did not start: {server.error!r}")
    try:
        batcher = app.state["batcher"]
        if batcher is None or app.state["watchtower"] is None:
            raise AssertionError(f"{tag}: app started degraded (no batcher/watchtower)")
        scorer = batcher.scorer
        print(f"{tag}: app started in {time.perf_counter() - t0:.3f} s, scorer wire "
              f"{scorer.io_dtype}")
        check_source(tag, app.state["model_source"], source)
        if scorer.io_dtype != wire:
            raise AssertionError(f"{tag}: the app serves the {scorer.io_dtype} wire")
        _, body = http_call(port, "GET", "/metrics")
        keys = ('scorer_flushes_total{path="fused",shard="0"}',
                'scorer_flushes_total{path="split",shard="0"}', "scorer_microbatch_size_count")
        before = {key: metric_value(body.decode(), key) for key in keys}
        rows = x[:WIRE_REQUESTS + WIRE_SEQUENTIAL]
        kernels.reset_launch_counts()
        concurrent, wall = drive_clients(port, rows[:WIRE_REQUESTS], WIRE_CLIENTS, work)
        sequential, wall_seq = drive_clients(port, rows[WIRE_REQUESTS:], 1, work)
        launches = kernels.launch_counts()
        _, body = http_call(port, "GET", "/metrics")
        text = body.decode()
        delta = {key: metric_value(text, key) - v for key, v in before.items()}
        flushes = delta["scorer_microbatch_size_count"]

        xf = wire_xf(scorer, rows)
        want, f32, phi, names = wire_references(family, model_dir, rows, xf)
        k = batcher.explain_k
        want_idx = topk_total_order(phi, k)
        srt = -np.sort(-phi, axis=1)
        rtol, atol = (0.0, 1e-6) if family == "logistic" else (SHAP_RTOL, SHAP_ATOL)
        scores, tie_rows = [], 0
        for i, (status, body, _) in enumerate(concurrent + sequential):
            if status != 200:
                raise AssertionError(f"{tag} /predict {i}: HTTP {status} {body[:200]!r}")
            out = json.loads(body)
            scores.append(out["score"])
            got = [rc["feature"] for rc in out["reason_codes"] or []]
            if got != [names[j] for j in want_idx[i]]:
                if not abs(srt[i, k - 1] - srt[i, k]) <= SHAP_TIE:
                    raise AssertionError(f"{tag} /predict {i}: reason codes {got}")
                tie_rows += 1
            vals = np.array([rc["attribution"] for rc in out["reason_codes"]])
            if not np.allclose(vals, phi[i, [names.index(f) for f in got]], rtol=rtol, atol=atol):
                raise AssertionError(f"{tag} /predict {i}: attributions {vals}")
        scores = np.asarray(scores)
        err = float(np.abs(scores - want).max())
        gap = np.abs(scores - f32)
        print(f"{tag}: {WIRE_REQUESTS} /predict from {WIRE_CLIENTS} client threads in "
              f"{wall:.3f} s ({WIRE_REQUESTS / wall:.1f} req/s), latency "
              + latency_line([r[2] for r in concurrent]) + f"; {WIRE_SEQUENTIAL} one at a "
              f"time, latency " + latency_line([r[2] for r in sequential]) + " (client clock)")
        print(f"{tag}: max |score - f64 on the wire's values| {err:.3e}; against the f32 "
              f"wire's f64 scores max {gap.max():.3e}, mean {gap.mean():.3e}; reason codes "
              f"equal the {'numpy ranking' if family == 'logistic' else 'CPU plain TreeSHAP'} "
              f"on {len(scores) - tie_rows} rows, {tie_rows} across a tie within {SHAP_TIE}")
        if not err <= SCORE_ATOL:
            raise AssertionError(f"{tag}: scores off float64 on the wire's values by {err:.3e}")
        if not (gap.max() <= WIRE_GATE_ATOL and gap.mean() < WIRE_GATE_MEAN):
            raise AssertionError(f"{tag}: outside JAX's gate of the f32 wire")
        wire_fused = metric_value(text, "scorer_wire_fused")
        explain_fused = metric_value(text, "scorer_explain_fused")
        print(f"{tag}: scorer_wire_fused {wire_fused:g}, scorer_explain_fused "
              f"{explain_fused:g}; {flushes:g} flushes, fused "
              f"{delta[keys[0]]:g}, split {delta[keys[1]]:g}; kernel launches {launches}")
        if wire_fused != 1 or explain_fused != 1 or flushes < 1 or \
                delta[keys[0]] != flushes or delta[keys[1]] != 0:
            raise AssertionError(f"{tag}: not every flush ran fused with reason codes")
        kernel = EXPLAIN_KERNELS[family]
        if launches.get(kernel, 0) < (1 if family == "logistic" else flushes):
            raise AssertionError(f"{tag}: {kernel} launched {launches.get(kernel)} times "
                                 f"in {flushes:g} flushes")
    finally:
        server.stop()
    return launches


def wire_flush_timing(family: str, model_dir: Path, x) -> dict:
    """One 1024-row fused flush with explain per wire (f32, bf16, int8),
    through the micro-batcher's ``_flush_device`` (stage, encode, h2d,
    flush, fetch), the wires in turns: host time (p50 of 30), stream time
    from CUDA events around each flush, device busy time and launches
    (profiler, mean of 5) and h2d bytes."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.monitor.baseline import load_profile
    from fraud_detection_tpu_torch.monitor.watchtower import Watchtower
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    rows = np.concatenate([x] * (1024 // len(x) + 1))[:1024]
    batch = [(rows[i], None) for i in range(1024)]
    profile = load_profile(str(model_dir))
    flushes, watchtowers, out = {}, [], {}
    try:
        for wire in WIRE_NAMES:
            os.environ["SCORER_WIRE"] = wire
            wt = Watchtower(profile, device="cuda")
            watchtowers.append(wt)
            b = MicroBatcher(load_any_model(str(model_dir), device="cuda").scorer,
                             max_batch=1024, watchtower=wt, fused=True, explain=True,
                             explain_k=3)
            scorer = b.scorer
            target = b._fused_target(scorer)
            slot = scorer.staging.acquire(1024)
            io = slot.io if isinstance(slot.io, torch.Tensor) else torch.from_numpy(slot.io)
            h2d = io.numel() * io.element_size() + slot.valid.nbytes
            scorer.staging.release(slot)

            def flush(b=b, scorer=scorer, target=target):
                scorer.staging.release(b._flush_device(scorer, target, batch)[-1])

            for _ in range(5):
                flush()
            reps = 5
            acts = profiled_intervals(lambda: [flush() for _ in range(reps)])
            copies = sum(1 for name, _, _ in acts if "Memcpy" in name or "Memset" in name)
            flushes[wire] = flush
            out[wire] = {"busy_us": union_us([(a, c) for _, a, c in acts]) / reps,
                         "launches": (len(acts) - copies) / reps, "copies": copies / reps,
                         "h2d_bytes": h2d, "host": [], "stream": []}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(WIRE_FLUSH_TIMED):
            for wire, flush in flushes.items():
                t = time.perf_counter()
                start.record()
                flush()
                end.record()
                end.synchronize()
                out[wire]["host"].append(time.perf_counter() - t)
                out[wire]["stream"].append(start.elapsed_time(end))
    finally:
        for wt in watchtowers:
            wt.close()
    for wire, v in out.items():
        host, stream = sorted(v.pop("host")), sorted(v.pop("stream"))
        v.update(host_ms=host[len(host) // 2] * 1e3, stream_ms=stream[len(stream) // 2])
        print(f"phase9: {family} 1024-row fused flush with explain, {wire} wire (the three "
              f"wires in turns): host time p50 {v['host_ms']:.3f} ms (min {host[0] * 1e3:.3f}) "
              f"over {WIRE_FLUSH_TIMED}; stream time p50 {v['stream_ms']:.3f} ms (CUDA events "
              f"around each flush); device busy {v['busy_us']:.3f} us, {v['launches']:g} kernel "
              f"launches + {v['copies']:g} copies/memsets (profiler, mean of 5); h2d "
              f"{v['h2d_bytes']} B")
    return out


def wire_streams(kaggle_csv: Path, lin_dir: Path, gbt_dir: Path) -> dict:
    """``predict_proba_stream`` over the Kaggle-sized set's rows (chunk
    32,768, 8 in flight): the three h2d wires × the three return wires for
    the logistic model, f32 and int8 (f32 return) for the forest. Each is
    checked, called once to warm, then timed on the host's clock with the
    device synchronised over ``STREAM_ROUNDS`` rounds that take every
    combination in turn (median and min)."""
    import numpy as np

    from fraud_detection_tpu_torch.data.loader import load_creditcard_csv
    from fraud_detection_tpu_torch.models import load_any_model

    x, y, _ = load_creditcard_csv(str(kaggle_csv))
    n = len(x)
    plans = [("logistic", lin_dir, w, RETURN_WIRE_NAMES) for w in WIRE_NAMES]
    plans += [("gbt", gbt_dir, w, ("float32",)) for w in ("float32", "int8")]
    runs, scores = {}, {}
    for family, d, wire, rets in plans:
        os.environ["SCORER_WIRE"] = wire
        scorer = load_any_model(str(d), device="cuda").scorer
        xf = wire_xf(scorer, x)
        want = (logistic_scores_f64(d, xf) if family == "logistic"
                else 1.0 / (1.0 + np.exp(-forest_logits_f64(d, xf))))
        for ret in rets:
            def stream(scorer=scorer, ret=ret):
                return scorer.predict_proba_stream(x, chunk=STREAM_CHUNK,
                                                   inflight=STREAM_INFLIGHT, out_dtype=ret)
            got = stream()
            if ret == "float32":
                err, tol = float(np.abs(got - want).max()), SCORE_ATOL
            else:  # against the same wire's f32 return, within the return wire's step
                err = float(np.abs(got - scores[family, wire, "float32"]).max())
                tol = RETURN_WIRE_TOL[ret]
            print(f"phase9: predict_proba_stream {family} {n} rows, {wire} wire, {ret} return: "
                  f"max |score - {'f64 on the wire values' if ret == 'float32' else 'the f32 return'}| "
                  f"{err:.3e}")
            if got.shape != (n,) or not err <= tol:
                raise AssertionError(f"phase9 stream {family} {wire} {ret}: off by {err:.3e}")
            scores[family, wire, ret] = got
            runs[family, wire, ret] = stream
    walls = {key: [] for key in runs}
    for _ in range(STREAM_ROUNDS):
        for key, stream in runs.items():
            walls[key].append(sync_wall(stream)[1])
    out = {}
    for (family, wire, ret), w in walls.items():
        w.sort()
        out[family, wire, ret] = w[len(w) // 2]
        elem = {"float32": 4, "bfloat16": 2, "int8": 1}[wire]
        print(f"phase9: predict_proba_stream {family} {n} rows, {wire} wire, {ret} return: "
              f"{w[len(w) // 2]:.6f} s median, {w[0]:.6f} s min of {STREAM_ROUNDS} in turns "
              f"(host clock, device synchronised); h2d {n * 30 * elem} B of rows")
    ref = scores["logistic", "float32", "float32"]
    os.environ["SCORER_WIRE"] = "int8"
    q8 = load_any_model(str(lin_dir), device="cuda").scorer
    clipped = (np.abs(q8._prepare_host(x)) == 127).any(axis=1)
    fraud = y == 1
    bound = lattice_bound(lin_dir, q8)
    for (family, wire, ret), got in scores.items():
        if family != "logistic" or wire == "float32":
            continue
        gap = np.abs(got - ref)
        tol = RETURN_WIRE_TOL.get(ret, 0.0)
        print(f"phase9: stream logistic {wire} wire, {ret} return against the f32 wire: max "
              f"{gap.max():.3e}, mean {gap.mean():.3e}, {int((gap > WIRE_GATE_ATOL).sum())} rows "
              f"above {WIRE_GATE_ATOL}" + (f"; rows inside the lattice max "
              f"{gap[~clipped].max():.3e} (bound {bound + tol:.3e}); {int(clipped.sum())} rows "
              f"clip a code, {int((clipped & fraud).sum())} of them frauds (of "
              f"{int(fraud.sum())}); frauds' gap max {gap[fraud].max():.3e}, mean "
              f"{gap[fraud].mean():.3e}" if wire == "int8" else ""))
        if not gap.mean() < WIRE_GATE_MEAN:
            raise AssertionError(f"phase9 stream {wire} {ret}: mean gap {gap.mean():.3e}")
        if wire == "int8" and not gap[~clipped].max() <= bound + tol:
            raise AssertionError(f"phase9 stream int8 {ret}: a row inside the lattice is off "
                                 f"the f32 wire by more than half a step a feature allows")
        if wire == "bfloat16" and not gap.max() <= WIRE_GATE_ATOL:
            raise AssertionError(f"phase9 stream bf16 {ret}: outside JAX's gate")
    gap = np.abs(scores["gbt", "int8", "float32"] - scores["gbt", "float32", "float32"])
    print(f"phase9: stream gbt int8 wire against the f32 wire: max {gap.max():.3e}, mean "
          f"{gap.mean():.3e}, frauds' mean {gap[fraud].mean():.3e} (JAX gates the forest's int8 "
          f"wire by drift PSI, not by score)")
    return out


def lattice_bound(model_dir: Path, scorer) -> float:
    """The most a row whose codes do not clip can move in probability on
    the int8 wire: half a lattice step a feature through the folded
    weights, a quarter of that in probability (sigmoid's slope), plus
    float32 rounding."""
    import numpy as np

    with np.load(model_dir / "model.npz") as z:
        w = np.abs(z["coef"].astype(np.float64) / z["scaler_scale"])
    return float((w * scorer._quant_scale.astype(np.float64) / 2).sum() / 4 + 1e-5)


def quantized_wires(work: Path, gbt_store: str, kaggle_csv: Path) -> dict:
    """Phase 9: both families served over HTTP on the int8 and the bf16
    wire (phase 3's logistic directory from an empty store, phase 5's
    forest from its registry), a 1024-row flush per wire and family, and
    the chunked stream at the Kaggle scale. Returns the served requests'
    kernel launches."""
    import numpy as np

    t_phase = time.perf_counter()
    lin_dir, gbt_dir = work / "models", work / "gbt_served"
    x = np.loadtxt(ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
                   max_rows=WIRE_REQUESTS + WIRE_SEQUENTIAL, dtype=np.float32)[:, :30]
    launches: dict[str, int] = {}
    for wire in ("int8", "bfloat16"):
        for family, d, store, source in (
            ("logistic", lin_dir, work / "empty_mlruns", f"native:{lin_dir}"),
            ("gbt", gbt_dir, Path(gbt_store.removeprefix("file:")),
             "registry:models:/fraud@prod"),
        ):
            got = wire_served(work, family, wire, d, store, source, x)
            for key, v in got.items():
                launches[key] = launches.get(key, 0) + v
    for family, d in (("logistic", lin_dir), ("gbt", gbt_dir)):
        wire_flush_timing(family, d, x)
    wire_streams(kaggle_csv, lin_dir, gbt_dir)
    os.environ.pop("SCORER_WIRE", None)
    print(f"phase9: quantized wires in {time.perf_counter() - t_phase:.3f} s; kernel launches "
          f"over the served requests {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the native CSV reader, the ingest lanes, spyglass, shadow, legacy
# ---------------------------------------------------------------------------

#: the lanes' frames: the same rows as one frame each of these sizes
INGEST_ROWS = 1024
INGEST_FRAME_SIZES = (1, 64, 1024)
INGEST_COUNTED_FRAMES = 8  # 1024-row frames under the launch counts
INGEST_ALLOC_FRAMES = 100  # frames over which the staging pool must not grow
INGEST_CONNECTIONS, INGEST_CONN_FRAMES = 4, 40  # the throughput probe
INGEST_FLUSH_TIMED = 30  # 1024-row flushes a telemetry setting, in turns
CSV_TIMED_ROUNDS = 5  # native reader and np.loadtxt, in turns
DIGITS18_ROWS = 20_000  # the 16-18-digit fixture's rows (31 columns)
SHADOW_FRAMES = 8  # 1024-row frames the shadow challenger samples
SHADOW_HALFLIFE_ROWS = 4096
SHADOW_TOL = 1e-6  # the shadow's window against a numpy recomputation
INGEST_KERNELS = {"logistic": "fused_score", "gbt": "tree_shap"}

#: the binary lane's throughput client, its own process: sends one prebuilt
#: frame ``frames`` times on each of ``conns`` connections (stdlib only) and
#: prints the wall time and the count of non-OK responses
LANE_CLIENT = r"""
import socket, struct, sys, threading, time
port, path, conns, frames = (int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),
                             int(sys.argv[4]))
frame = open(path, "rb").read()
HDR = struct.Struct(">I")

def read_exact(s, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("lane closed the connection")
        buf += chunk
    return bytes(buf)

def read_frame(s):
    (n,) = HDR.unpack(read_exact(s, 4))
    return read_exact(s, n)

socks = []
for _ in range(conns):
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    read_frame(s)  # the HELLO
    socks.append(s)
bad = []

def run(s):
    for _ in range(frames):
        s.sendall(frame)
        if read_frame(s)[3] != 0:  # the status byte
            bad.append(1)

threads = [threading.Thread(target=run, args=(s,)) for s in socks]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
for s in socks:
    s.close()
print(wall, len(bad))
"""


def post_raw(port: int, path: str, body: bytes, ctype: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body,
                     headers={"content-type": ctype, "connection": "close"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def f32_ulps(a, b) -> int:
    """Largest distance of two float32 arrays in units in the last place."""
    import numpy as np

    ia = np.asarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def digits18_csv(path: Path, rows: int, seed: int = 0) -> None:
    """Values of 16 to 18 significant digits (the real Kaggle file writes
    up to 18), the decimal point at a random place."""
    import numpy as np

    rng = np.random.default_rng(seed)
    digits = rng.integers(16, 19, (rows, 31))
    mant = rng.integers(10 ** 15, 10 ** 18, (rows, 31), dtype=np.int64)
    point = rng.integers(1, 16, (rows, 31))
    sign = rng.random((rows, 31)) < 0.5
    lines = [",".join(f"c{j}" for j in range(31))]
    for i in range(rows):
        fields = []
        for j in range(31):
            m = str(int(mant[i, j]))[: int(digits[i, j])]
            p = int(point[i, j])
            fields.append(("-" if sign[i, j] else "") + m[:p] + "." + m[p:])
        lines.append(",".join(fields))
    path.write_text("\n".join(lines) + "\n")


def native_csv_checks(work: Path, kaggle_csv: Path, lin_dir: Path, gbt_dir: Path) -> None:
    """The native reader: bitwise np.loadtxt(float64).astype(float32) on the
    committed and the Kaggle-sized CSV, within 1 ulp on 16-18-digit values,
    no fall-through; timed against np.loadtxt in turns; the Kaggle-scale
    tools with NATIVE_CSV=0 and =1 in turns."""
    import numpy as np

    from fraud_detection_tpu_torch.data import native
    from fraud_detection_tpu_torch.evaluate import evaluate
    from fraud_detection_tpu_torch.explain import explain
    from fraud_detection_tpu_torch.preprocess import preprocess

    fallbacks0 = native.NATIVE_CSV_FALLBACKS
    plain = {}
    for tag, csv in (("committed", ROOT / "data" / "creditcard.csv"), ("Kaggle-sized", kaggle_csv)):
        got, names = native.load_csv_native(str(csv))
        plain[tag] = want = np.loadtxt(csv, delimiter=",", skiprows=1,
                                       dtype=np.float64).astype(np.float32)
        same = got.tobytes() == want.tobytes()
        print(f"phase10: native CSV reader on the {tag} CSV {got.shape}: bitwise "
              f"np.loadtxt(float64).astype(float32): {same}; {len(names)} columns")
        if not same or got.shape != want.shape:
            raise AssertionError(f"phase10: the native reader differs on the {tag} CSV")
    d18 = work / "digits18.csv"
    digits18_csv(d18, DIGITS18_ROWS)
    got, _ = native.load_csv_native(str(d18))
    want = np.loadtxt(d18, delimiter=",", skiprows=1, dtype=np.float64).astype(np.float32)
    differ, ulps = int((got != want).sum()), f32_ulps(got, want)
    print(f"phase10: native CSV reader on {DIGITS18_ROWS} x 31 values of 16-18 significant "
          f"digits: {differ} of {got.size} values differ from np.loadtxt, at most {ulps} ulp")
    if ulps > 1:
        raise AssertionError(f"phase10: 16-18-digit values {ulps} ulp off np.loadtxt")
    if native.NATIVE_CSV_FALLBACKS != fallbacks0:
        raise AssertionError("phase10: the native reader fell through to np.loadtxt")
    print(f"phase10: NATIVE_CSV_FALLBACKS {native.NATIVE_CSV_FALLBACKS}")
    t_nat, t_txt = [], []
    for _ in range(CSV_TIMED_ROUNDS):
        t = time.perf_counter()
        native.load_csv_native(str(kaggle_csv))
        t_nat.append(time.perf_counter() - t)
        t = time.perf_counter()
        np.loadtxt(kaggle_csv, delimiter=",", skiprows=1, dtype=np.float64)
        t_txt.append(time.perf_counter() - t)
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    print(f"phase10: parse of the Kaggle-sized CSV ({KAGGLE_ROWS} x 31), median of "
          f"{CSV_TIMED_ROUNDS} in turns (host clock): native {med(t_nat) * 1e3:.3f} ms, "
          f"np.loadtxt {med(t_txt) * 1e3:.3f} ms")
    out = work / "ingest_tools"
    out.mkdir()
    tools = (
        ("preprocess", lambda: preprocess(str(kaggle_csv), str(out / "k.npz"),
                                          str(out / "k_models"), device="cuda")),
        ("evaluate logistic", lambda: evaluate(str(kaggle_csv), str(lin_dir), None,
                                               device="cuda")),
        (f"explain gbt (max_rows {TOOL_EXPLAIN_ROWS})",
         lambda: explain(str(kaggle_csv), str(gbt_dir), None, max_rows=TOOL_EXPLAIN_ROWS,
                         device="cuda")),
    )
    for label, fn in tools:
        walls = {}
        for setting in ("0", "1"):
            os.environ["NATIVE_CSV"] = setting
            _, walls[setting] = sync_wall(fn)
        print(f"phase10: {label} (Kaggle-sized) {walls['0']:.3f} s with np.loadtxt, "
              f"{walls['1']:.3f} s with the native reader (host clock, device "
              f"synchronised, in turns)")
    os.environ.pop("NATIVE_CSV", None)


def ingest_lanes(work: Path, family: str, model_dir: Path, store: Path, source: str,
                 x, card: str) -> dict:
    """One family's app with the binary lane: launches a 1024-row frame,
    the same rows through the lane (frames of 1, 64, 1024), /ingest/batch
    and /predict bitwise, the int8 layout, refused frames, staging
    allocations, the lanes' rates, the flight recorder, the fence's price.
    Returns the lane traffic's kernel launches and /predict's scores."""
    import numpy as np

    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.service import binlane, metrics
    from fraud_detection_tpu_torch.service.app import create_app
    from fraud_detection_tpu_torch.telemetry import STAGES

    tag = f"phase10 {family}"
    lane_port = free_port()
    os.environ.update(DEVICE="cuda", SCORER_EXPLAIN="topk", INGEST_PORT=str(lane_port),
                      INGEST_HOST="127.0.0.1", MODEL_PATH=str(model_dir / "model.npz"))
    for knob in ("SCORER_MAX_BATCH", "SCORER_FUSED_FLUSH", "SCORER_EXPLAIN_K",
                 "SCORER_RETURN_WIRE", "SCORER_WIRE", "SPYGLASS_ENABLED",
                 "INGEST_MAX_ROWS", "WATCHTOWER_RETRAIN_TRIGGER"):
        os.environ.pop(knob, None)
    pin_tracking_store(store, work)
    app = create_app(database_url=f"sqlite:///{work}/ingest_{family}_fraud.db",
                     broker_url=f"sqlite:///{work}/ingest_{family}_taskq.db")
    port = free_port()
    server = ServerThread(app, port)
    t0 = time.perf_counter()
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"{tag}: server did not start: {server.error!r}")
    try:
        batcher, lane = app.state["batcher"], app.state["binlane"]
        if batcher is None or app.state["watchtower"] is None or lane is None:
            raise AssertionError(f"{tag}: app started degraded (batcher, watchtower, lane)")
        check_source(tag, app.state["model_source"], source)
        scorer = batcher.scorer
        names = app.state["model"].feature_names
        print(f"{tag}: app and binary lane (port {lane.port}, {lane.max_rows} rows a "
              f"frame) started in {time.perf_counter() - t0:.3f} s")
        rows = x[:INGEST_ROWS]
        hist = metrics.microbatch_size._children[()]
        kernel = INGEST_KERNELS[family]
        kernels.reset_launch_counts()

        # a 1024-row frame is one flush and one launch of the family's kernel
        with binlane.BinLaneClient("127.0.0.1", lane.port) as cli:
            cli.score_batch(rows)  # settle the pool
            c0, l0 = hist.count, kernels.launch_counts()[kernel]
            for _ in range(INGEST_COUNTED_FRAMES):
                cli.score_batch(rows)
            flushes, launched = hist.count - c0, kernels.launch_counts()[kernel] - l0
        print(f"{tag}: {INGEST_COUNTED_FRAMES} frames of {INGEST_ROWS} rows: {flushes} "
              f"flushes, {kernel} launched {launched} times")
        if flushes != INGEST_COUNTED_FRAMES or launched != INGEST_COUNTED_FRAMES:
            raise AssertionError(f"{tag}: a frame is not one flush and one {kernel} launch")

        # the same rows three ways: frames, /ingest/batch, /predict
        lanes = {}
        with binlane.BinLaneClient("127.0.0.1", lane.port) as cli:
            for size in INGEST_FRAME_SIZES:
                parts = [cli.score_batch(rows[lo:lo + size]) for lo in range(0, INGEST_ROWS, size)]
                lanes[f"frames of {size}"] = (np.concatenate([p[0] for p in parts]),
                                              np.concatenate([p[1][0] for p in parts]))
        status, body = post_raw(port, "/ingest/batch",
                                binlane.encode_frame(rows, length_prefix=False),
                                "application/x-fraud-frame")
        if status != 200:
            raise AssertionError(f"{tag}: /ingest/batch HTTP {status} {body[:200]!r}")
        s, (idx, _) = binlane.decode_response_body(body)
        lanes["/ingest/batch"] = (s, idx)
        results, wall = drive_clients(port, rows, WIRE_CLIENTS, work)
        predict = np.asarray([np.float32(json.loads(b)["score"]) if st == 200 else np.nan
                              for st, b, _ in results], np.float32)
        predict_idx = [[names.index(c["feature"]) for c in json.loads(b)["reason_codes"]]
                       for st, b, _ in results if st == 200]
        if len(predict_idx) != INGEST_ROWS:
            raise AssertionError(f"{tag}: /predict answered {len(predict_idx)} of {INGEST_ROWS}")
        for lane_name, (scores, idx) in lanes.items():
            bitwise = scores.tobytes() == predict.tobytes()
            same_codes = idx.tolist() == predict_idx
            print(f"{tag}: {lane_name}: {INGEST_ROWS} scores bitwise /predict's: {bitwise}; "
                  f"reason codes equal: {same_codes}")
            if not (bitwise and same_codes):
                raise AssertionError(f"{tag}: {lane_name} differs from /predict")
        print(f"{tag}: /predict {INGEST_ROWS} rows from {WIRE_CLIENTS} client threads: "
              f"{INGEST_ROWS / wall:.1f} requests/s (host clock, not a benchmark)")

        # the int8 layout, a poison frame, a truncated frame
        with binlane.BinLaneClient("127.0.0.1", lane.port) as cli:
            if cli.scale is not None:
                q, _ = cli.score_batch(rows, layout=binlane.LAYOUT_INT8)
                gap = np.abs(q - predict)
                print(f"{tag}: int8-layout frame: max |score - f32| {gap.max():.3e}, mean "
                      f"{gap.mean():.3e} (JAX's gate {WIRE_GATE_ATOL:g} / {WIRE_GATE_MEAN:g})")
                if not (gap.max() <= WIRE_GATE_ATOL and gap.mean() <= WIRE_GATE_MEAN):
                    raise AssertionError(f"{tag}: the int8 layout leaves JAX's gate")
            else:
                # no scale in the HELLO: the f32-wire forest carries no scaler,
                # and the JAX lane refuses its int8 frames the same way
                cli.sock.sendall(binlane.encode_frame(
                    rows[:8], scale=np.ones(30, np.float32), layout=binlane.LAYOUT_INT8))
                status, _, _, payload = cli._read_response()
                print(f"{tag}: int8-layout frame refused (status {status}: "
                      f"{payload[4:].decode()}), as by the JAX lane for a family "
                      f"without a scaler on the f32 wire")
                if status != binlane.ST_BAD_FRAME or b"int8 layout" not in payload:
                    raise AssertionError(f"{tag}: an int8 frame was served without a scale")
            bad = rows[:8].copy()
            bad[3, 5] = np.nan
            try:
                cli.score_batch(bad)
            except binlane.FrameError as e:
                print(f"{tag}: poison frame refused: {e}")
            else:
                raise AssertionError(f"{tag}: a NaN frame was scored")
        full = binlane.encode_frame(rows[:64])
        with socket.create_connection(("127.0.0.1", lane.port), timeout=30) as sock:
            sock.recv(4096)  # the HELLO
            sock.sendall(full[: len(full) // 2])  # then the peer goes away
        with binlane.BinLaneClient("127.0.0.1", lane.port) as cli:
            after, _ = cli.score_batch(rows[:64])
        if after.tobytes() != predict[:64].tobytes():
            raise AssertionError(f"{tag}: the lane scores differently after a truncated frame")
        print(f"{tag}: truncated frame dropped its connection; the lane still scores "
              f"bitwise (handler threads alive: {len(lane._threads)})")

        # the lane's rate from 4 connections, its own process
        frame_path = work / f"frame_{family}.bin"
        frame_path.write_bytes(binlane.encode_frame(rows))
        out = subprocess.run([sys.executable, "-c", LANE_CLIENT, str(lane.port),
                              str(frame_path), str(INGEST_CONNECTIONS), str(INGEST_CONN_FRAMES)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"{tag}: lane client failed: {out.stderr[-2000:]}")
        wall, bad = out.stdout.split()
        n = INGEST_CONNECTIONS * INGEST_CONN_FRAMES * INGEST_ROWS
        if int(bad):
            raise AssertionError(f"{tag}: {bad} frames answered with an error")
        print(f"{tag}: binary lane {INGEST_CONNECTIONS} connections x {INGEST_CONN_FRAMES} "
              f"frames of {INGEST_ROWS} rows: {n / float(wall):.1f} rows/s (host clock, "
              f"client in its own process; not a benchmark)")

        # no staging allocation in steady state; the 1024-row frames' stages
        pool = scorer.staging
        with binlane.BinLaneClient("127.0.0.1", lane.port) as cli:
            for _ in range(3):
                cli.score_batch(rows)
            before = pool.allocations
            for _ in range(INGEST_ALLOC_FRAMES):
                cli.score_batch(rows)
        print(f"{tag}: staging allocations over {INGEST_ALLOC_FRAMES} frames after warm-up: "
              f"{before} -> {pool.allocations}")
        if pool.allocations != before:
            raise AssertionError(f"{tag}: steady-state frames allocated staging")
        launches = kernels.launch_counts()
        _, body = http_call(port, "GET", "/debug/flightrecorder")
        rec = json.loads(body)
        frames = [r for r in rec["records"] if r["batch_size"] == INGEST_ROWS]
        if not rec["enabled"] or not frames or any(
                set(r["stages"]) != set(STAGES) or min(r["stages"].values()) <= 0
                for r in frames):
            raise AssertionError(f"{tag}: flight-recorder records lack a stage")
        p50 = {st: sorted(r["stages"][st] for r in frames)[len(frames) // 2] for st in STAGES}
        print(f"{tag}: /debug/flightrecorder {len(rec['records'])} records, six stages each; "
              f"p50 over {len(frames)} 1024-row frames: "
              + ", ".join(f"{st} {v * 1e6:.1f} us" for st, v in p50.items()))

        # the fence's price: a 1024-row flush with spyglass off and on, in turns
        target = batcher._fused_target(scorer)
        batch = [(x[i], None) for i in range(INGEST_ROWS)]
        times = {False: [], True: []}
        for _ in range(INGEST_FLUSH_TIMED):
            for telemetry in (False, True):
                t = time.perf_counter()
                res = batcher._flush_device(scorer, target, batch, telemetry)
                times[telemetry].append(time.perf_counter() - t)
                scorer.staging.release(res[-1])
        med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
        print(f"{tag}: 1024-row fused flush with explain, host p50 of {INGEST_FLUSH_TIMED} in "
              f"turns: SPYGLASS_ENABLED=0 {med[False]:.3f} ms, =1 {med[True]:.3f} ms (one "
              f"CUDA event a flush); {card}")
    finally:
        server.stop()
    os.environ.pop("INGEST_PORT", None)
    if lane._threads or lane._accept_thread.is_alive():
        raise AssertionError(f"{tag}: lane threads outlived the app")
    return {"launches": {kernel: launches[kernel]}, "predict": predict}


def serve_lane_app(work: Path, tag: str, store: Path, **env):
    """An app serving ``store``'s ``@prod`` with the binary lane on an
    ephemeral port; returns (app, server, http port)."""
    from fraud_detection_tpu_torch.service.app import create_app

    os.environ.update(DEVICE="cuda", SCORER_EXPLAIN="topk", INGEST_PORT=str(free_port()),
                      INGEST_HOST="127.0.0.1", MODEL_PATH=str(work / "absent" / "model.npz"),
                      **env)
    pin_tracking_store(store, work)
    name = tag.replace(" ", "_")
    app = create_app(database_url=f"sqlite:///{work}/{name}_fraud.db",
                     broker_url=f"sqlite:///{work}/{name}_taskq.db")
    port = free_port()
    server = ServerThread(app, port)
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"{tag}: server did not start: {server.error!r}")
    check_source(tag, app.state["model_source"], "registry:models:/fraud@prod")
    if app.state["watchtower"] is None or app.state["binlane"] is None:
        server.stop()
        raise AssertionError(f"{tag}: app started without its watchtower or lane")
    return app, server, port


def spread_frames(x, n_frames: int):
    """``n_frames`` frames of 1024 rows, each strided across all of ``x``
    (the committed CSV is in ``Time`` order; the baseline spans it all)."""
    step = len(x) // INGEST_ROWS
    return [x[f:f + step * INGEST_ROWS:step] for f in range(n_frames)]


def shadow_check(work: Path, lin_store: str, x) -> dict:
    """The phase-4 model at @shadow beside phase 3's at @prod: every lane
    batch re-scored off the request path, its window against a numpy
    recomputation. Returns the challenger's fused_score launches."""
    import numpy as np

    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.monitor.baseline import load_profile
    from fraud_detection_tpu_torch.monitor.drift import PSI_EPS
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.service import binlane, metrics
    from fraud_detection_tpu_torch.tracking import TrackingClient

    tag = "phase10 shadow"
    store = work / "shadow_mlruns"
    reg = TrackingClient(f"file:{store}").registry
    reg.set_alias("fraud", "prod", reg.register("fraud", str(work / "models")))
    chal_src = TrackingClient(lin_store).registry.resolve("models:/fraud@prod")
    reg.set_alias("fraud", "shadow", reg.register("fraud", chal_src))
    app, server, _ = serve_lane_app(work, tag, store, WATCHTOWER_SHADOW_SAMPLE="1",
                                    WATCHTOWER_HALFLIFE_ROWS=str(SHADOW_HALFLIFE_ROWS))
    try:
        wt, lane = app.state["watchtower"], app.state["binlane"]
        if wt.shadow is None:
            raise AssertionError(f"{tag}: no shadow challenger bound")
        print(f"{tag}: challenger {wt.challenger_source} beside "
              f"{app.state['model_source']}, sample rate {wt.shadow.sample_rate:g}")
        frames = spread_frames(x, SHADOW_FRAMES)
        batches0 = metrics.watchtower_shadow_batches.get()
        kernels.reset_launch_counts()
        with binlane.BinLaneClient("127.0.0.1", lane.port) as cli:
            champion = [cli.score_batch(rows)[0] for rows in frames]
        if not wt.drain(timeout=120):
            raise AssertionError(f"{tag}: the watchtower did not drain")
        launched = kernels.launch_counts()["fused_score"]
        batches = metrics.watchtower_shadow_batches.get() - batches0
        st = wt.status()["shadow"]
        # the window recomputed in numpy, batch by batch
        ch = load_any_model(chal_src, device="cuda")
        profile = load_profile(str(work / "models"))
        edges = np.asarray(profile.score_edges, np.float64)
        base = np.asarray(profile.score_counts, np.float64)
        r = dis = delta = 0.0
        cnt = np.zeros_like(base)
        for rows, champ in zip(frames, champion):
            c = ch.scorer.predict_proba(rows).astype(np.float64)
            s = champ.astype(np.float64)
            dec = 0.5 ** (len(c) / SHADOW_HALFLIFE_ROWS)
            r = r * dec + len(c)
            dis = dis * dec + float(np.sum((c >= 0.5) != (s >= 0.5)))
            delta = delta * dec + float(np.sum(np.abs(c - s)))
            cnt = cnt * dec + np.bincount(np.searchsorted(edges, c, side="right"),
                                          minlength=base.shape[0])
        p = (cnt + PSI_EPS) / (cnt.sum() + PSI_EPS * len(base))
        q = (base + PSI_EPS) / (base.sum() + PSI_EPS * len(base))
        want = {"disagreement": dis / r, "mean_abs_delta": delta / r,
                "score_psi": float(np.sum((p - q) * np.log(p / q)))}
        gaps = {k: abs(st[k] - v) for k, v in want.items()}
        print(f"{tag}: {SHADOW_FRAMES} frames of {INGEST_ROWS}: watchtower_shadow_batches "
              f"+{batches:g}; fused_score launched {launched} times ({launched - SHADOW_FRAMES} "
              f"by the challenger on the watchtower thread); disagreement "
              f"{st['disagreement']:.6f}, mean |delta| {st['mean_abs_delta']:.6f}, score PSI "
              f"{st['score_psi']:.6f}, reason divergence {st['reason_divergence']}; against "
              f"numpy: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
        if batches != SHADOW_FRAMES or launched != 2 * SHADOW_FRAMES \
                or max(gaps.values()) > SHADOW_TOL:
            raise AssertionError(f"{tag}: the shadow window is off")
    finally:
        server.stop()
    for knob in ("INGEST_PORT", "WATCHTOWER_SHADOW_SAMPLE", "WATCHTOWER_HALFLIFE_ROWS"):
        os.environ.pop(knob, None)
    return {"fused_score": launched - SHADOW_FRAMES}


def retrain_episode(work: Path, x) -> None:
    """Phase 3's model alone at @prod with WATCHTOWER_RETRAIN_TRIGGER=1:
    traffic like the baseline, then a drift episode, which enqueues one
    retrain task however often the status is read."""
    from fraud_detection_tpu_torch.monitor.watchtower import RETRAIN_TASK
    from fraud_detection_tpu_torch.service import binlane
    from fraud_detection_tpu_torch.service.taskq import Broker
    from fraud_detection_tpu_torch.tracking import TrackingClient

    tag = "phase10 retrain"
    store = work / "retrain_mlruns"
    reg = TrackingClient(f"file:{store}").registry
    reg.set_alias("fraud", "prod", reg.register("fraud", str(work / "models")))
    app, server, port = serve_lane_app(work, tag, store, WATCHTOWER_RETRAIN_TRIGGER="1",
                                       WATCHTOWER_HALFLIFE_ROWS=str(SHADOW_HALFLIFE_ROWS))
    try:
        wt, lane = app.state["watchtower"], app.state["binlane"]
        with binlane.BinLaneClient("127.0.0.1", lane.port) as cli:
            for rows in spread_frames(x, SHADOW_FRAMES):
                cli.score_batch(rows)
            wt.drain(timeout=120)
            before = json.loads(http_call(port, "GET", "/monitor/status")[1])
            for rows in spread_frames(x, SHADOW_FRAMES):
                cli.score_batch(rows * 4.0 + 3.0)
        wt.drain(timeout=120)
        statuses = [json.loads(http_call(port, "GET", "/monitor/status")[1]) for _ in range(3)]
        http_call(port, "GET", "/metrics")
        broker = Broker(f"sqlite:///{work}/phase10_retrain_taskq.db")
        try:
            names = [t.name for t in broker.claim_many("chip_smoke", 10_000)]
        finally:
            broker.close()
        print(f"{tag}: baseline-like traffic: status {before['status']}, recommendation "
              f"{before['recommendation']}; drift episode: status {statuses[0]['status']}, "
              f"recommendation {statuses[0]['recommendation']}; {names.count(RETRAIN_TASK)} "
              f"{RETRAIN_TASK} task(s) on the broker after 4 status reads and a scrape")
        if before["recommendation"] != "none" or statuses[0]["recommendation"] != "retrain" \
                or names.count(RETRAIN_TASK) != 1:
            raise AssertionError(f"{tag}: a drift episode must enqueue one retrain task")
    finally:
        server.stop()
    for knob in ("INGEST_PORT", "WATCHTOWER_RETRAIN_TRIGGER", "WATCHTOWER_HALFLIFE_ROWS"):
        os.environ.pop(knob, None)


def legacy_check(work: Path, x, predict_score: float) -> None:
    """The legacy app on the card answers one POST /predict with /predict's
    probability, through fused_score."""
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.service import legacy
    from fraud_detection_tpu_torch.service.http import TestClient

    os.environ.update(DEVICE="cuda", MODEL_PATH=str(work / "models" / "model.npz"))
    pin_tracking_store(work / "empty_mlruns", work)
    with TestClient(legacy.create_app()) as tc:
        kernels.reset_launch_counts()
        r = tc.post("/predict", json=dict(zip(["Time"] + [f"V{i}" for i in range(1, 29)]
                                              + ["Amount"], x[0].tolist())))
        launched = kernels.launch_counts()["fused_score"]
        model = tc.app.state["model"]
    body = r.json()
    print(f"phase10 legacy: POST /predict {r.status_code} {body} on {model.device}; "
          f"/predict's score {predict_score:.9f}; fused_score launched {launched}")
    if r.status_code != 200 or body["fraud_probability"] != round(predict_score, 4) \
            or body["alert"] != (body["fraud_probability"] > 0.8) or launched != 1:
        raise AssertionError("phase10 legacy: off /predict's probability or the kernel")


def ingest_phase(work: Path, gbt_store: str, lin_store: str, kaggle_csv: Path,
                 card: str) -> dict:
    """Phase 10. Returns the lane traffic's launches and the shadow's."""
    import numpy as np

    from fraud_detection_tpu_torch.tracking import TrackingClient

    t_phase = time.perf_counter()
    lin_dir = Path(TrackingClient(lin_store).registry.resolve("models:/fraud@prod"))
    native_csv_checks(work, kaggle_csv, lin_dir, work / "gbt_served")
    x = np.loadtxt(ROOT / "data" / "creditcard.csv", delimiter=",", skiprows=1,
                   dtype=np.float32)[:, :30]
    x = np.ascontiguousarray(x)
    launches: dict[str, int] = {}
    lin = ingest_lanes(work, "logistic", work / "models", work / "empty_mlruns",
                       f"native:{work / 'models'}", x, card)
    gbt = ingest_lanes(work, "gbt", work / "gbt_served", Path(gbt_store.removeprefix("file:")),
                       "registry:models:/fraud@prod", x, card)
    for got in (lin, gbt):
        launches.update(got["launches"])
    shadow = shadow_check(work, lin_store, x)
    retrain_episode(work, x)
    legacy_check(work, x, float(lin["predict"][0]))
    print(f"phase10: ingest, shadow, spyglass, native CSV in "
          f"{time.perf_counter() - t_phase:.3f} s; lane kernel launches {launches}, "
          f"the challenger's {shadow}")
    return {"ingest": launches, "shadow": shadow}


# ---------------------------------------------------------------------------
# phase 11: the ledger
# ---------------------------------------------------------------------------

LEDGER_TRAIN_AUC_TOL = 5e-3  # card vs CPU train --ledger (a SMOTE draw apart)
LEDGER_RTOL = LEDGER_ATOL = 1e-5  # card vs CPU replay: the float columns
LEDGER_ENTITIES = 36  # entities of the /predict traffic
LEDGER_PREDICTS = 144  # /predict with entity_id (most with a timestamp)
LEDGER_NULL_PREDICTS = 24  # /predict without one
LEDGER_CLIENTS = 16  # client threads of the concurrent part
LEDGER_FRAME_ROWS = 256  # the /ingest/batch frame (every 9th row entity-less)
LEDGER_FLUSH_TIMED = 30  # 1024-row flushes a form (ledger, stateless), in turns
LEDGER_STEP_TIMED = 100  # eager read-update calls timed
LEDGER_WIRES = ("float32", "int8")
LEDGER_EXACT = ("last_ts", "fingerprint", "collisions", "evictions")

#: the phase's HTTP client, its own process: POSTs each JSON body of a file
#: to /predict from ``clients`` threads; prints (status, body) per body in
#: order
BODY_CLIENT = r"""
import http.client, json, sys
from concurrent.futures import ThreadPoolExecutor
port, bodies, clients = int(sys.argv[1]), json.load(open(sys.argv[2])), int(sys.argv[3])

def one(body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/predict", body=json.dumps(body),
                     headers={"content-type": "application/json", "connection": "close"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()

with ThreadPoolExecutor(max_workers=clients) as pool:
    print(json.dumps(list(pool.map(one, bodies))))
"""


def post_bodies(port: int, bodies: list, clients: int, work: Path) -> list:
    path = work / "ledger_bodies.json"
    path.write_text(json.dumps(bodies))
    out = subprocess.run([sys.executable, "-c", BODY_CLIENT, str(port), str(path), str(clients)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"client process failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


def table_gap(tag: str, got, want, exact: bool) -> str:
    """Bitwise (``exact``) or the tests' tolerance (float columns; last_ts,
    fingerprints and counts still exact) between two host tables."""
    import numpy as np

    fields = ("acc", "last_ts", "fingerprint", "collisions", "evictions")
    for name, a, b in zip(fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{tag}: {name} {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        if exact or name in LEDGER_EXACT:
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"{tag}: {name} differs in bits")
        elif not np.allclose(a, b, rtol=LEDGER_RTOL, atol=LEDGER_ATOL):
            raise AssertionError(f"{tag}: {name} off by {np.abs(a - b).max():.3e}")
    acc_gap = float(np.abs(np.asarray(got[0], np.float64) - want[0]).max())
    return "bitwise equal" if exact else f"acc max gap {acc_gap:.3e}, the rest bitwise"


def ledger_kernels_at_d34(seed: int) -> dict:
    """``fused_score`` at n = 1024, d = 34 (the ledger flush) and
    ``knn_topk`` at m = 158, d = 34 (the final fit's SMOTE): held against
    their plain versions, then timed as phase 2 and 2b time them."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((1024, 34), dtype=np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal(34) / math.sqrt(34)).astype(np.float32)).to(dev)
    b = torch.tensor(-0.5, dtype=torch.float32, device=dev)
    err = float((kernels.fused_score(w, b, x) - kernels.fused_score_reference(w, b, x)).abs().max())
    if err > KERNEL_TOL:
        raise AssertionError(f"phase11: fused_score n=1024 d=34 off its plain version by {err:.3e}")
    fs = {key: graph_ms(fn) for key, fn in (
        ("ms", lambda: kernels.fused_score(w, b, x)),
        ("plain_ms", lambda: kernels.fused_score_reference(w, b, x)),
        ("library_ms", lambda: torch.sigmoid(torch.addmv(b, x, w))))}
    fs["bound_ms"], fs["bound_by"], n_bytes, n_ops = fused_score_bound(1024, 34)
    fs["max_abs_err"] = err
    print(f"phase11: fused_score n=1024 d=34 max_abs_err={err:.3e}; kernel {fs['ms']:.6f} ms, "
          f"plain {fs['plain_ms']:.6f} ms, library sigmoid(addmv) {fs['library_ms']:.6f} ms, "
          f"bound {fs['bound_ms']:.6f} ms ({fs['bound_by']}: {n_bytes} B, {n_ops} ops) "
          f"(CUDA events over {TIMED_LAUNCHES} launches replayed from a CUDA graph)")
    xc, sq = knn_inputs(rng.standard_normal((158, 34), dtype=np.float32))
    got = kernels.knn_topk(xc, sq, 5)
    want = kernels.knn_topk_reference(xc, sq, 5)
    mism, gap, _ = knn_selection_gap(xc, torch.arange(158, device=dev), got, want)
    if mism:
        raise AssertionError(f"phase11: knn_topk m=158 d=34: {mism} rows differ from the plain version")
    kn = {"ms": graph_ms(lambda: kernels.knn_topk(xc, sq, 5)),
          "plain_ms": eager_ms(lambda: kernels.knn_topk_reference(xc, sq, 5), iters=50, warm=5),
          "orientation_ms": eager_ms(lambda: torch.topk(torch.cdist(xc, xc), 6, largest=False),
                                     iters=50, warm=5),
          "max_abs_err": gap}
    kn["bound_ms"], kn["bound_by"], n_ops, n_bytes = knn_bound(158, 34, 5)
    print(f"phase11: knn_topk m=158 d=34 k=5: 0 of 158 rows mismatched; kernel {kn['ms']:.6f} ms "
          f"(CUDA graph), plain {kn['plain_ms']:.6f} ms, bound {kn['bound_ms']:.6f} ms "
          f"({kn['bound_by']}: {n_ops} ops, {n_bytes} B); orientation only "
          f"topk(cdist) {kn['orientation_ms']:.6f} ms")
    return {"fused_score": fs, "knn_topk": kn}


def ledger_train_and_replay(work: Path) -> tuple[Path, dict, object]:
    """``train --ledger`` on the card and on the CPU over the committed CSV;
    the card's replay twice (bitwise, and bitwise the trainer's stamped
    table) and against the CPU's. Returns the card run's model directory,
    its launch counts and the base rows."""
    import numpy as np

    from fraud_detection_tpu_torch.data.loader import load_creditcard_csv
    from fraud_detection_tpu_torch.ledger import (
        load_ledger,
        materialize_features,
        synthesize_entities,
    )
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.train import train

    csv = str(ROOT / "data" / "creditcard.csv")
    runs = {}
    launches = {}
    for knob in ("LEDGER_SLOTS", "LEDGER_HALFLIFE_S", "LEDGER_AMOUNT_COL",
                 "LEDGER_SYNTH_EVENTS", "MLFLOW_AUC_THRESHOLD"):
        os.environ.pop(knob, None)
    for dev in ("cuda", "cpu"):
        os.environ["MLFLOW_TRACKING_URI"] = f"file:{work / 'ledger' / dev / 'mlruns'}"
        out = work / "ledger" / dev / "models"
        if dev == "cuda":
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = train(data_csv=csv, out_dir=str(out), device=dev, ledger=True, register=False)
        wall = time.perf_counter() - t0
        if dev == "cuda":
            launches = kernels.launch_counts()
        runs[dev] = (m, out)
        print(f"phase11: train --ledger on {dev}: test AUC {m['test_auc']:.6f}, CV mean "
              f"{m['cv_auc_mean']:.6f}, {wall:.3f} s wall; ledger replay stage "
              f"{m['stages']['ledger_replay']:.6f} s; stages (s): "
              + ", ".join(f"{k} {v:.6f}" for k, v in m["stages"].items()))
    if launches.get("knn_topk") != KNN_LAUNCHES_PER_RUN:
        raise AssertionError(f"phase11: knn_topk launched {launches} in train --ledger, "
                             f"not {KNN_LAUNCHES_PER_RUN} times")
    print(f"phase11: kernel launches in train --ledger on the card {launches}")
    (card, card_dir), (cpu, cpu_dir) = runs["cuda"], runs["cpu"]
    gap = card["test_auc"] - cpu["test_auc"]
    if not abs(gap) <= LEDGER_TRAIN_AUC_TOL:
        raise AssertionError(f"phase11: card - cpu test AUC {gap:+.3e}")
    print(f"phase11: card - cpu test AUC {gap:+.3e}, CV mean "
          f"{card['cv_auc_mean'] - cpu['cv_auc_mean']:+.3e} (within {LEDGER_TRAIN_AUC_TOL})")

    spec, stamped = load_ledger(str(card_dir))
    if spec.slots != 8192 or spec.halflife_s != 3600.0 or spec.amount_col != -1 or spec.n_base != 30:
        raise AssertionError(f"phase11: the stamped spec is not the defaults: {spec}")
    x, _, names = load_creditcard_csv(csv)
    ents, ts = synthesize_entities(x, names, 42, 50)
    reps = []
    for dev in ("cuda", "cuda", "cpu"):
        t0 = time.perf_counter()
        reps.append(materialize_features(spec, x, ents, ts, device=dev))
        print(f"phase11: replay of {x.shape[0]} rows ({len(set(ents))} pseudo-entities, "
              f"{spec.slots} slots) on {dev}: {time.perf_counter() - t0:.3f} s wall")
    (f1, s1), (f2, s2), (fc, sc) = reps
    if f1.tobytes() != f2.tobytes():
        raise AssertionError("phase11: two card replays differ in the features' bits")
    print(f"phase11: two card replays: features bitwise equal, table "
          f"{table_gap('card replays', s1, s2, exact=True)}; the card replay and "
          f"train --ledger's stamped table: {table_gap('stamped', s1, stamped, exact=True)}")
    if not np.allclose(f1, fc, rtol=LEDGER_RTOL, atol=LEDGER_ATOL):
        raise AssertionError(f"phase11: card vs CPU replay features off by {np.abs(f1 - fc).max():.3e}")
    print(f"phase11: card vs CPU replay: features max gap {np.abs(f1 - fc).max():.3e} "
          f"(max relative {(np.abs(f1 - fc) / np.maximum(np.abs(fc), 1e-30)).max():.3e}); "
          f"table {table_gap('card vs cpu', s1, sc, exact=False)}; collisions "
          f"{float(s1.collisions):g}, evictions {float(s1.evictions):g}")
    return card_dir, launches, x


def widened_scores_f64(model_dir: Path, xw) -> object:
    """float64 numpy scores of widened rows from ``model.npz``."""
    import numpy as np

    with np.load(model_dir / "model.npz") as z:
        logit = ((np.asarray(xw, np.float64) - z["scaler_mean"]) / z["scaler_scale"]) @ z["coef"] \
            + z["intercept"]
    return 1.0 / (1.0 + np.exp(-logit))


def ledger_served(work: Path, model_dir: Path, x, wire: str) -> dict:
    """The trained directory served over HTTP on ``wire``: /predict with and
    without entities (concurrent, then one at a time) and one
    /ingest/batch frame; every flush recorded (``SCORER_MAX_INFLIGHT=1``:
    one flush at a time, so the records are in table order) and replayed
    through the ledger body: the served table bitwise the replay, the
    scores within 1e-5 of float64 on the replayed widened rows,
    ``fused_score`` once a flush, the null rows counted."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.ledger import _ledger_read_update, entity_fingerprint
    from fraud_detection_tpu_torch.ledger.state import device_state, host_state
    from fraud_detection_tpu_torch.ops import kernels
    from fraud_detection_tpu_torch.service import binlane, metrics
    from fraud_detection_tpu_torch.service.app import create_app

    tag = f"phase11 {wire}"
    os.environ.update(DEVICE="cuda", SCORER_EXPLAIN="topk", SCORER_WIRE=wire,
                      SCORER_MAX_INFLIGHT="1", MODEL_PATH=str(model_dir / "model.npz"))
    for knob in ("SCORER_MAX_BATCH", "SCORER_FUSED_FLUSH", "SCORER_EXPLAIN_K",
                 "SCORER_RETURN_WIRE", "INGEST_PORT"):
        os.environ.pop(knob, None)
    pin_tracking_store(work / "ledger_empty_mlruns", work)
    app = create_app(database_url=f"sqlite:///{work}/ledger_{wire}_fraud.db",
                     broker_url=f"sqlite:///{work}/ledger_{wire}_taskq.db")
    port = free_port()
    server = ServerThread(app, port)
    server.start()
    if not server.ready.wait(timeout=300) or server.error is not None:
        raise RuntimeError(f"{tag}: server did not start: {server.error!r}")
    try:
        check_source(tag, app.state["model_source"], f"native:{model_dir}")
        model, batcher, wt = app.state["model"], app.state["batcher"], app.state["watchtower"]
        scorer = model.scorer
        spec = model.ledger_spec
        target = batcher._fused_target(scorer)
        if wt is None or wt.drift.ledger is None or target is None or target[1].ledger is None:
            raise AssertionError(f"{tag}: the app runs no ledger flush")
        if scorer.io_dtype != wire or scorer.staging_features != 30 or scorer.n_features != 34:
            raise AssertionError(f"{tag}: scorer {scorer.io_dtype} {scorer.staging_features}/"
                                 f"{scorer.n_features}")
        print(f"{tag}: after start-up (warm_fused on every bucket) the table is "
              f"{table_gap('warm-up', wt.drift.ledger_snapshot(), model.ledger_state, exact=True)}"
              " to the stamped one")
        records = []
        inner = batcher._flush_device

        def recording(scorer_, target_, batch, telemetry=False):
            out = inner(scorer_, target_, batch, telemetry)
            slot = out[-1]
            records.append(tuple(np.array(a) for a in (
                slot.f32, slot.io, slot.ls, slot.lf, slot.lt, slot.lh)))
            return out

        batcher._flush_device = recording
        rng = np.random.default_rng(11)
        pick = rng.choice(x.shape[0], LEDGER_PREDICTS + LEDGER_NULL_PREDICTS + LEDGER_FRAME_ROWS,
                          replace=False)
        rows = x[pick]
        t_rel = float(np.max(model.ledger_state.last_ts)) + 10.0
        bodies = []
        for i in range(LEDGER_PREDICTS + LEDGER_NULL_PREDICTS):
            body = {"features": rows[i].tolist()}
            if i < LEDGER_PREDICTS:
                body["entity_id"] = f"card-{i % LEDGER_ENTITIES}"
                if i % 12:  # the rest take now, on the table's clock
                    body["timestamp"] = spec.ts_origin + t_rel + 2.0 * i
            bodies.append(body)
        order = rng.permutation(len(bodies))
        half = len(bodies) // 2
        null0 = metrics.ledger_null_entity_rows.get()
        kernels.reset_launch_counts()
        results = post_bodies(port, [bodies[j] for j in order[:half]], LEDGER_CLIENTS, work)
        results += post_bodies(port, [bodies[j] for j in order[half:]], 1, work)
        frame_rows = rows[len(bodies):]
        fps = np.asarray([0 if i % 9 == 0 else entity_fingerprint(f"card-{i % LEDGER_ENTITIES}")
                          for i in range(LEDGER_FRAME_ROWS)], np.uint32)
        frame_ts = spec.ts_origin + t_rel + 1000.0 + np.arange(LEDGER_FRAME_ROWS, dtype=np.float64)
        status, body = post_raw(port, "/ingest/batch",
                                binlane.encode_frame(frame_rows, fps, frame_ts, length_prefix=False),
                                "application/x-fraud-frame")
        launches = kernels.launch_counts()
        batcher._flush_device = inner
        if status != 200:
            raise AssertionError(f"{tag}: /ingest/batch {status} {body[:200]!r}")
        frame_scores, _ = binlane.decode_response_body(body)
        served = {}
        for j, (st, text) in zip(order, results):
            if st != 200:
                raise AssertionError(f"{tag}: /predict {j}: HTTP {st} {text[:200]}")
            served[rows[j].tobytes()] = json.loads(text)["score"]
        for i in range(LEDGER_FRAME_ROWS):
            served[frame_rows[i].tobytes()] = float(frame_scores[i])
        n_null = LEDGER_NULL_PREDICTS + int((fps == 0).sum())
        null_delta = metrics.ledger_null_entity_rows.get() - null0
        if null_delta != n_null:
            raise AssertionError(f"{tag}: ledger_null_entity_rows +{null_delta}, sent {n_null}")
        if launches["fused_score"] != len(records):
            raise AssertionError(f"{tag}: fused_score launched {launches['fused_score']} times "
                                 f"in {len(records)} flushes")

        # the served table against a replay of the recorded flushes
        dev = torch.device("cuda")
        table = device_state(model.ledger_state, spec.slots, dev)
        null = torch.tensor(spec.null_features, device=dev)
        hl = torch.tensor(spec.halflife_s, dtype=torch.float32, device=dev)
        scale = scorer._dequant_scale if wire == "int8" else None
        worst, checked = 0.0, 0
        for f32, io, ls, lf, lt, lh in records:
            xb = torch.from_numpy(io).to(dev).float()
            if scale is not None:
                xb = xb * scale
            feats = _ledger_read_update(
                table, torch.from_numpy(ls).to(dev), torch.from_numpy(lf).to(dev),
                torch.from_numpy(lt).to(dev), xb[:, spec.amount_col],
                torch.from_numpy(lh).to(dev), null, hl)
            xw = torch.cat([xb, feats], dim=1).cpu().numpy()
            want = widened_scores_f64(model_dir, xw)
            for r in range(f32.shape[0]):
                got = served.get(f32[r].tobytes())
                if got is not None:
                    worst = max(worst, abs(got - want[r]))
                    checked += 1
        snap = wt.drift.ledger_snapshot()
        print(f"{tag}: {len(results)} /predict ({LEDGER_PREDICTS} with entity_id over "
              f"{LEDGER_ENTITIES} entities, {LEDGER_NULL_PREDICTS} without; half from "
              f"{LEDGER_CLIENTS} threads) and one {LEDGER_FRAME_ROWS}-row /ingest/batch frame in "
              f"{len(records)} flushes ({sum(int(r[0].any(axis=1).sum()) for r in records)} rows); "
              f"kernel launches {launches}; the served table against a replay of the "
              f"recorded flushes: {table_gap(tag, snap, host_state(table), exact=True)}")
        if checked != len(served) or not worst <= SCORE_ATOL:
            raise AssertionError(f"{tag}: {checked} of {len(served)} scores checked, "
                                 f"max |score - f64| {worst:.3e}")
        print(f"{tag}: max |score - f64 on the replayed widened rows| {worst:.3e} over "
              f"{checked} rows; ledger_null_entity_rows +{null_delta:g} (sent {n_null})")
        text = http_call(port, "GET", "/metrics")[1].decode()
        status_body = json.loads(http_call(port, "GET", "/monitor/status")[1])
        ledger = status_body.get("ledger")
        if metric_value(text, "ledger_active") != 1 or not isinstance(ledger, dict):
            raise AssertionError(f"{tag}: ledger_active / status body {ledger!r}")
        if metric_value(text, 'scorer_flushes_total{path="split",shard="0"}') != 0:
            raise AssertionError(f"{tag}: a flush ran split")
        print(f"{tag}: /metrics ledger_active 1, ledger_slot_occupancy "
              f"{metric_value(text, 'ledger_slot_occupancy'):g}, ledger_hash_collisions_total "
              f"{metric_value(text, 'ledger_hash_collisions_total'):g}, "
              f"ledger_null_entity_rows_total {metric_value(text, 'ledger_null_entity_rows_total'):g}"
              f"; /monitor/status ledger {json.dumps(ledger)}")
        return launches
    finally:
        server.stop()


def by_name(intervals, top: int = 12) -> str:
    """The profiler's device activities grouped by name (48 characters),
    the most device time first: count and µs."""
    groups: dict[str, list[float]] = {}
    for name, start, end in intervals:
        groups.setdefault(name[:48], []).append(end - start)
    ranked = sorted(groups.items(), key=lambda kv: -sum(kv[1]))[:top]
    return "; ".join(f"{n} x{len(v)} {sum(v):.3f} us" for n, v in ranked)


def ledger_timing(work: Path, model_dir: Path, x, kaggle_csv: Path) -> dict:
    """A 1024-row ledger flush beside the stateless flush (phase 3's
    model), in turns: host time, stream time (CUDA events around the
    flush), device busy and launches (profiler); the read-update alone; the
    replay of the Kaggle-sized CSV."""
    import numpy as np
    import torch

    from fraud_detection_tpu_torch.data.loader import load_creditcard_csv
    from fraud_detection_tpu_torch.ledger import (
        _ledger_read_update,
        materialize_features,
        synthesize_entities,
    )
    from fraud_detection_tpu_torch.ledger.replay import row_keys
    from fraud_detection_tpu_torch.ledger.state import LedgerState
    from fraud_detection_tpu_torch.models import load_any_model
    from fraud_detection_tpu_torch.monitor.baseline import load_profile
    from fraud_detection_tpu_torch.monitor.watchtower import Thresholds, Watchtower
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    os.environ["SCORER_WIRE"] = "float32"
    never = Thresholds(5.0, 5.0, 5.0, 1.0, 10**9)
    forms = {}
    towers = []
    for form, d in (("ledger", model_dir), ("stateless", work / "models")):
        model = load_any_model(str(d), device="cuda")
        wt = Watchtower(load_profile(str(d)), thresholds=never, device="cuda")
        towers.append(wt)
        if model.ledger_spec is not None:
            wt.drift.bind_ledger(model.ledger_spec, model.ledger_state)
        mb = MicroBatcher(model.scorer, watchtower=wt, telemetry=False, explain=True)
        spec = model.ledger_spec
        items = []
        for i in range(1024):
            ent = None
            if spec is not None and i % 8:
                s, fp = spec.row_keys(f"card-{i % 300}")
                ent = (s, fp, float(np.max(model.ledger_state.last_ts)) + 10.0 + i)
            items.append((x[i], None, None, ent))
        forms[form] = (mb, model.scorer, mb._fused_target(model.scorer), items)
    host = {f: [] for f in forms}
    stream = {f: [] for f in forms}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r in range(LEDGER_FLUSH_TIMED + 2):
        for f in (("ledger", "stateless") if r % 2 else ("stateless", "ledger")):
            mb, scorer, target, items = forms[f]
            start.record()
            t = time.perf_counter()
            out = mb._flush_device(scorer, target, items)
            dt = time.perf_counter() - t
            end.record()
            end.synchronize()
            scorer.staging.release(out[-1])
            if r >= 2:  # two warm rounds
                host[f].append(dt)
                stream[f].append(start.elapsed_time(end))
    res = {}
    for f, (mb, scorer, target, items) in forms.items():
        ivs = profiled_intervals(lambda: scorer.staging.release(
            mb._flush_device(scorer, target, items)[-1]))
        copies = sum(1 for name, _, _ in ivs if "Memcpy" in name or "Memset" in name)
        res[f] = {"host_ms": sorted(host[f])[len(host[f]) // 2] * 1e3,
                  "stream_ms": sorted(stream[f])[len(stream[f]) // 2],
                  "busy_us": union_us([(s, e) for _, s, e in ivs]),
                  "launches": len(ivs) - copies, "copies": copies}
        print(f"phase11: 1024-row {f} flush with explain (f32 wire): host p50 "
              f"{res[f]['host_ms']:.3f} ms, stream p50 {res[f]['stream_ms']:.3f} ms (CUDA events "
              f"around the flush), {LEDGER_FLUSH_TIMED} flushes in turns; device busy "
              f"{res[f]['busy_us']:.3f} us, {res[f]['launches']} kernel launches + "
              f"{res[f]['copies']} copies/memsets (profiler); by name: " + by_name(ivs))
    for wt in towers:
        wt.close()

    # the read-update alone, 1024 rows, on a scratch copy of the table
    mb, scorer, target, items = forms["ledger"]
    drift = target[0]
    spec = drift.ledger_spec
    table = LedgerState(*(t.clone() for t in drift.ledger))
    dev = torch.device("cuda")
    ks = [spec.row_keys(f"card-{i % 300}") for i in range(1024)]
    cols = (torch.tensor([k[0] for k in ks], device=dev),
            torch.tensor([k[1] for k in ks], device=dev),
            torch.full((1024,), float(table.last_ts.max()) + 5.0, device=dev),
            torch.from_numpy(np.ascontiguousarray(x[:1024, -1])).to(dev),
            torch.ones(1024, device=dev))
    step = lambda: _ledger_read_update(table, *cols, drift._ledger_null,  # noqa: E731
                                       drift._ledger_halflife)
    per_call = eager_ms(step, iters=LEDGER_STEP_TIMED, warm=5)
    ivs = profiled_intervals(step)
    res["read_update"] = {"eager_ms": per_call, "busy_us": union_us([(s, e) for _, s, e in ivs]),
                          "launches": len(ivs)}
    print(f"phase11: the read-update alone, 1024 rows: {res['read_update']['launches']} device "
          f"launches, {res['read_update']['busy_us']:.3f} us device busy (profiler); "
          f"{per_call:.6f} ms a call eager (CUDA events over {LEDGER_STEP_TIMED} calls, "
          f"host-bound); by name: " + by_name(ivs))

    # the replay at the Kaggle file's scale
    kx, _, names = load_creditcard_csv(str(kaggle_csv))
    t0 = time.perf_counter()
    ents, ts = synthesize_entities(kx, names, 42, 50)
    t1 = time.perf_counter()
    row_keys(spec, ents, kx.shape[0])
    t2 = time.perf_counter()
    feats, state = materialize_features(spec, kx, ents, ts, device="cuda")
    t3 = time.perf_counter()
    if feats.shape != (kx.shape[0], 4) or not np.isfinite(feats).all():
        raise AssertionError("phase11: the Kaggle-sized replay's features are not finite")
    n_batches = -(-kx.shape[0] // 256)
    res["kaggle_replay_s"] = t3 - t2
    print(f"phase11: replay of the Kaggle-sized CSV ({kx.shape[0]} rows, {len(set(ents))} "
          f"pseudo-entities, {n_batches} batches of 256): {t3 - t2:.3f} s wall on the card "
          f"(synchronised; {kx.shape[0] / (t3 - t2):,.0f} rows/s), of which the host hashing "
          f"~{t2 - t1:.3f} s; synthesize_entities {t1 - t0:.3f} s; occupied slots "
          f"{int((state.last_ts > 0).sum())} of {spec.slots}, collisions "
          f"{float(state.collisions):g}")
    return res


def ledger_phase(work: Path, kaggle_csv: Path) -> dict:
    """Phase 11. Returns the kernel checks at d = 34, the train run's and
    the served traffic's launches."""
    t_phase = time.perf_counter()
    checks = ledger_kernels_at_d34(seed=11)
    model_dir, train_launches, x = ledger_train_and_replay(work)
    served: dict[str, int] = {}
    for wire in LEDGER_WIRES:
        for k, v in ledger_served(work, model_dir, x, wire).items():
            served[k] = served.get(k, 0) + v
    os.environ.pop("SCORER_MAX_INFLIGHT", None)
    ledger_timing(work, model_dir, x, kaggle_csv)
    os.environ.pop("SCORER_WIRE", None)
    print(f"phase11: the ledger in {time.perf_counter() - t_phase:.3f} s; served launches "
          f"{served}, train --ledger's {train_launches}")
    return {"checks": checks, "train": train_launches, "served": served}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA "
              "card", file=sys.stderr)
        return 2
    for part in ("fraud_detection_tpu_torch", "models", "data"):
        if not (ROOT / part).exists():
            print(f"chip_smoke: {part}/ missing beside {__file__}",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, str(ROOT))
    from fraud_detection_tpu_torch.device import resolve_device
    from fraud_detection_tpu_torch.ops import kernels

    resolve_device("cuda")  # precision policy: no TF32
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from fraud_detection_tpu_torch.data import native

    t0 = time.perf_counter()
    csv_build: dict = {}

    def build_csv_reader() -> None:  # g++ beside the nvcc builds
        t = time.perf_counter()
        try:
            csv_build["path"] = native.build()
        except BaseException as e:  # raised in the main thread below
            csv_build["error"] = e
        csv_build["s"] = time.perf_counter() - t

    csv_thread = threading.Thread(target=build_csv_reader, name="csv-build")
    csv_thread.start()
    built = kernels.build_kernels()
    csv_thread.join()
    if "error" in csv_build:
        raise csv_build["error"]
    print(f"phase1: built {sorted(built)} in {time.perf_counter() - t0:.3f} s "
          f"(per kernel: {', '.join(f'{k} {v:.3f} s' for k, v in built.items())}); the "
          f"native CSV reader {Path(csv_build['path']).name} in {csv_build['s']:.3f} s (g++)")
    if sorted(built) != sorted(KERNELS):
        raise AssertionError(f"csrc kernels {sorted(built)} != {sorted(KERNELS)}")
    for name in ("fused_score", "knn_topk"):
        check_ptxas_resources(kernels, name)
    print(f"kernels: {json.dumps(sorted(KERNELS))}")

    fs = check_fused_score(seed=0)
    knn = check_knn_topk(seed=0)
    hist = check_gbt_hist(seed=0)
    shap = check_tree_shap(seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        work = Path(work)
        served = served_path(work)
        trained, lin_store = trained_path(work)
        gbt_trained, gbt_dir, gbt_store = gbt_trained_path(work)
        gbt_served = gbt_served_path(work, gbt_dir, gbt_store)
        worker_lin = explain_path(work, "logistic", work / "models", card,
                                  work / "empty_mlruns", f"native:{work / 'models'}")
        worker_gbt = explain_path(work, "gbt", Path(gbt_dir), card,
                                  Path(gbt_store.removeprefix("file:")),
                                  "registry:models:/fraud@prod")
        tools = offline_tools(work, lin_store, gbt_dir)
        wires = quantized_wires(work, gbt_store, work / "tools" / "kaggle.csv")
        ingest = ingest_phase(work, gbt_store, lin_store, work / "tools" / "kaggle.csv", card)
        ledger = ledger_phase(work, work / "tools" / "kaggle.csv")

    def row(name: str, launches: int, check: dict, t: dict, library_ms, **extra):
        route, source, replaces = KERNELS[name]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": check["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": library_ms, **extra,
        }

    t = fs["timing"][1024, "float32"]
    k_small = knn["timing"][158, 30]
    line = {"kernels": [
        row("fused_score", served["fused_score"], fs, t, t["library_ms"],
            n=1024, launch_floor_ms=fs["launch_floor_ms"],
            worker_launches=worker_lin["fused_score"],
            tools_launches=tools.get("fused_score", 0),
            wires_launches=wires["fused_score"],
            ingest_launches=ingest["ingest"]["fused_score"],
            shadow_launches=ingest["shadow"]["fused_score"],
            ledger_launches=ledger["served"]["fused_score"],
            at_n_1024_d_34={key: ledger["checks"]["fused_score"][key] for key in
                            ("ms", "plain_ms", "bound_ms", "library_ms")},
            **{f"at_n_{n}{TIMING_SUFFIX.get(dt, '')}":
               {key: v[key] for key in ("ms", "kernel_ms", "upcast_ms", "plain_ms",
                                        "bound_ms", "library_ms") if key in v}
               for (n, dt), v in fs["timing"].items() if (n, dt) != (1024, "float32")}),
        # no single PyTorch call computes k-NN with this tie rule: the
        # library column is null, the two-call orientation stands beside it;
        # max_abs_err is the largest float64 distance gap between the
        # kernel's and the plain version's picks (0 when the indices agree)
        row("knn_topk", trained["knn_topk"], knn, k_small, None,
            m=158, orientation_ms=k_small["orientation_ms"],
            tools_launches=tools.get("knn_topk", 0),
            ledger_launches=ledger["train"]["knn_topk"],
            at_m_158_d_34={key: ledger["checks"]["knn_topk"][key] for key in
                           ("ms", "plain_ms", "bound_ms", "orientation_ms")},
            **{f"at_m_{m}" + (f"_d_{d}" if d != 30 else ""):
               {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "orientation_ms")}
               for (m, d), v in knn["timing"].items() if (m, d) != (158, 30)}),
        # at the final fit's last level (16 nodes); max_abs_err is the
        # largest |kernel − plain| cell over every phase-2c case
        row("gbt_hist", gbt_trained["gbt_hist"], hist, hist["timing"][16],
            hist["timing"][16]["library_ms"], n=31684, nodes=16,
            at_level_0={key: hist["timing"][1][key] for key in
                        ("ms", "plain_ms", "bound_ms", "library_ms")},
            at_leaf_sums={key: hist["timing"]["leaf"][key] for key in
                          ("ms", "plain_ms", "bound_ms", "library_ms")},
            mean_per_launch_ms=hist["mean"]["ms"]),
        # no single PyTorch call computes TreeSHAP: the library column is
        # null, the TPU kernel's dense three-product form (torch.matmul)
        # stands beside it as orientation
        row("tree_shap", gbt_served["tree_shap"], shap, shap["timing"][1024], None,
            n=1024, trees=100, depth=5,
            orientation_ms=shap["timing"][1024]["orientation_ms"],
            worker_launches=worker_gbt["tree_shap"],
            tools_launches=tools.get("tree_shap", 0),
            wires_launches=wires["tree_shap"],
            ingest_launches=ingest["ingest"]["tree_shap"],
            **{f"at_n_{n}": {key: shap["timing"][n][key] for key in
                             ("ms", "plain_ms", "bound_ms")} for n in (8, 64, 4000, 20000)}),
    ]}
    print(json.dumps(line))
    print(card)  # exactly as nvidia-smi gives it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,  # the cards this run used: every phase runs on one
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
