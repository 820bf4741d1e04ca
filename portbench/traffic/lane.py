"""Closed-loop frames through the binary ingest lane.

The server is the program as it is deployed: ``service/app.create_app``
with ``INGEST_PORT`` set, started in this process on an event loop of its
own, serving the configuration's model directory (written from the seed)
with its drift monitor and reason codes. The client is another process
(``lane_client.py``): ``connections`` sockets, each with one frame of
``frame_rows`` rows in flight, cycling over ``frames`` frames made from
the seed. The window counts the rows the client got back by its end; the
rows of a sample of frames, drawn from the seed, are compared with the
reference once the window has closed.

The two processes run on disjoint CPU sets: the client on the last
quarter of the run's cores (at least one), the server on the rest, with
PyTorch's intra-op threads fixed at the server's core count, so neither
side's threads take cores from the other's (:func:`cpu_split`).

Mix parameters (``traffic/mixes/<mix>.json``): ``connections``,
``frame_rows``, ``frames``, ``warm_frames``, ``trace_seconds`` (the traced
stretch, in the middle of the window) and ``server_env`` (the serving
settings).
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from portbench import counters, inputs
from portbench import reference as ref

CLIENT = Path(__file__).resolve().parent / "lane_client.py"
#: the client's start, connections and warm-up frames
READY_TIMEOUT_S = 120.0


def cpu_split(cpus) -> tuple[list[int], list[int]]:
    """(server cores, client cores) of the cores this run may use: the
    client takes the last quarter, at least one; with one core both share
    it."""
    cpus = sorted(cpus)
    k = max(1, len(cpus) // 4)
    if len(cpus) <= k:
        return cpus, cpus
    return cpus[:-k], cpus[-k:]


def _pin_process(cpus) -> None:
    """Every thread of this process, and so every thread it starts later,
    on ``cpus``."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except (ProcessLookupError, PermissionError):
            pass  # a thread that ended meanwhile


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.loop = None
        self.thread = None
        self.app = None
        self.client = None
        self._old_env = {}
        self._cpus = None
        self.answers = os.path.join(ctx.work, "answers.npz")

    def _call(self, coro, timeout: float = 300.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def setup(self) -> None:
        import torch

        ctx, cfg, mix = self.ctx, self.ctx.cfg, self.ctx.mix
        self._cpus = os.sched_getaffinity(0)
        server_cpus, client_cpus = cpu_split(self._cpus)
        _pin_process(server_cpus)
        torch.set_num_threads(len(server_cpus))
        self.weights = inputs.make_weights(cfg, ctx.seed)
        model_dir = os.path.join(ctx.work, "model")
        inputs.write_model_dir(model_dir, cfg, self.weights, ctx.seed)
        port = _free_port()
        serve = cfg["serve"]
        env = {
            "MODEL_PATH": os.path.join(model_dir, "model.npz"),
            "MLFLOW_TRACKING_URI": "file:" + os.path.join(ctx.work, "mlruns"),
            "FRAUD_REGISTRY_CACHE": os.path.join(ctx.work, "registry"),
            "DATABASE_URL": "sqlite:///" + os.path.join(ctx.work, "fraud.db"),
            "CELERY_BROKER_URL": "sqlite:///" + os.path.join(ctx.work, "taskq.db"),
            "LIFECYCLE_DB_URL": "sqlite:///" + os.path.join(ctx.work, "lifecycle.db"),
            "DEVICE_PROFILE_DIR": os.path.join(ctx.work, "traces"),
            "INGEST_HOST": "127.0.0.1",
            "INGEST_PORT": str(port),
            "SCORER_EXPLAIN": serve["explain"],
            "SCORER_EXPLAIN_K": str(serve["explain_k"]),
            "SCORER_WIRE": serve["wire"],
            "WATCHTOWER_ENABLED": "1",
            # the peak probes (an 8192² matmul and a 1 GiB add) serve the
            # program's live gauge, which the benchmark does not read
            "ROOFLINE_ENABLED": "0",
            "LIFECYCLE_RELOAD_INTERVAL_S": "0",
        }
        env.update({k: str(v) for k, v in mix["server_env"].items()})
        env.update(ctx.env)
        self._old_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        from fraud_detection_tpu_torch.service.app import create_app

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="portbench-loop",
                                       daemon=True)
        self.thread.start()
        self.app = create_app(device=ctx.device)
        self._call(self.app.startup())
        st = self.app.state
        if st["binlane"] is None or st["batcher"] is None or st["watchtower"] is None:
            raise RuntimeError("the app started without its lane, batcher or drift monitor")
        self.client = subprocess.Popen(
            [sys.executable, str(CLIENT), "--port", str(port), "--config", ctx.cell["config"],
             "--mix", ctx.cell["traffic"], "--seed", str(ctx.seed),
             "--seconds", repr(ctx.seconds), "--sample", str(ctx.cell["check"]["sample_frames"]),
             "--out", self.answers, "--pkg", str(ctx.pkg),
             "--cpus", ",".join(map(str, client_cpus))],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                 "MKL_NUM_THREADS": "1"},
        )
        line = _readline(self.client, READY_TIMEOUT_S)
        if line.strip() != "ready":
            raise RuntimeError(f"the lane client did not get ready: {line!r}")

    def window(self, seconds: float, tracer) -> dict:
        mix = self.ctx.mix
        c0 = counters.snapshot()
        self.client.stdin.write("go\n")
        self.client.stdin.flush()
        out: dict = {}
        if tracer is not None:
            span = min(float(mix["trace_seconds"]), seconds)
            time.sleep(max(0.0, (seconds - span) / 2))
            t0 = counters.snapshot()
            tracer.start()
            time.sleep(span)
            out["trace"] = tracer.stop()
            out["trace_counters"] = counters.delta(t0, counters.snapshot())
        line = _readline(self.client, seconds + 120.0)
        out["counters"] = counters.delta(c0, counters.snapshot())
        self.client.wait(30)
        self.client = None
        out["counts"] = json.loads(line)
        with np.load(self.answers) as z:
            out["frame_latency_s"] = z["lat"]
        out["attempted"] = out["counts"]["sent"]
        out["failed"] = out["counts"]["failed"] + out["counts"]["stuck_threads"]
        return out

    def teardown(self) -> None:
        if self.client is not None:
            self.client.kill()
            self.client.wait(30)
            self.client = None
        if self.app is not None:
            self._call(self.app.shutdown())
            self.app = None
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()
            self.loop = None
        if self._cpus:
            _pin_process(self._cpus)
        for k, v in self._old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def check(self) -> dict:
        """The answers of the sampled frames against the reference: the
        widest score gap, how far the reference's value of each reported
        reason falls below its own value at that rank, and the widest gap
        between a reported reason value and the reference's."""
        ctx, cfg, mix = self.ctx, self.ctx.cfg, self.ctx.mix
        with np.load(self.answers) as z:
            ids, scores, idx, val = z["ids"], z["scores"], z["idx"], z["val"]
        want = inputs.check_sample(ctx.seed, mix["frames"], ctx.cell["check"]["sample_frames"])
        fr = mix["frame_rows"]
        x, _ = inputs.rows(cfg, ctx.seed, mix["frames"] * fr)
        numbers = {"unanswered": float(len(set(want.tolist()) - set(ids.tolist())))}
        if len(ids) == 0:
            return numbers
        rows = x[(ids[:, None] * fr + np.arange(fr)[None, :]).reshape(-1)]
        p_ref = ref.score(cfg, self.weights, rows)
        phi = ref.explain(cfg, self.weights, rows)
        k = int(cfg["serve"]["explain_k"])
        got_idx = idx.reshape(-1, idx.shape[-1]).astype(np.int64)
        got_val = val.reshape(-1, val.shape[-1]).astype(np.float64)
        numbers["score_gap"] = float(np.abs(scores.reshape(-1) - p_ref).max())
        if got_idx.shape[1] != k:
            numbers["reason_rank_gap"] = numbers["reason_value_gap"] = float("inf")
            return numbers
        best = np.take_along_axis(phi, ref.topk(phi, k), axis=1)
        at_got = np.take_along_axis(phi, got_idx, axis=1)
        numbers["reason_rank_gap"] = float(np.abs(best - at_got).max())
        numbers["reason_value_gap"] = float(np.abs(got_val - at_got).max())
        return numbers


def _readline(proc: subprocess.Popen, timeout: float) -> str:
    """One line of the client's output, or an error after ``timeout``."""
    box: list[str] = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout)
    if not box:
        proc.kill()
        raise RuntimeError(f"the lane client said nothing for {timeout:.0f} s")
    return box[0]
