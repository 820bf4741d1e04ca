"""Multi-process bring-up of the port's sharded training (item 12b), on the
CPU: ``parallel.initialize_distributed`` under ``gloo``, the collectives
across the process boundary, sharded fits in two processes of 4 shards
each held bitwise against one process of 8 shards, and the wide family's
2-D fit in two processes of a 2 × 2 grid against one process of 4 × 2.

The children run ``python -m fraud_detection_tpu_torch.shardfit`` with
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` as ``torchrun``
sets them, under their own timeout: a hang in one rank kills both and
shows the other's output (JAX's ``tests/test_distributed.py``). No JAX here.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fraud_detection_tpu_torch import config, shardfit
from fraud_detection_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every fit the children run, on 1,500 synthetic rows and a small forest
FIT_ARGS = ["--fit", "psum", "--fit", "scaler", "--fit", "lbfgs", "--fit", "sgd",
            "--fit", "gbt", "--fit", "mesh_sgd", "--rows", "1500", "--seed", "3",
            "--trees", "4", "--depth", "3", "--bins", "32"]
CHILD_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: the wide family's 2-D fit: a 2 × 2 grid a rank against one process of 4 × 2
WIDE_ARGS = ["--fit", "wide_sgd", "--model", "2", "--rows", "1200", "--seed", "4"]


def _ranks(world: int, shards: int, out: str, fit_args=FIT_ARGS) -> list[tuple[int, str]]:
    """Run ``world`` shardfit ranks; returns each one's (exit code, output)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.update(DEVICE="cpu", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fraud_detection_tpu_torch.shardfit", *fit_args,
             "--shards", str(shards), "--out", out],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out_text, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append(out_text)
    finally:
        # a hang in one rank must not leak children or hide the other's output
        for p in procs[len(outs):]:
            p.kill()
            out_text, _ = p.communicate()
            outs.append(out_text)
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _summary(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_two_gloo_ranks_of_four_shards_are_one_rank_of_eight(tmp_path, monkeypatch):
    """Two processes × 4 CPU shards under gloo: the psum of every shard's
    ``rank + 1`` crosses the process boundary (4·1 + 4·2 = 12), and the
    sharded scaler, L-BFGS, SGD, forest and sharded weight update are, on
    both ranks, bitwise the one-process 8-shard fits."""
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert shardfit.main([*FIT_ARGS, "--shards", "8", "--out", str(tmp_path / "one")]) == 0
    one = np.load(tmp_path / "one" / "rank0.npz")
    results = _ranks(2, 4, str(tmp_path / "two"))
    for rank, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{text}"
        s = _summary(text)
        assert (s["rank"], s["world"], s["backend"], s["shards"], s["global_shards"]) == (
            rank, 2, "gloo", 4, 8)
        assert s["psum"] == 12.0
        got = np.load(tmp_path / "two" / f"rank{rank}.npz")
        assert float(got["psum_all_reduce"][0]) == 2.0
        np.testing.assert_array_equal(got["psum_all_gather"], [1.0] * 4 + [2.0] * 4)
        for key in one.files:
            if key.startswith("psum_"):
                continue
            assert got[key].tobytes() == one[key].tobytes(), (rank, key)


def test_two_gloo_ranks_of_a_2x2_wide_fit_are_one_rank_of_4x2(tmp_path, monkeypatch):
    """The wide family's 2-D fit in two processes of a 2 × 2 grid each
    (the model axis inside each rank, the data axis across them) is, on
    both ranks, bitwise the one-process 4 × 2 fit: coef, intercept and the
    gathered table."""
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert shardfit.main([*WIDE_ARGS, "--shards", "4", "--out", str(tmp_path / "one")]) == 0
    one = np.load(tmp_path / "one" / "rank0.npz")
    assert np.abs(one["wide_sgd_table"]).max() > 0.0
    for rank, (rc, text) in enumerate(_ranks(2, 2, str(tmp_path / "two"), WIDE_ARGS)):
        assert rc == 0, f"rank {rank} failed:\n{text}"
        s = _summary(text)
        assert (s["rank"], s["world"], s["backend"], s["global_shards"]) == (rank, 2, "gloo", 4)
        got = np.load(tmp_path / "two" / f"rank{rank}.npz")
        for key in ("wide_sgd_coef", "wide_sgd_intercept", "wide_sgd_table"):
            assert got[key].tobytes() == one[key].tobytes(), (rank, key)


def test_world_of_one_and_the_backend_rule(tmp_path, monkeypatch):
    """A group of one rank starts (gloo on the CPU) and spans its shards;
    the backend rule picks nccl only where every rank of the host has a
    card; without MASTER_ADDR initialize_distributed does nothing."""
    port = _free_port()
    env = dict(os.environ, DEVICE="cpu", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="1", RANK="0", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "fraud_detection_tpu_torch.shardfit", "--fit", "psum",
         "--shards", "3", "--out", str(tmp_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = _summary(proc.stdout)
    assert (s["world"], s["backend"], s["global_shards"], s["psum"]) == (1, "gloo", 3, 3.0)
    assert np.load(tmp_path / "rank0.npz")["psum_all_reduce"].tolist() == [1.0]

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.choose_backend(cuda, 2) == "nccl"
    assert pmesh.choose_backend(cuda, 3) == "gloo"  # ranks would share a card
    assert pmesh.choose_backend(torch.device("cpu"), 1) == "gloo"

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert config.distributed_env() is None
    pmesh.initialize_distributed()
    assert pmesh.backend() is None and pmesh.process_count() == 1
    mesh = pmesh.default_mesh("cpu")
    assert (mesh.data, mesh.processes, mesh.global_data) == (1, 1, 1)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert config.distributed_env() == {
        "master_addr": "10.0.0.1", "master_port": 29500, "world_size": 4, "rank": 3,
        "local_rank": 3, "local_world_size": 4,
    }


@pytest.mark.parametrize("argv", [["--fit", "gbt"], ["--fit", "psum", "--shards", "0"]])
def test_shardfit_refuses_what_it_cannot_run(argv, tmp_path):
    with pytest.raises((SystemExit, ValueError)):
        shardfit.main([*argv, *(["--out", str(tmp_path)] if argv[-1] != "gbt" else [])])
