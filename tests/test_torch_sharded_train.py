"""The port's sharded training over the data axis (item 12b, the data axis)
against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through both packages; the
JAX side runs on ``create_mesh`` over ``jax.devices()[:N]`` (the suite's 8
virtual CPU devices), the port on a grid of N shards on the CPU. Tolerances:

- the collectives: ``psum`` bitwise the left-to-right fold of the shards'
  partials in shard order, a one-shard ``psum`` bitwise its partial;
  integer sums, ``pmax``, ``all_gather`` and ``psum_scatter`` exact; the
  values within 1e-6 of JAX's under ``shard_map``;
- ``scaler_fit_sharded``: within 1e-6 (relative) of JAX's at N = 8;
  bitwise ``scaler_fit`` at N = 1;
- the sharded L-BFGS: within JAX's own sharded-vs-single tolerance (rtol
  5e-3, atol 5e-4, ``tests/test_logistic.py``) of JAX's sharded fit and of
  the port's unsharded fit; bitwise the unsharded fit at N = 1;
- ``logistic_fit_sgd`` at N = 4: within 1e-4 of JAX's (the same batches and
  permutation stream; float32 sums reassociate); a JAX checkpoint saved at
  8 devices resumes in the port at 8 shards, within 1e-4 of JAX's
  uninterrupted fit, and is refused at 4;
- ``gbt_fit(sharded=True)`` on JAX's ``tests/test_gbt.py`` fixture: equal
  splits, leaves within rtol 1e-4 (atol 1e-6) of JAX's sharded fit; the
  port's sharded CPU forest bitwise the same at N = 1, 2, 4, 8;
- ``gbt_hist``'s split phase in plain PyTorch: the shards' int64
  accumulators, in the quanta of the global real-row count, sum bitwise to
  the unsharded accumulator at shard sizes that move ``frexp(n·max)``;
- ``mesh_sgd_fit`` at N = 1 and 4: one epoch within JAX's host-reference
  tolerance (rtol 1e-4, atol 1e-5) of a float64 numpy update and within
  1e-5 of JAX's epoch; converged coefficients within 1e-3 of JAX's fit
  and at cosine > 0.99 of L-BFGS, the warm start at > 0.9999;
- ``mapreduce_pool_stats`` at N = 8 on 1000 rows: counts equal, moments
  within 1e-5 of numpy's and JAX's.
"""

import json

import jax
import numpy as np
import pytest
import torch

from fraud_detection_tpu.ckpt.train_state import SGDCheckpointer as JaxCheckpointer
from fraud_detection_tpu.mesh.retrain import _pad_features as jax_pad_features
from fraud_detection_tpu.mesh.retrain import _sharded_update_epoch as jax_update_epoch
from fraud_detection_tpu.mesh.retrain import mapreduce_pool_stats as jax_pool_stats
from fraud_detection_tpu.mesh.retrain import mesh_sgd_fit as jax_mesh_sgd_fit
from fraud_detection_tpu.ops import gbt as jgbt
from fraud_detection_tpu.ops.logistic import logistic_fit_lbfgs as jax_lbfgs
from fraud_detection_tpu.ops.logistic import logistic_fit_sgd as jax_sgd
from fraud_detection_tpu.ops.scaler import scaler_fit_sharded as jax_scaler_fit_sharded
from fraud_detection_tpu.parallel import collectives as jcoll
from fraud_detection_tpu.parallel.mesh import create_mesh as jax_create_mesh
from fraud_detection_tpu.parallel.sharding import shard_batch as jax_shard_batch
from fraud_detection_tpu_torch.ckpt.train_state import SGDCheckpointer
from fraud_detection_tpu_torch.mesh.retrain import (
    _pad_features,
    _sharded_update_epoch,
    mapreduce_pool_stats,
    mesh_sgd_fit,
)
from fraud_detection_tpu_torch.ops import gbt, kernels
from fraud_detection_tpu_torch.ops.logistic import logistic_fit_lbfgs, logistic_fit_sgd
from fraud_detection_tpu_torch.ops.scaler import scaler_fit, scaler_fit_sharded
from fraud_detection_tpu_torch.parallel import collectives as coll
from fraud_detection_tpu_torch.parallel.mesh import Mesh, MeshSpec, create_mesh
from fraud_detection_tpu_torch.parallel.sharding import batch_sharding, shard_batch

torch.set_num_threads(1)

D = 30


def _mesh(n: int) -> Mesh:
    return create_mesh(MeshSpec(data=n), devices=["cpu"] * n)


def _jax_mesh(n: int):
    return jax_create_mesh(devices=jax.devices()[:n])


def _imbalanced(n: int = 4000, seed: int = 42):
    """The suite's ``imbalanced_data`` recipe (tests/conftest.py), drawn
    from its own generator."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    w_true = rng.standard_normal(D).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w_true - 4.0)))).astype(np.int32)
    if y.sum() < 20:
        y[:20] = 1
    return x, y


def _logistic_rows(n: int = 2048, seed: int = 0):
    """JAX's ``test_mesh_sgd_fit_converges_and_warm_starts`` rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    w_true = rng.standard_normal(D).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w_true - 1.0)))).astype(np.int32)
    return x, y


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_psum_folds_in_shard_order_and_matches_jax(n):
    """psum is the left-to-right fold of the shards' partials (bitwise), a
    one-shard psum returns its partial; integer psum, pmax, all_gather and
    psum_scatter are exact; values within 1e-6 of JAX's psum, all_gather
    and psum_scatter under shard_map."""
    mesh = _mesh(n)
    rng = np.random.default_rng(n)
    parts = rng.standard_normal((n, 8, 3)).astype(np.float32) * 1e3
    got = coll.psum(torch.from_numpy(parts), mesh)
    fold = parts[0].copy()
    for p in parts[1:]:
        fold = fold + p
    assert got.numpy().tobytes() == fold.tobytes()
    ints = rng.integers(-2**40, 2**40, (n, 5))
    assert torch.equal(coll.psum(torch.from_numpy(ints), mesh), torch.from_numpy(ints.sum(0)))
    assert torch.equal(coll.pmax(torch.from_numpy(ints), mesh), torch.from_numpy(ints.max(0)))
    assert torch.equal(coll.pmean(torch.from_numpy(parts), mesh), got / n)
    assert torch.equal(coll.all_gather(torch.from_numpy(parts), mesh), torch.from_numpy(parts))
    full = rng.standard_normal((n, 4 * n)).astype(np.float32)
    scat = coll.psum_scatter(torch.from_numpy(full), mesh)
    assert tuple(scat.shape) == (n, 4)
    assert torch.equal(scat.reshape(-1), coll.psum(torch.from_numpy(full), mesh))
    # JAX: each device's row of `full` as its shard-local value
    jm = _jax_mesh(n)

    def body(v):
        return (jcoll.psum_data(v[0]), jcoll.all_gather_data(v, axis=0),
                jax.lax.psum_scatter(v[0], "data", scatter_dimension=0, tiled=True))

    f = jax.jit(jax.shard_map(body, mesh=jm, in_specs=jax.sharding.PartitionSpec("data"),
                              out_specs=(jax.sharding.PartitionSpec(),
                                         jax.sharding.PartitionSpec(),
                                         jax.sharding.PartitionSpec("data")),
                              check_vma=False))
    j_sum, j_gather, j_scat = f(full)
    # the JAX package's names, as its shard_map bodies call them
    np.testing.assert_allclose(coll.psum_data(torch.from_numpy(full), mesh).numpy(),
                               np.asarray(j_sum), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(coll.all_gather_data(torch.from_numpy(full), mesh).numpy(),
                                  np.asarray(j_gather))
    assert torch.equal(coll.pmean_data(torch.from_numpy(full), mesh),
                       coll.psum(torch.from_numpy(full), mesh) / n)
    np.testing.assert_allclose(scat.reshape(-1).numpy(), np.asarray(j_scat),
                               rtol=1e-6, atol=1e-6)


def test_psum_and_replicate_are_each_others_transpose():
    """The gradient of a psum reaches every partial; the gradient of a
    replicated tensor is the fold of its copies' gradients, in shard order;
    data_parallel maps a function over the shard axis."""
    mesh = _mesh(4)
    w = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 5, 3)).astype(np.float32))
    reps = coll.replicate(w, mesh)
    assert tuple(reps.shape) == (4, 3)
    parts = torch.stack([(x[s] @ reps[s]).square().sum() for s in range(4)])
    coll.psum(parts, mesh).backward()
    grads = [2.0 * x[s].T @ (x[s] @ w.detach()) for s in range(4)]
    fold = ((grads[0] + grads[1]) + grads[2]) + grads[3]
    assert torch.equal(w.grad, fold)
    mapped = coll.data_parallel(lambda xs, k: xs.sum(0) * k, mesh)
    assert torch.equal(mapped(x, 2.0), torch.stack([x[s].sum(0) * 2.0 for s in range(4)]))
    with pytest.raises(ValueError, match="leading shard axis"):
        coll.psum(torch.zeros(3, 2), mesh)


def test_shard_batch_keeps_this_process_rows():
    """Under a group every process pads to processes × shards and keeps its
    own shards' segments (rank 1 of 2, 4 shards a rank: rows 2·4·b …)."""
    x = np.arange(2 * 19, dtype=np.float32).reshape(19, 2)
    for rank in (0, 1):
        mesh = Mesh(torch.device("cpu"), data=4, processes=2, process=rank)
        assert (mesh.global_data, mesh.shard_offset) == (8, 4 * rank)
        t, n = shard_batch(x, mesh)
        assert n == 19 and tuple(t.shape) == (12, 2)
        padded = np.zeros((24, 2), np.float32)
        padded[:19] = x
        np.testing.assert_array_equal(t.numpy(), padded[12 * rank:12 * (rank + 1)])
        assert tuple(batch_sharding(mesh).segments(t).shape) == (4, 3, 2)


# ---------------------------------------------------------------------------
# the scaler and the logistic fits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 8])
def test_scaler_fit_sharded_matches_jax(n):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((1003, D)) * 5 + 100).astype(np.float32)  # high-mean columns
    x[:, 3] = 7.0  # a zero-variance column scales by 1
    got = scaler_fit_sharded(x, _mesh(n))
    want = jax_scaler_fit_sharded(x, _jax_mesh(n))
    for k in ("mean", "scale", "var"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-6 * (k == "var"))
    assert float(got.n_samples) == float(want.n_samples) == 1003.0
    assert float(got.scale[3]) == 1.0
    if n == 1:
        plain = scaler_fit(torch.from_numpy(x))
        for k in ("mean", "scale", "var", "n_samples"):
            assert torch.equal(getattr(got, k), getattr(plain, k)), k


@pytest.mark.parametrize("n", [1, 8])
def test_sharded_lbfgs_matches_jax_and_the_unsharded_fit(n):
    x, y = _imbalanced()
    info: dict = {}
    got = logistic_fit_lbfgs(x, y, max_iter=200, mesh=_mesh(n), sharded=True, info=info)
    plain = logistic_fit_lbfgs(x, y, max_iter=200)
    want = jax_lbfgs(x, y, max_iter=200, sharded=True, mesh=_jax_mesh(n))
    for other in (np.asarray(want.coef), plain.coef.numpy()):
        np.testing.assert_allclose(got.coef.numpy(), other, rtol=5e-3, atol=5e-4)
    assert float(got.intercept) == pytest.approx(float(want.intercept), rel=5e-3, abs=5e-4)
    assert info["n_iter"] > 0
    if n == 1:
        assert torch.equal(got.coef, plain.coef) and torch.equal(got.intercept, plain.intercept)
    # warm start and class weights go through the shards too
    bal = logistic_fit_lbfgs(x, y, max_iter=200, class_weight="balanced",
                             warm_start=got, mesh=_mesh(n), sharded=True)
    jbal = jax_lbfgs(x, y, max_iter=200, class_weight="balanced", sharded=True,
                     mesh=_jax_mesh(n))
    np.testing.assert_allclose(bal.coef.numpy(), np.asarray(jbal.coef), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_sgd_matches_jax(n):
    x, y = _imbalanced(3001, seed=3)
    kw = dict(epochs=4, batch_size=256, lr=0.5, class_weight="balanced", seed=7)
    got = logistic_fit_sgd(x, y, mesh=_mesh(n), **kw)
    want = jax_sgd(x, y, mesh=_jax_mesh(n), **kw)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=0, atol=1e-4)
    assert float(got.intercept) == pytest.approx(float(want.intercept), abs=1e-4)


def test_jax_checkpoint_at_8_devices_resumes_at_8_shards_and_not_4(tmp_path):
    x, y = _imbalanced(2500, seed=4)
    kw = dict(epochs=3, batch_size=128, lr=0.5, class_weight="balanced", seed=2)
    full = jax_sgd(x, y, mesh=_jax_mesh(8), **kw)
    ck = JaxCheckpointer(str(tmp_path))

    class Stop(Exception):
        pass

    def cut(epoch, *a):
        ck.epoch_callback(epoch, *a)
        if epoch == 0:
            raise Stop

    with pytest.raises(Stop):
        jax_sgd(x, y, mesh=_jax_mesh(8), epoch_callback=cut, **kw)
    saved = SGDCheckpointer(str(tmp_path)).latest()
    assert saved["fingerprint"]["ndev"] == 8 and int(saved["epoch"]) == 0
    resumed = logistic_fit_sgd(x, y, mesh=_mesh(8), resume=saved, **kw)
    np.testing.assert_allclose(resumed.coef.numpy(), np.asarray(full.coef), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="ndev"):
        logistic_fit_sgd(x, y, mesh=_mesh(4), resume=saved, **kw)


# ---------------------------------------------------------------------------
# the forest
# ---------------------------------------------------------------------------

GBT_CFG = dict(n_trees=10, max_depth=3, learning_rate=0.3, n_bins=32)


def test_sharded_gbt_matches_jax_sharded_fit():
    """JAX's ``test_sharded_matches_single_device`` fixture (1000 rows of
    the imbalanced set): equal splits, leaves within rtol 1e-4."""
    x, y = _imbalanced()
    x, y = x[:1000], y[:1000]
    got = gbt.gbt_fit(x, y, gbt.GBTConfig(**GBT_CFG), mesh=_mesh(8), sharded=True)
    want = jgbt.gbt_fit(x, y, jgbt.GBTConfig(**GBT_CFG), mesh=_jax_mesh(8), sharded=True)
    np.testing.assert_array_equal(got.split_feature.numpy(), np.asarray(want.split_feature))
    np.testing.assert_array_equal(got.split_bin.numpy(), np.asarray(want.split_bin))
    np.testing.assert_allclose(got.leaf_value.numpy(), np.asarray(want.leaf_value),
                               rtol=1e-4, atol=1e-6)
    assert got.bin_edges.numpy().tobytes() == np.asarray(want.bin_edges).tobytes()


def test_sharded_cpu_forest_does_not_depend_on_the_shard_count():
    """The CPU's sharded fit runs the kernel's fixed-point arithmetic with
    global quanta: N = 1, 2, 4, 8 give the same forest bit for bit (1003
    rows: every N pads), with the unsharded fit's splits."""
    x, y = _imbalanced(1003, seed=9)
    cfg = gbt.GBTConfig(n_trees=6, max_depth=4, n_bins=32, scale_pos_weight=3.0)
    forests = {n: gbt.gbt_fit(x, y, cfg, mesh=_mesh(n), sharded=True) for n in (1, 2, 4, 8)}
    for n in (2, 4, 8):
        for a, b in zip(forests[1], forests[n]):
            assert a.numpy().tobytes() == b.numpy().tobytes(), n
    plain = gbt.gbt_fit(x, y, cfg, device="cpu")
    assert torch.equal(plain.split_feature, forests[1].split_feature)
    assert torch.equal(plain.split_bin, forests[1].split_bin)
    np.testing.assert_allclose(plain.leaf_value.numpy(), forests[1].leaf_value.numpy(),
                               rtol=0, atol=1e-6)
    assert kernels.GBT_HIST_LAUNCHES == 0  # the plain versions never count


def _split_inputs(n_real: int, n_shards: int, seed: int):
    rng = np.random.default_rng(seed)
    n_pad = -(-n_real // n_shards) * n_shards
    bins = rng.integers(0, 64, (n_pad, 7)).astype(np.uint8)
    local = rng.integers(-1, 4, n_pad).astype(np.int32)
    g = (rng.standard_normal(n_pad) * 0.3).astype(np.float32)
    h = rng.random(n_pad).astype(np.float32) * 0.25
    g[n_real:] = 0.0  # padded rows weigh 0
    h[n_real:] = 0.0
    local[n_real:] = 0  # ... and sit in a live node
    return tuple(torch.from_numpy(a) for a in (bins, local, g, h))


@pytest.mark.parametrize("n_real, n_shards", [(1000, 2), (1000, 4), (1001, 8), (4097, 4)])
def test_split_phase_accumulators_sum_to_the_unsharded_cells(n_real, n_shards):
    """Each shard's max pass, their pmax, each shard's accumulate in the
    quanta of the global real-row count: the int64 accumulators sum to the
    unsharded launch's bitwise, and finish to its histogram. A shard's own
    row count moves frexp(n·max) by a power of two, so quanta from the
    shard's own rows (the pitfall) would count in other units."""
    bins, local, g, h = _split_inputs(n_real, n_shards, seed=n_real + n_shards)
    n_nodes, n_bins = 4, 64
    whole, q_whole = kernels.gbt_hist_fixed_point_reference(
        bins[:n_real], local[:n_real], g[:n_real], h[:n_real], n_nodes, n_bins,
        accumulator=True)
    rows = bins.shape[0] // n_shards
    segs = [slice(s * rows, (s + 1) * rows) for s in range(n_shards)]
    mesh = _mesh(n_shards)
    bits = coll.pmax(torch.stack([kernels.gbt_hist_max(local[r], g[r], h[r], n_nodes)
                                  for r in segs]), mesh)
    assert torch.equal(bits, kernels.gbt_hist_max_reference(local, g, h, n_nodes))
    acc = torch.zeros((n_shards, 7, n_nodes, n_bins, 2), dtype=torch.int64)
    quanta = torch.empty(2, dtype=torch.float64)
    for s, r in enumerate(segs):
        kernels.gbt_hist_accumulate(bins[r], local[r], g[r], h[r], n_nodes, n_bins,
                                    bits, n_real, acc[s], quanta)
    assert tuple(quanta.tolist()) == q_whole
    total = coll.psum(acc, mesh)
    assert torch.equal(total, whole)
    hist = kernels.gbt_hist_finish(total, quanta)
    want, _ = kernels.gbt_hist_fixed_point_reference(
        bins[:n_real], local[:n_real], g[:n_real], h[:n_real], n_nodes, n_bins)
    assert hist.numpy().tobytes() == want.numpy().tobytes()
    # the pitfall: a shard's own quanta are another power of two
    own = [kernels.gbt_hist_fixed_point_reference(bins[r], local[r], g[r], h[r],
                                                  n_nodes, n_bins)[1] for r in segs]
    assert any(q != q_whole for q in own)


def test_split_phase_wrappers_check_their_inputs():
    bins, local, g, h = _split_inputs(64, 1, seed=0)
    acc = torch.zeros((7, 4, 64, 2), dtype=torch.int64)
    q = torch.empty(2, dtype=torch.float64)
    bits = kernels.gbt_hist_max(local, g, h, 4)
    with pytest.raises(ValueError, match="n_total"):
        kernels.gbt_hist_accumulate(bins, local, g, h, 4, 64, bits, 10, acc, q)
    with pytest.raises(ValueError, match="accumulator"):
        kernels.gbt_hist_accumulate(bins, local, g, h, 4, 32, bits, 64, acc, q)
    with pytest.raises(TypeError, match="int32 local"):
        kernels.gbt_hist_max(local.long(), g, h, 4)
    with pytest.raises(ValueError, match="quanta"):
        kernels.gbt_hist_finish(acc, q.float())
    # NaN in a live row: that channel's quantum is NaN, every cell NaN
    g2 = g.clone()
    g2[local >= 0] = float("nan")
    bits = kernels.gbt_hist_max(local, g2, h, 4)
    kernels.gbt_hist_accumulate(bins, local, g2, h, 4, 64, bits, 64, acc, q)
    out = kernels.gbt_hist_finish(acc, q)
    assert torch.isnan(out[..., 0]).all() and torch.isfinite(out[..., 1]).all()


# ---------------------------------------------------------------------------
# the sharded weight update and the pool stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndev", [1, 4])
def test_sharded_update_step_matches_host_reference_and_jax(ndev):
    """JAX's ``test_sharded_update_step_matches_host_reference``: one epoch
    of the cross-replica-sharded update (all_gather → psum_scatter → local
    slice update) on two minibatch steps a shard, identity permutation."""
    batch, c, momentum, lr = 16, 1.0, 0.9, 0.25
    rng = np.random.default_rng(3)
    n = ndev * batch * 2
    d_pad = _pad_features(D, ndev)
    assert d_pad == jax_pad_features(D, ndev)
    x = np.zeros((n, d_pad), np.float32)
    x[:, :D] = rng.standard_normal((n, D)).astype(np.float32)
    y_pm = np.where(rng.integers(0, 2, n) > 0, 1.0, -1.0).astype(np.float32)
    sw = np.ones(n, np.float32)
    valid = np.ones(n, np.float32)
    n_local = n // ndev
    perm = np.arange(n_local)
    mesh = _mesh(ndev)
    seg = batch_sharding(mesh).segments
    k = d_pad // ndev
    out = _sharded_update_epoch(
        torch.zeros((ndev, k)), torch.zeros((ndev, k)), torch.zeros(()), torch.zeros(()),
        seg(torch.from_numpy(x)), seg(torch.from_numpy(y_pm)), seg(torch.from_numpy(sw)),
        seg(torch.from_numpy(valid)), torch.from_numpy(perm), lr,
        mesh=mesh, c=c, n_total=n, momentum=momentum, batch=batch,
    )
    coef_got = out[0].reshape(-1).numpy()[:D]
    b_got = float(out[2])
    x_sh, y_sh = x.reshape(ndev, n_local, d_pad), y_pm.reshape(ndev, n_local)
    w, b, vw, vb = np.zeros(d_pad), 0.0, np.zeros(d_pad), 0.0
    for i in range(n_local // batch):
        xb = x_sh[:, i * batch:(i + 1) * batch].reshape(-1, d_pad)
        yb = y_sh[:, i * batch:(i + 1) * batch].reshape(-1)
        sig = 1.0 / (1.0 + np.exp(yb * (xb @ w + b)))
        gz = -yb * sig * (c / len(yb))
        vw = momentum * vw - lr * (xb.T @ gz + w / n)
        w = w + vw
        vb = momentum * vb - lr * gz.sum()
        b = b + vb
    np.testing.assert_allclose(coef_got, w[:D], rtol=1e-4, atol=1e-5)
    assert b_got == pytest.approx(b, rel=1e-4, abs=1e-5)
    jm = _jax_mesh(ndev)
    sharding = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("data"))
    jout = jax_update_epoch(
        jax.device_put(np.zeros(d_pad, np.float32), sharding),
        jax.device_put(np.zeros(d_pad, np.float32), sharding),
        np.float32(0.0), np.float32(0.0),
        *(jax_shard_batch(a, jm)[0] for a in (x, y_pm, sw, valid)),
        perm.astype(np.int32), np.float32(lr),
        mesh=jm, c=c, n_total=n, momentum=momentum, batch=batch,
    )
    np.testing.assert_allclose(out[0].reshape(-1).numpy(), np.asarray(jout[0]),
                               rtol=0, atol=1e-5)
    assert b_got == pytest.approx(float(jout[2]), abs=1e-5)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_mesh_sgd_fit_converges_warm_starts_and_matches_jax(n_shards):
    x, y = _logistic_rows()
    ref = logistic_fit_lbfgs(x, y, max_iter=100)
    mesh = _mesh(n_shards)
    p = mesh_sgd_fit(x, y, epochs=8, batch_size=256, lr=0.5, mesh=mesh)
    jp = jax_mesh_sgd_fit(x, y, epochs=8, batch_size=256, lr=0.5, mesh=_jax_mesh(n_shards))
    np.testing.assert_allclose(p.coef.numpy(), np.asarray(jp.coef), rtol=0, atol=1e-3)
    assert float(p.intercept) == pytest.approx(float(jp.intercept), abs=1e-3)
    cos = float(p.coef @ ref.coef / (p.coef.norm() * ref.coef.norm()))
    assert cos > 0.99, f"sharded-update fit diverges from L-BFGS (cos={cos})"
    warm = mesh_sgd_fit(x, y, epochs=2, batch_size=256, lr=0.02, mesh=mesh, warm_start=ref)
    cos_w = float(warm.coef @ ref.coef / (warm.coef.norm() * ref.coef.norm()))
    assert cos_w > 0.9999


def test_mapreduce_pool_stats_across_shards_matches_numpy_and_jax():
    rng = np.random.default_rng(5)
    n = 1000  # deliberately not a multiple of the mesh size
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    s = rng.random(n).astype(np.float32)
    out = mapreduce_pool_stats(x, y, s, mesh=_mesh(8))
    want = jax_pool_stats(x, y, s, mesh=_jax_mesh(8))
    assert out["rows"] == want["rows"] == n
    assert out["positives"] == want["positives"] == int(y.sum())
    assert out["label_rate"] == pytest.approx(y.mean(), rel=1e-5)
    assert out["score_mean"] == pytest.approx(float(want["score_mean"]), rel=1e-5)
    for key, ref in (("feature_mean", x.mean(0)), ("feature_std", x.std(0))):
        np.testing.assert_allclose(out[key], ref, atol=1e-5)
        np.testing.assert_allclose(out[key], want[key], atol=1e-5)
    # one shard: the one-pass sums of the unsharded summary, bit for bit
    one = mapreduce_pool_stats(x, y, s, mesh=_mesh(1))
    v = torch.ones(n)
    xt = torch.from_numpy(x)
    assert one["feature_mean"].tobytes() == (
        (v @ xt).numpy().astype(np.float64) / float(v.sum())).tobytes()
    assert mapreduce_pool_stats(np.zeros((0, D), np.float32), [], [], mesh=_mesh(8))["rows"] == 0
    json.dumps({k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in out.items()})
