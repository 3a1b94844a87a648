"""Data parallelism across processes (``cnsn_tpu_torch/parallel/``): the
process group, the rows of a rank, and SyncBatchNorm.

Two gloo ranks on the CPU (one ``RankPool`` for the module, its
rendezvous file under a temporary directory) run BatchNorm in train mode
on their halves of a batch: the output, the running statistics after the
forward, dx, dweight and dbias (the ranks' sums) against the port's
BatchNorm on the whole batch in one process and against JAX's BatchNorm
applied to the batch sharded by ``DataParallel(make_mesh(2))``, in
float64 within 1e-10, for each ``var_impl``, a ``stats_sample`` that
spans both ranks and one that rank 1 misses (K2's plain version then
sees no rows on rank 1), ``groups`` held by one rank each and a group
that spans both; and SelfNorm's BatchNorm1d over the gathered (N, C).
Besides: the group of one process, the backend rule, a failing rank
(``RankPool``, and a ``cli train num_devices=2`` launch), ``spawn``,
remat at two ranks equal to no remat bit for bit, and AugMix's image
CrossNorm pairing across ranks as in one process.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.nn.norm import BatchNorm as JaxBatchNorm
from cnsn_tpu.nn.norm import BatchNorm1dStats as JaxBatchNorm1d
from cnsn_tpu.parallel import DataParallel as JaxDataParallel
from cnsn_tpu.parallel import make_mesh as jax_make_mesh
from cnsn_tpu_torch.parallel import (RankPool, distributed, initialize,
                                     launch, make_mesh, process_batch_slice,
                                     shutdown, world)
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from cnsn_tpu_torch.ops.crossnorm import grouped_permutation
from test_torch_dp_ranks import (C, W, _bad_slice, _bn1d_rows, _bn_rows,
                                 _cn_image_augmix_rows, _one_rank_fails,
                                 _remat_rows, _replicated, _slices,
                                 _spawned)
from test_torch_nn import _randomize
from test_torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-10


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, str(tmp_path_factory.mktemp("store")), device="cpu",
                  timeout=90) as pool:
        yield pool


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- the process group -----------------------------------------------------

def test_process_batch_slice_and_one_process_group(tmp_path):
    """Without a group every rank is the whole batch; a group of one
    process (gloo on the CPU) is world 1, rank 0, and leaves no group
    behind."""
    assert world() is None and process_batch_slice(32) == (0, 32)
    assert make_mesh().size == 1 and make_mesh(1).rank == 0
    with pytest.raises(ValueError):
        make_mesh(2)  # no group of two
    w = initialize(0, 1, "file://" + str(tmp_path / "store"), device="cpu")
    try:
        assert (w.rank, w.size, w.backend) == (0, 1, "gloo")
        assert world() is w and make_mesh(1).size == 1
        assert process_batch_slice(6) == (0, 6)
        t = torch.arange(4.0, requires_grad=True)
        (s,) = distributed.all_reduce_sum(t)
        s.sum().backward()
        assert torch.equal(s, t) and torch.equal(t.grad, torch.ones(4))
        with pytest.raises(RuntimeError):
            initialize(0, 1, "file://" + str(tmp_path / "other"),
                       device="cpu")
    finally:
        shutdown()
    assert world() is None


def test_backend_rule_and_cuda_without_a_card():
    assert distributed.choose_backend("cpu", 2, 0)[0] == "gloo"
    assert distributed.choose_backend("cuda", 1, 1)[0] == "nccl"
    assert distributed.choose_backend("cuda", 4, 4)[0] == "nccl"
    assert distributed.choose_backend("cuda", 2, 1)[0] == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.spawn(print, 2, device="cuda")


def test_rank_slices(ranks):
    got = ranks.run(_slices)
    assert [g[0] for g in got] == [(0, 4), (4, 4)]
    assert got[0][1] == [(0, 4, 4), (4, 7, 4)]
    with pytest.raises(RuntimeError, match="not divisible"):
        ranks.run(_bad_slice)


def test_a_failing_rank_raises_and_stops_the_pool(tmp_path):
    with RankPool(W, str(tmp_path), device="cpu", timeout=30) as pool:
        with pytest.raises(RuntimeError, match="rank 1 fails"):
            pool.run(_one_rank_fails)
        assert not pool._procs  # killed, nothing left waiting


def test_replicate_and_shard(ranks):
    got = ranks.run(_replicated)
    assert list(got[0][:2]) == list(got[1][:2]) == [[1.0] * C, [3.0] * C]
    assert got[0][2] == [0.0, 1.0, 2.0, 3.0]
    assert got[1][2] == [8.0, 10.0, 12.0, 14.0]


# ---- SyncBatchNorm ----------------------------------------------------------

# (groups, stats_sample, var_impl, global batch)
CASES = [(1, 0, "shifted", 8), (1, 0, "two", 8), (1, 0, "one", 8),
         (1, 6, "shifted", 8), (1, 3, "shifted", 8), (1, 3, "two", 8),
         (1, 6, "one", 8), (2, 0, "shifted", 8), (4, 0, "two", 8),
         (3, 0, "shifted", 12)]


def _inputs(seed, n):
    rng = np.random.RandomState(seed)
    x = (np.abs(rng.randn(n, 5, 6, C)) * rng.uniform(0.5, 3, C)
         + rng.uniform(0, 4, C))
    return x, rng.randn(n, 5, 6, C)


def _jax_dp(module, params, stats, x, r):
    """JAX's BatchNorm on x sharded over two devices (DataParallel): out,
    the new statistics and the gradients of Σ out·r."""
    dp = JaxDataParallel(jax_make_mesh(2))
    xs, rs = dp.shard_batch(jnp.asarray(x)), dp.shard_batch(jnp.asarray(r))
    params, stats = dp.replicate((params, stats))

    def loss(xx, p):
        out, upd = module.apply({"params": p, "batch_stats": stats}, xx,
                                False, mutable=["batch_stats"])
        return jnp.sum(out * rs), (out, upd["batch_stats"])

    (_, (out, new)), (gx, gp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(xs, params)
    return [np.asarray(a, np.float64) for a in
            (out, gx, new["mean"], new["var"], gp["scale"], gp["bias"])]


@pytest.mark.parametrize("groups,sample,var_impl,n", CASES)
def test_sync_batchnorm_matches_one_process_and_jax(ranks, groups, sample,
                                                    var_impl, n):
    x, r = _inputs(groups * 10 + sample, n)
    jm = JaxBatchNorm(C, groups=groups, stats_sample=sample,
                      var_impl=var_impl)
    v = jm.init(jax.random.key(0), jnp.asarray(x, jnp.float32), True)
    rng = np.random.RandomState(7)
    params = _randomize(dict(v["params"]), rng)
    stats = _randomize(dict(v["batch_stats"]), rng, stats=True)
    stats["mean"] = (x.mean((0, 1, 2)) * 0.9).astype(np.float32)
    sd = state_dict_from_jax(params, stats)

    got = ranks.run(_bn_rows, sd, x, r, groups, sample, var_impl)
    # the two ranks keep equal running statistics
    for k in (2, 3):
        np.testing.assert_array_equal(got[0][k], got[1][k])
    merged = [np.concatenate([g[0] for g in got]),
              np.concatenate([g[1] for g in got]), got[0][2], got[0][3],
              got[0][4] + got[1][4], got[0][5] + got[1][5]]
    one = _bn_rows(sd, x, r, groups, sample, var_impl)
    errs = [_rel(a, b) for a, b in zip(merged, one)]
    assert max(errs) <= TOL, errs
    with jax.enable_x64(True):
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        want = _jax_dp(jm, cast(params), cast(stats), x, r)
    errs = [_rel(a, b) for a, b in zip(merged, want)]
    assert max(errs) <= TOL, errs
    if sample == 3 and var_impl == "shifted":
        # rank 1 holds none of the sample: its K2 call launched nothing,
        # and both ranks all-reduced the sums forward and backward
        for c in got:
            assert c[6]["bn_sums"] >= 1 and c[6]["bn_sums_bwd"] >= 1


def test_selfnorm_batchnorm1d_gathers_the_global_batch(ranks):
    """SelfNorm's BatchNorm1d over (N, C): its statistics are those of
    the gathered global (N, C), bit for bit those of one process; its
    gradients within 1e-10 of one process's and of JAX's under
    DataParallel."""
    rng = np.random.RandomState(3)
    y, r = rng.randn(8, C) * 2 + 1, rng.randn(8, C)
    jm = JaxBatchNorm1d(C)
    v = jm.init(jax.random.key(0), jnp.asarray(y, jnp.float32), True)
    params = _randomize(dict(v["params"]), rng)
    stats = _randomize(dict(v["batch_stats"]), rng, stats=True)
    sd = state_dict_from_jax(params, stats)
    got = ranks.run(_bn1d_rows, sd, y, r)
    one = _bn1d_rows(sd, y, r)
    for k in (2, 3):
        np.testing.assert_array_equal(got[0][k], one[k])
        np.testing.assert_array_equal(got[1][k], one[k])
    merged = [np.concatenate([g[0] for g in got]),
              np.concatenate([g[1] for g in got]), got[0][2], got[0][3],
              got[0][4] + got[1][4], got[0][5] + got[1][5]]
    np.testing.assert_array_equal(merged[0], one[0])
    assert max(_rel(a, b) for a, b in zip(merged, one)) <= TOL
    with jax.enable_x64(True):
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        want = _jax_dp(jm, cast(params), cast(stats), y, r)
    assert max(_rel(a, b) for a, b in zip(merged, want)) <= TOL


def test_spawn_runs_every_rank(tmp_path):
    launch.spawn(_spawned, W, args=(str(tmp_path),), device="cpu",
                 timeout=60)
    assert sorted(os.listdir(tmp_path)) == ["rank0", "rank1"]
    assert (tmp_path / "rank1").read_text() == "2 gloo"


def test_remat_at_two_ranks_equals_no_remat_bit_for_bit(ranks):
    """The recomputation issues the forward's collectives again on every
    rank in the same order (and replays BatchNorm's shift): the two
    ranks' remat steps equal their steps without, bit for bit."""
    with_remat = ranks.run(_remat_rows, True, 3)
    without = ranks.run(_remat_rows, False, 3)
    for a, b in zip(with_remat, without):
        for k, v in a.items():
            assert torch.equal(v, b[k]), k


def test_cli_launch_with_a_failing_rank_exits_non_zero(tmp_path):
    """``cli train num_devices=2`` whose ranks raise (a batch of 63 does
    not divide over two ranks): the launch ends, non-zero, with the
    ranks' error, before anything is written."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run(
        [sys.executable, "-m", "cnsn_tpu_torch.cli", "train", "--config",
         os.path.join(root, "cnsn_tpu", "configs", "cifar10", "allconv",
                      "cn.yaml"), "--device", "cpu", "synthetic_data=true",
         "num_devices=2", "batch_size=63", f"exp_dir={tmp_path / 'exp'}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "must be divisible by the data-parallel width 2" in proc.stderr
    assert not (tmp_path / "exp").exists()


def test_cn_image_augmix_pairs_across_ranks_as_in_one_process(ranks):
    """JAX pairs the cn_image_augmix views within ``num_groups`` blocks
    of its flattened global 3B batch (view major), blocks that interleave
    the ranks' rows: at two ranks, with a pairing that crosses them, the
    step equals the port's step on the whole batch in one process (which
    ``test_torch_augmix_steps.py`` holds to JAX's on a fed pairing):
    the loss within 1e-10, every tensor of the state within 1e-6 of its
    max-abs, or of 1e-9 (the BatchNorm biases that IBN-b's InstanceNorms
    leave without a gradient, as there)."""
    rng = np.random.RandomState(4)
    images3 = rng.randn(3, 4, 64, 64, 3)
    labels = rng.randint(0, 10, 4)
    perm = grouped_permutation(12, W, torch.Generator().manual_seed(1))
    rank_of = lambda g: (g % 4) // 2  # noqa: E731 — view-major, b=2 a rank
    assert any(rank_of(i) != rank_of(int(p)) for i, p in enumerate(perm))
    got = ranks.run(_cn_image_augmix_rows, images3, labels, perm)
    loss, state = _cn_image_augmix_rows(images3, labels, perm)
    for g_loss, g_state in got:
        assert abs(g_loss - loss) <= TOL * abs(loss)
        for k, v in state.items():
            if v.is_floating_point():
                err = float((g_state[k] - v).abs().max())
                assert err <= 1e-6 * max(float(v.abs().max()), 1e-9), k
