"""BatchNorm's options and SelfNorm's ``is_two`` branch against the JAX
modules, in train mode on the CPU.

BatchNorm (``cnsn_tpu_torch/nn/norm.py``): ``groups`` (per-group two-pass
statistics where the batch divides, the whole batch otherwise),
``stats_sample`` (the leading rows' statistics) and each ``var_impl``
('shifted' through K2's plain version, 'two', 'one'), and the three
``CNSN_BN_*`` variables.  Each case: the output, the running statistics
after the forward, and the gradients of a random projection of the
output with respect to x, the scale and the bias, in float64 (within
1e-10 of JAX) and float32 (the bounds below).  SelfNorm(is_two=True): its
output, both BN1d's running statistics and the input gradient in train
mode, and its eval output, with the weights carried across by
``state_dict_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.nn.cnsn import SelfNorm as JaxSelfNorm
from cnsn_tpu.nn.norm import BatchNorm as JaxBatchNorm
from cnsn_tpu_torch.nn import BatchNorm, SelfNorm
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_nn import _randomize
from test_torch_threads import one_thread  # noqa: F401 (autouse)

C = 16
F64_TOL = 1e-10
# float32, relative to the largest element: the same math in other
# summation orders over up to 8·5·6 rows; 'one' (E[x²] − E[x]², at
# mean² ≫ var here) loses the most, 1.8e-5 of the output and 2.7e-5 of
# the input gradient; the gradients go through the sums twice
F32_TOL = {"out": 5e-5, "stats": 2e-6, "grad": 1e-4}

# (groups, stats_sample, var_impl) at a batch of 8: 3 does not divide it
CASES = [(1, 0, "shifted"), (1, 0, "two"), (1, 0, "one"),
         (2, 0, "shifted"), (4, 0, "shifted"), (3, 0, "shifted"),
         (3, 0, "two"), (1, 3, "shifted"), (1, 3, "two"), (1, 3, "one"),
         (2, 3, "one")]


def _inputs(seed, n=8):
    rng = np.random.RandomState(seed)
    # post-ReLU-like: mean² ≫ var in some channels
    x = (np.abs(rng.randn(n, 5, 6, C)) * rng.uniform(0.5, 3, C)
         + rng.uniform(0, 4, C))
    return x, rng.randn(n, 5, 6, C)


def _jax_bn(module, variables, x, r):
    """JAX's train forward: output, new batch_stats, and the gradients of
    Σ out·r with respect to x, scale and bias."""
    def loss(xx, params):
        out, upd = module.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                xx, False, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd["batch_stats"])

    (_, (out, stats)), (gx, gp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(x, variables["params"])
    return out, stats, gx, gp


def _port_bn(module, x, r):
    xt = torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)
    xt.requires_grad_(True)
    out = module.train()(xt)
    assert out.is_contiguous(memory_format=torch.channels_last)
    (out * torch.from_numpy(np.asarray(r)).permute(0, 3, 1, 2)).sum() \
        .backward()
    return out.detach().permute(0, 2, 3, 1), xt.grad.permute(0, 2, 3, 1)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("groups,sample,var_impl", CASES)
def test_batchnorm_train_matches_jax(groups, sample, var_impl, dtype):
    x, r = _inputs(groups * 10 + sample)
    jm = JaxBatchNorm(C, groups=groups, stats_sample=sample,
                      var_impl=var_impl)
    tm = BatchNorm(C, groups=groups, stats_sample=sample, var_impl=var_impl)
    v = jm.init(jax.random.key(0), jnp.asarray(x, jnp.float32), True)
    rng = np.random.RandomState(7)
    params = _randomize(dict(v["params"]), rng)
    stats = _randomize(dict(v["batch_stats"]), rng, stats=True)
    # a running mean near the batch's: the shift of 'shifted' in play
    stats["mean"] = (x.mean((0, 1, 2)) * 0.9).astype(np.float32)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with jax.enable_x64(dtype == "float64"):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)  # noqa: E731
        out, new, gx, gp = _jax_bn(
            jm, {"params": cast(params), "batch_stats": cast(stats)},
            jnp.asarray(x, dt), jnp.asarray(r, dt))
        want = [np.asarray(a, np.float64) for a in (
            out, new["mean"], new["var"], gx, gp["scale"], gp["bias"])]
    if dtype == "float64":
        tm.double()
    got_out, got_gx = _port_bn(tm, x.astype(dtype), r.astype(dtype))
    assert got_out.dtype == getattr(torch, dtype)
    got = [got_out, tm.running_mean.detach(), tm.running_var.detach(),
           got_gx, tm.weight.grad, tm.bias.grad]
    errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    if dtype == "float64":
        assert max(errs) <= F64_TOL, errs
    else:
        bounds = [F32_TOL[k] for k in ("out", "stats", "stats", "grad",
                                       "grad", "grad")]
        assert all(e <= b for e, b in zip(errs, bounds)), errs


def test_batchnorm_groups_follow_group_zero():
    """The running statistics are group 0's, unbiased with its count; a
    batch the groups do not divide is one group."""
    x, _ = _inputs(3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).double()
    for groups, rows in ((4, 2), (3, 8)):
        bn = BatchNorm(C, groups=groups).double().train()
        bn(xt)
        head = x[:rows]
        n = head[..., 0].size
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   0.1 * head.mean((0, 1, 2)), rtol=1e-12)
        np.testing.assert_allclose(
            bn.running_var.numpy(),
            0.9 + 0.1 * head.var((0, 1, 2)) * n / (n - 1), rtol=1e-12)


def test_batchnorm_env_defaults(monkeypatch):
    """CNSN_BN_GROUPS and CNSN_BN_SAMPLE set a layer's defaults when it is
    built, CNSN_BN_VAR its variance at each training forward; an unknown
    variance raises."""
    x, _ = _inputs(5)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).double()

    def run(bn):  # from a warm running mean: 'shifted' is not 'one'
        bn.running_mean.fill_(0.5)
        return bn.double().train()(xt)

    monkeypatch.setenv("CNSN_BN_GROUPS", "2")
    monkeypatch.setenv("CNSN_BN_SAMPLE", "3")
    built = BatchNorm(C)
    assert (built.groups, built.stats_sample) == (2, 3)
    assert torch.equal(run(built), run(BatchNorm(C, groups=2)))
    monkeypatch.delenv("CNSN_BN_GROUPS")
    sampled = BatchNorm(C)
    assert (sampled.groups, sampled.stats_sample) == (1, 3)
    assert torch.equal(run(sampled), run(BatchNorm(C, stats_sample=3)))
    monkeypatch.delenv("CNSN_BN_SAMPLE")
    bn = BatchNorm(C)
    assert (bn.groups, bn.stats_sample, bn.var_impl) == (1, 0, None)
    shifted = run(BatchNorm(C))
    for var_impl in ("two", "one"):
        monkeypatch.setenv("CNSN_BN_VAR", var_impl)
        got = run(BatchNorm(C))
        assert torch.equal(got, run(BatchNorm(C, var_impl=var_impl)))
        assert not torch.equal(got, shifted)
    monkeypatch.setenv("CNSN_BN_VAR", "three")
    with pytest.raises(ValueError, match="var_impl"):
        run(BatchNorm(C))


def test_batchnorm_eval_ignores_the_options():
    x, _ = _inputs(6)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).float()
    plain = BatchNorm(C).eval()(xt)
    for kw in (dict(groups=2), dict(stats_sample=3), dict(var_impl="one")):
        assert torch.equal(BatchNorm(C, **kw).eval()(xt), plain)


def _selfnorm_pair(x, seed):
    jm = JaxSelfNorm(C, is_two=True)
    tm = SelfNorm(C, is_two=True)
    v = jm.init(jax.random.key(0), jnp.asarray(x, jnp.float32), True)
    rng = np.random.RandomState(seed)
    params = _randomize(dict(v["params"]), rng)
    stats = _randomize(dict(v["batch_stats"]), rng, stats=True)
    assert set(params) == {"g_fc", "g_bn", "f_fc", "f_bn"}
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jm, tm, params, stats


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_selfnorm_is_two_train_matches_jax(dtype):
    """Train: out = x·g + mean·(f − g) with both BN1d's batch statistics,
    the running statistics of g_bn and f_bn after it, and the gradient of
    a random projection with respect to x."""
    rng = np.random.RandomState(11)
    x = rng.randn(4, 6, 5, C) * 1.5 + 0.7
    r = rng.randn(4, 6, 5, C)
    jm, tm, params, stats = _selfnorm_pair(x, 12)
    with jax.enable_x64(dtype == "float64"):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)  # noqa: E731

        def loss(xx):
            out, upd = jm.apply({"params": cast(params),
                                 "batch_stats": cast(stats)},
                                xx, False, mutable=["batch_stats"])
            return jnp.sum(out * jnp.asarray(r, dt)), (out, upd)

        (_, (out, upd)), gx = jax.value_and_grad(loss, has_aux=True)(
            jnp.asarray(x, dt))
        want = [np.asarray(a, np.float64) for a in (
            out, gx, upd["batch_stats"]["g_bn"]["mean"],
            upd["batch_stats"]["g_bn"]["var"],
            upd["batch_stats"]["f_bn"]["mean"],
            upd["batch_stats"]["f_bn"]["var"])]
    if dtype == "float64":
        tm.double()
    xt = torch.from_numpy(x.astype(dtype)).permute(0, 3, 1, 2)
    xt.requires_grad_(True)
    out = tm.train()(xt)
    (out * torch.from_numpy(r.astype(dtype)).permute(0, 3, 1, 2)).sum() \
        .backward()
    got = [out.detach().permute(0, 2, 3, 1), xt.grad.permute(0, 2, 3, 1),
           tm.g_bn.running_mean, tm.g_bn.running_var,
           tm.f_bn.running_mean, tm.f_bn.running_var]
    errs = [_rel(g.detach().numpy(), w) for g, w in zip(got, want)]
    assert max(errs) <= (F64_TOL if dtype == "float64" else 2e-5), errs


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_selfnorm_is_two_eval_matches_jax(dtype):
    """Eval: the running statistics of both BN1d (no K3: it computes no
    f); ``gate_only`` has no is_two branch."""
    x = np.random.RandomState(13).randn(3, 7, 4, C) * 2 - 0.4
    jm, tm, params, stats = _selfnorm_pair(x, 14)
    with jax.enable_x64(dtype == "float64"):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)  # noqa: E731
        want = np.asarray(jm.apply({"params": cast(params),
                                    "batch_stats": cast(stats)},
                                   jnp.asarray(x, dt), True), np.float64)
    if dtype == "float64":
        tm.double()
    xt = torch.from_numpy(x.astype(dtype)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm.eval()(xt).permute(0, 2, 3, 1).numpy()
    assert _rel(got, want) <= (F64_TOL if dtype == "float64" else 1e-5)
    with pytest.raises(ValueError, match="is_two"):
        tm(xt, gate_only=True)
