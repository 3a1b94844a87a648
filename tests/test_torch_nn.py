"""Port layers (cnsn_tpu_torch.nn) against the JAX modules in eval mode.

The JAX module is initialised, its parameters and running statistics are
replaced by random non-trivial values (numpy, seeded), and the same trees
are carried into the port with ``state_dict_from_jax``.  Both then run on
the same NHWC input; the port sees it as an NCHW channels_last view.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.nn.cnsn import CNSN as JaxCNSN
from cnsn_tpu.nn.cnsn import SelfNorm as JaxSelfNorm
from cnsn_tpu.nn.norm import BatchNorm as JaxBatchNorm
from cnsn_tpu.nn.norm import BatchNorm1dStats as JaxBatchNorm1dStats
from cnsn_tpu_torch.nn import (CNSN, BatchNorm, BatchNorm1dStats, CrossNorm,
                               SelfNorm)
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax

# fp32 layers: identical math, other summation and fma order; the
# SelfNorm statistics reduce over H·W (~1e-6 relative).
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _randomize(tree, rng, stats=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(dict(v), rng, stats)
            continue
        shape = np.shape(v)
        if stats and k == "var":
            out[k] = rng.uniform(0.5, 2.0, shape)
        elif stats:
            out[k] = rng.randn(*shape) * 0.3
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, shape)
        else:
            out[k] = rng.randn(*shape) * 0.3
        out[k] = out[k].astype(np.float32)
    return out


def _carry(jax_module, port_module, x, *args, seed=0):
    """Init the JAX module, randomise its trees, load them into the port
    module; return the JAX variables."""
    rng = np.random.RandomState(seed)
    v = jax_module.init(jax.random.key(0), jnp.asarray(x), *args)
    params = _randomize(dict(v["params"]), rng) if "params" in v else {}
    stats = (_randomize(dict(v["batch_stats"]), rng, stats=True)
             if "batch_stats" in v else {})
    port_module.load_state_dict(state_dict_from_jax(params, stats),
                                strict=True)
    port_module.eval()
    return {"params": params, "batch_stats": stats}


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)


def _nhwc_np(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


def _x(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 2 + 0.5).astype(
        np.float32)


def test_batchnorm_eval_matches_jax_f32():
    x = _x((2, 6, 5, 24), 0)
    jm, tm = JaxBatchNorm(24), BatchNorm(24)
    v = _carry(jm, tm, x, True)
    want = jm.apply(v, jnp.asarray(x), True)
    got = tm(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc_np(got), np.asarray(want), **F32_TOL)


def test_batchnorm_eval_bf16_computes_f32_casts_back():
    """bf16 in, bf16 out, computed in fp32: the two sides round the fp32
    result once, so they agree to 1 bf16 ulp (at most 2^-7 relative)."""
    x = _x((2, 6, 5, 24), 1)
    jm, tm = JaxBatchNorm(24), BatchNorm(24)
    v = _carry(jm, tm, x, True, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jm.apply(v, xb, True)
    got = tm(_nchw(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc_np(got),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_batchnorm1d_stats_eval_and_fold_match_jax():
    y = _x((5, 16), 2)
    jm, tm = JaxBatchNorm1dStats(16), BatchNorm1dStats(16)
    v = _carry(jm, tm, y, True, seed=2)
    want = np.asarray(jm.apply(v, jnp.asarray(y), True))
    ty = torch.from_numpy(y)
    np.testing.assert_allclose(tm(ty).detach().numpy(), want, **F32_TOL)
    a, b = tm.folded_affine()
    np.testing.assert_allclose((a * ty + b).detach().numpy(), want,
                               **F32_TOL)


@pytest.mark.parametrize("shape", [(2, 7, 7, 256), (3, 9, 5, 40)])
def test_selfnorm_eval_matches_jax(shape):
    c = shape[-1]
    x = _x(shape, c)
    jm, tm = JaxSelfNorm(c), SelfNorm(c)
    v = _carry(jm, tm, x, True, seed=c)
    want = jm.apply(v, jnp.asarray(x), True)
    with torch.no_grad():
        got = tm(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("cnsn_type", ["sn", "cnsn"])
def test_cnsn_eval_matches_jax(cnsn_type):
    """Eval CNSN (no active CrossNorm site) is SelfNorm alone."""
    x = _x((2, 6, 6, 64), 3)
    jm, tm = JaxCNSN(64, cnsn_type), CNSN(64, cnsn_type)
    v = _carry(jm, tm, x, None, True, seed=3)
    want = jm.apply(v, jnp.asarray(x), None, True)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc_np(got), np.asarray(want), **F32_TOL)


def test_inactive_crossnorm_is_identity():
    x = _nchw(_x((2, 4, 4, 8), 4))
    assert CrossNorm()(x) is x
    assert CNSN(8, "cn")(x) is x
    with pytest.raises(NotImplementedError, match="not ported yet"):
        CrossNorm()(x, torch.tensor(True))


@pytest.mark.parametrize("module", [BatchNorm(8, groups=2),
                                    BatchNorm(8, stats_sample=1),
                                    BatchNorm(8, var_impl="two")])
def test_training_forward_raises(module):
    """BN's JAX options off the single-card flagship path are not ported:
    a training forward with one of them raises (eval is unaffected)."""
    x = torch.ones(2, 8, 3, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        module.train()(x)
    assert module.eval()(x).shape == x.shape


def test_selfnorm_is_two_raises():
    with pytest.raises(NotImplementedError, match="is_two"):
        SelfNorm(8, is_two=True)
