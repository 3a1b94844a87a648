"""The port's CrossNorm ops (cnsn_tpu_torch.ops: bbox, masked statistics,
cross_norm_2ins, cross_norm_fma) against the JAX package's, on the CPU.

Inputs are numpy draws from a seed, handed to both.  JAX draws its
permutation, boxes and channel permutation from a key
(``cnsn_tpu/ops/crossnorm.py:86-89``: the key split four ways); the same
draws, taken from that key here, are fed to the port.  The port's own box
sampler is held to JAX's in distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from cnsn_tpu.ops import bbox as jax_bbox
from cnsn_tpu.ops import crossnorm as jax_cn
from cnsn_tpu.ops import stats as jax_stats
from cnsn_tpu_torch.ops.bbox import sample_bbox
from cnsn_tpu_torch.ops.crossnorm import (CROP_MODES, cross_norm_2ins,
                                          cross_norm_fma)
from cnsn_tpu_torch.ops.kernels import InsStats
from cnsn_tpu_torch.ops.stats import masked_instance_mean_std, region_mask
from test_torch_threads import one_thread  # noqa: F401 (autouse)


DRAWS = 4000
SHAPE = (4, 9, 11, 6)  # N, H, W, C: a ragged plane, boxes well inside it
# JAX's sampler, compiled once per plane: called as it is, it compiles its
# while_loop anew at every call
_JAX_BBOX = jax.jit(jax_bbox.sample_bbox,
                    static_argnames=("h", "w", "beta", "bbx_thres"))


@pytest.fixture(autouse=True)
def _compiled_jax_bbox(monkeypatch):
    """JAX's cross_norm functions draw their boxes through the compiled
    sampler (the same function of the same keys)."""
    monkeypatch.setattr(jax_cn, "sample_bbox", _JAX_BBOX)


@pytest.mark.parametrize("hw,beta", [((32, 32), 1.0), ((224, 224), 1.0),
                                     ((32, 32), 5.0)])
def test_sample_bbox_matches_jax_in_distribution(hw, beta):
    """4,000 boxes from each package (beta 1, the recipes' value, and 5):
    two-sample KS on h1, the height, w1 and the width, p > 1e-3; every
    realised area ratio > 0.1."""
    h, w = hw
    keys = jax.random.split(jax.random.key(11), DRAWS)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jnp.stack(jax_bbox.sample_bbox(k, h, w, beta))))(keys))
    gen = torch.Generator().manual_seed(12)
    got = np.array([sample_bbox(h, w, beta, generator=gen)
                    for _ in range(DRAWS)])
    for name, box in (("port", got), ("jax", want)):
        area = (box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])
        assert (area / (h * w) > 0.1).all(), name
        assert ((box[:, 0] >= 0) & (box[:, 1] <= h) & (box[:, 2] >= 0)
                & (box[:, 3] <= w)).all(), name
    for i, what in ((0, "h1"), (1, "height"), (2, "w1"), (3, "width")):
        g, r = (got[:, i], want[:, i]) if i % 2 == 0 else (
            got[:, i] - got[:, i - 1], want[:, i] - want[:, i - 1])
        p = scipy.stats.ks_2samp(g, r).pvalue
        assert p > 1e-3, (what, p)


def test_sample_bbox_refuses_a_card_generator():
    class _Card:
        device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="CPU generator"):
        sample_bbox(8, 8, generator=_Card())


@pytest.mark.parametrize("box", [(0, 9, 0, 11), (2, 7, 3, 10), (4, 5, 0, 1)])
def test_region_mask_equals_jax(box):
    want = np.asarray(jax_stats.region_mask(9, 11, *box))
    got = region_mask(9, 11, *box).numpy()
    assert got.shape == (1, 9, 11, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert region_mask(9, 11, *box, dtype=torch.bool).dtype == torch.bool


def _x(seed, shape=SHAPE):
    return (np.random.RandomState(seed).randn(*shape) * 1.5 + 0.3).astype(
        np.float32)


@pytest.mark.parametrize("box", [(0, 9, 0, 11), (2, 7, 3, 10), (1, 2, 5, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_instance_mean_std_matches_jax(box, dtype):
    """fp32 out: both sum fp32 in other orders, 1e-5 relative; bf16 out:
    the same fp32 statistics rounded once to bf16, one ulp apart at most.
    A 1×1 box: n − ddof = 0, the variance scaled by n / max(n − 1, 1)."""
    x = _x(3)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    mask = jax_stats.region_mask(9, 11, *box)
    want = jax_stats.masked_instance_mean_std(jx, mask)
    got = masked_instance_mean_std(tx, box)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-6))
    for g, r in zip(got, want):
        assert g.shape == (4, 1, 1, 6) and g.dtype == tx.dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)), **tol)


def _jax_draws(key, x, crop, chan):
    """The draws JAX's cross_norm_2ins / cross_norm_fma take from ``key``,
    as the port's keyword arguments."""
    n, h, w, c = x.shape
    k_perm, k_style, k_content, k_chan = jax.random.split(key, 4)
    d = {"perm": torch.from_numpy(np.array(
        jax_cn.grouped_permutation(k_perm, n, 1)))}
    if crop in ("style", "both"):
        d["style_box"] = tuple(int(v) for v in _JAX_BBOX(k_style, h, w))
    if crop in ("content", "both"):
        d["content_box"] = tuple(int(v) for v in
                                 _JAX_BBOX(k_content, h, w))
    if chan:
        d["chan_perm"] = torch.from_numpy(np.array(
            jax.random.permutation(k_chan, c)))
    return d


def _jax_fn(impl, key, crop, lam, chan, active):
    kw = dict(crop=crop, lam=lam, chan=chan)
    if impl == "fma":
        return lambda x: jax_cn.cross_norm_fma(x, key, jnp.asarray(active),
                                               **kw)
    return lambda x: jax_cn.cross_norm_2ins(x, key, **kw)


def _port_fn(impl, draws, crop, lam, chan, active):
    kw = dict(crop=crop, lam=lam, chan=chan, **draws)
    if impl == "fma":
        return lambda x: cross_norm_fma(x, active, **kw)
    return lambda x: cross_norm_2ins(x, **kw)


# cross_norm_2ins has no gate (JAX's 'cond' site takes the identity branch
# around it); cross_norm_fma folds one in
CASES = [(impl, active) for impl, active in (("2ins", True), ("fma", True),
                                             ("fma", False))]


@pytest.mark.parametrize("impl,active", CASES)
@pytest.mark.parametrize("chan", [False, True])
@pytest.mark.parametrize("lam", [None, 0.3])
@pytest.mark.parametrize("crop", CROP_MODES)
def test_cross_norm_float64_matches_jax_forward_and_vjp(crop, lam, chan,
                                                        impl, active):
    """float64, JAX's draws fed in: the output and the input gradient of
    <out, ct> (JAX's vjp, the port's autograd), each within 1e-10 of its
    scale."""
    x = _x(5).astype(np.float64)
    ct = np.random.RandomState(6).randn(*SHAPE)
    key = jax.random.key(7)
    with jax.enable_x64(True):
        draws = _jax_draws(key, jnp.asarray(x), crop, chan)
        out, vjp = jax.vjp(_jax_fn(impl, key, crop, lam, chan, active),
                           jnp.asarray(x))
        (dx,) = vjp(jnp.asarray(ct))
        want, want_dx = np.asarray(out), np.asarray(dx)
    tx = torch.from_numpy(x).requires_grad_()
    got = _port_fn(impl, draws, crop, lam, chan, active)(tx)
    assert got.dtype == torch.float64
    (got * torch.from_numpy(ct)).sum().backward()
    for g, r in ((got.detach().numpy(), want), (tx.grad.numpy(), want_dx)):
        assert np.abs(g - r).max() <= 1e-10 * np.abs(r).max()
    if not active:
        assert got is tx


@pytest.mark.parametrize("impl,active", CASES)
@pytest.mark.parametrize("chan", [False, True])
@pytest.mark.parametrize("lam", [None, 0.3])
@pytest.mark.parametrize("crop", CROP_MODES)
def test_cross_norm_bf16_matches_jax(crop, lam, chan, impl, active):
    """bf16 in and out, JAX run op by op to round at every bf16 cast as
    the port does: the statistics in bf16, the mix in bf16 (2ins) or one fp32
    FMA (fma); within one bf16 ulp of the output's largest magnitude."""
    x = _x(8)
    key = jax.random.key(9)
    draws = _jax_draws(key, jnp.asarray(x), crop, chan)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    # op by op, so XLA keeps no excess precision between the bf16 ops
    want = np.asarray(_jax_fn(impl, key, crop, lam, chan, active)(xb)
                      .astype(jnp.float32))
    got = _port_fn(impl, draws, crop, lam, chan, active)(
        torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def test_statistics_are_taken_once_and_masked_ones_skip_k1(monkeypatch):
    """K1's Function (on the CPU, its plain version) runs once for the
    unmasked statistics, whichever roles they fill; crop 'both' takes
    none: the masked ones never go through it."""
    x = torch.from_numpy(_x(10))
    perm = torch.tensor([1, 0, 3, 2])
    boxes = dict(style_box=(1, 6, 2, 9), content_box=(0, 5, 0, 5))
    calls = []
    apply = InsStats.apply
    monkeypatch.setattr(InsStats, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    for crop, want in (("neither", 1), ("style", 1), ("content", 1),
                       ("both", 0)):
        calls.clear()
        cross_norm_fma(x, True, crop=crop, perm=perm, **boxes)
        cross_norm_2ins(x, crop=crop, perm=perm, **boxes)
        assert len(calls) == 2 * want, crop


def test_crossnorm_draws_from_a_generator_and_rejects_bad_knobs():
    x = torch.from_numpy(_x(11))
    a = cross_norm_fma(x, True, crop="both", chan=True,
                       generator=torch.Generator().manual_seed(3))
    b = cross_norm_fma(x, True, crop="both", chan=True,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, x)
    with pytest.raises(ValueError, match="crop must be one of"):
        cross_norm_2ins(x, crop="middle")
    with pytest.raises(TypeError):
        cross_norm_fma(x, True, box=(0, 1, 0, 1))
