"""The port's training slice against the JAX package, on the CPU: BN and
SelfNorm in train mode, image-space CrossNorm, the losses, schedules and
recipes (three SGD steps of a reduced-depth ResNet-50+SN are
tests/test_torch_train_steps.py's).

Inputs and weights are numpy draws (or a JAX initialisation carried over
with ``state_dict_from_jax``) handed to both packages.  Random draws of
the JAX side (CrossNorm's permutation) are fed to the port.  Where the
JAX code reaches a Pallas kernel it does not here: its train path takes
the plain jnp statistics by default, which is what the port's K1 and K2
kernels compute (held to their Pallas kernels in
tests/test_torch_ins_stats.py and tests/test_torch_bn_stats.py).
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.config import load_config as jax_load_config
from cnsn_tpu.models.resnet import ResNet as JaxResNet
from cnsn_tpu.nn.cnsn import SelfNorm as JaxSelfNorm
from cnsn_tpu.nn.norm import BatchNorm as JaxBatchNorm
from cnsn_tpu.nn.norm import BatchNorm1dStats as JaxBatchNorm1dStats
from cnsn_tpu.ops import crossnorm as jax_cn
from cnsn_tpu.train import losses as jax_losses
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.nn import BatchNorm, BatchNorm1dStats, SelfNorm
from cnsn_tpu_torch.ops import (cross_norm_2ins, grouped_permutation,
                                instance_norm_mix)
from cnsn_tpu_torch.train import (StepFns, cosine_lr, cross_entropy,
                                  error_topk, imagenet_step_lr,
                                  jsd_consistency, poly_lr, sample_cn_mask,
                                  softmax_probs, step_lr)
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_threads import one_thread  # noqa: F401 (autouse)


F32_TOL = dict(rtol=1e-5, atol=1e-5)
_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cnsn_tpu", "configs")


def _np(t):
    return t.detach().float().numpy()


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return _np(t.permute(0, 2, 3, 1))


def _rand_tree(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _rand_tree(dict(v), rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = (rng.randn(*np.shape(v)) * 0.3).astype(np.float32)
    return out


def _layer(jax_module, port_module, x, warm, seed):
    """Init the JAX layer, give it random params (and a warm or cold
    running mean), load the same into the port; return the variables."""
    rng = np.random.RandomState(seed)
    v = jax_module.init(jax.random.key(0), jnp.asarray(x), False)
    params = _rand_tree(dict(v["params"]), rng)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         dict(v["batch_stats"]))
    if warm:
        stats = _rand_tree(stats, rng)
    port_module.load_state_dict(state_dict_from_jax(params, stats),
                                strict=True)
    return {"params": params, "batch_stats": stats}


def _jax_train_vjp(module, variables, x, ct):
    """JAX train-mode forward: output, new batch stats, and the gradients
    of <out, ct> for the input and the params."""
    def f(xx, params):
        out, mut = module.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                xx, False, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    out, vjp, stats = jax.vjp(f, jnp.asarray(x), variables["params"],
                              has_aux=True)
    dx, dparams = vjp(jnp.asarray(ct))
    return out, stats, dx, dparams


@pytest.mark.parametrize("warm", [False, True])
def test_batchnorm_train_matches_jax(warm):
    """Output, input and affine gradients, and the running-statistic
    update, from a cold (zero) and a warm running mean (the shift)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 6, 5, 24) * 2 + 0.7).astype(np.float32)
    ct = rng.randn(*x.shape).astype(np.float32)
    jm, tm = JaxBatchNorm(24), BatchNorm(24)
    v = _layer(jm, tm, x, warm, seed=2)
    out, stats, dx, dparams = _jax_train_vjp(jm, v, x, ct)

    tx = _nchw(x).requires_grad_()
    got = tm.train()(tx)
    assert got.is_contiguous(memory_format=torch.channels_last)
    (got * _nchw(ct)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(out), **F32_TOL)
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(dx), **F32_TOL)
    np.testing.assert_allclose(_np(tm.weight.grad),
                               np.asarray(dparams["scale"]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(_np(tm.bias.grad),
                               np.asarray(dparams["bias"]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(_np(tm.running_mean),
                               np.asarray(stats["mean"]), **F32_TOL)
    np.testing.assert_allclose(_np(tm.running_var),
                               np.asarray(stats["var"]), **F32_TOL)


def test_batchnorm1d_stats_train_matches_jax():
    rng = np.random.RandomState(3)
    y = (rng.randn(6, 16) * 0.2 + 1.3).astype(np.float32)
    ct = rng.randn(6, 16).astype(np.float32)
    jm, tm = JaxBatchNorm1dStats(16), BatchNorm1dStats(16)
    v = _layer(jm, tm, y, True, seed=4)
    out, stats, dy, dparams = _jax_train_vjp(jm, v, y, ct)
    ty = torch.from_numpy(y).requires_grad_()
    got = tm.train()(ty)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(out), **F32_TOL)
    np.testing.assert_allclose(_np(ty.grad), np.asarray(dy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(tm.weight.grad),
                               np.asarray(dparams["scale"]), **F32_TOL)
    np.testing.assert_allclose(_np(tm.running_mean),
                               np.asarray(stats["mean"]), **F32_TOL)
    np.testing.assert_allclose(_np(tm.running_var),
                               np.asarray(stats["var"]), **F32_TOL)


@pytest.mark.parametrize("shape", [(3, 7, 7, 256), (4, 5, 3, 40)])
def test_selfnorm_train_matches_jax(shape):
    """Forward, input gradient and every parameter's gradient (g_fc, g_bn),
    and g_bn's running statistics."""
    c = shape[-1]
    rng = np.random.RandomState(c)
    x = (rng.randn(*shape) * 1.5 + 0.5).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    jm, tm = JaxSelfNorm(c), SelfNorm(c)
    v = _layer(jm, tm, x, True, seed=c + 1)
    out, stats, dx, dparams = _jax_train_vjp(jm, v, x, ct)

    tx = _nchw(x).requires_grad_()
    got = tm.train()(tx)
    (got * _nchw(ct)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(out), **F32_TOL)
    # the input gradient adds a direct path and a statistics path that
    # cancel in part, so it is held to 1e-4 of its scale
    want_dx = np.asarray(dx)
    np.testing.assert_allclose(_nhwc(tx.grad), want_dx, rtol=1e-4,
                               atol=1e-4 * np.abs(want_dx).max())
    np.testing.assert_allclose(_np(tm.g_fc.weight.grad).reshape(c, 2),
                               np.asarray(dparams["g_fc"]), rtol=1e-4,
                               atol=1e-4)
    for name, key in (("weight", "scale"), ("bias", "bias")):
        np.testing.assert_allclose(_np(getattr(tm.g_bn, name).grad),
                                   np.asarray(dparams["g_bn"][key]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tm.g_bn.running_var),
                               np.asarray(stats["g_bn"]["var"]), **F32_TOL)


def test_selfnorm_train_bf16_rounds_where_jax_does():
    """bf16: statistics cast to bf16 before the fp32 FC, the gate cast to
    bf16, x·g taken in bf16; equal to JAX up to one bf16 ulp."""
    shape = (2, 7, 7, 128)
    rng = np.random.RandomState(5)
    x = (rng.randn(*shape) * 1.5 + 0.5).astype(np.float32)
    jm, tm = JaxSelfNorm(128), SelfNorm(128)
    v = _layer(jm, tm, x, True, seed=6)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    fn = jax.jit(lambda xx: jm.apply(v, xx, False, mutable=["batch_stats"])[0])
    want = fn.lower(xb).compile(
        compiler_options={"xla_allow_excess_precision": False})(xb)
    got = tm.train()(_nchw(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("num_groups,lam", [(1, None), (2, None), (1, 0.3)])
def test_cross_norm_2ins_with_jax_permutation(num_groups, lam):
    """The port fed the permutation that JAX's cross_norm_2ins drew from
    its key (ops/crossnorm.py:87-89) gives JAX's output, a per-shard
    (num_groups=2) pairing included."""
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 9, 11, 3) * 1.2 + 0.3).astype(np.float32)
    key = jax.random.key(8)
    want = jax_cn.cross_norm_2ins(jnp.asarray(x), key, lam=lam,
                                  num_groups=num_groups)
    perm = jax_cn.grouped_permutation(jax.random.split(key, 4)[0], 4,
                                      num_groups)
    got = cross_norm_2ins(torch.from_numpy(x),
                          perm=torch.from_numpy(np.array(perm)), lam=lam)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def test_instance_norm_mix_matches_jax():
    rng = np.random.RandomState(9)
    content = rng.randn(2, 5, 6, 8).astype(np.float32)
    style = (rng.randn(2, 3, 4, 8) * 2 + 1).astype(np.float32)
    want = jax_cn.instance_norm_mix(jnp.asarray(content), jnp.asarray(style))
    got = instance_norm_mix(torch.from_numpy(content),
                            torch.from_numpy(style))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def test_port_samplers_draw_valid_permutations_and_masks():
    gen = torch.Generator().manual_seed(0)
    perm = grouped_permutation(8, 2, gen)
    assert sorted(perm[:4].tolist()) == [0, 1, 2, 3]
    assert sorted(perm[4:].tolist()) == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="divisible"):
        grouped_permutation(6, 4, gen)
    mask = sample_cn_mask(16, 3, generator=gen)
    assert mask.dtype == torch.bool and int(mask.sum()) == 3
    fixed = sample_cn_mask(4, 2, perm=torch.tensor([3, 1, 0, 2]))
    assert fixed.tolist() == [False, True, False, True]


def test_cross_norm_modes_not_ported_raise(monkeypatch):
    """The crop modes 'style', 'content' and 'both' of image CrossNorm
    (C=3 planes): the port fed the permutation and boxes JAX drew gives
    JAX's output; an unknown crop raises."""
    draws = JaxDraws(monkeypatch)
    x = (np.random.RandomState(12).randn(4, 20, 17, 3) * 1.2 + 0.3).astype(
        np.float32)
    for crop in ("style", "content", "both"):
        draws.clear()
        want = jax_cn.cross_norm_2ins(jnp.asarray(x), jax.random.key(13),
                                      crop=crop)
        (site,) = draws.sites(crop)
        got = cross_norm_2ins(torch.from_numpy(x), crop=crop, **site)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    with pytest.raises(ValueError, match="crop must be one of"):
        cross_norm_2ins(torch.from_numpy(x), crop="middle")


def test_losses_match_jax():
    rng = np.random.RandomState(10)
    logits = [(rng.randn(6, 10) * 3).astype(np.float32) for _ in range(3)]
    logits[0][0, 4] = logits[0][0, 7] = 50.0  # a tie: the lower index wins
    labels = np.array([7, 1, 2, 3, 4, 5])
    jl = [jnp.asarray(z) for z in logits]
    tl = [torch.from_numpy(z) for z in logits]
    jy, ty = jnp.asarray(labels), torch.from_numpy(labels)
    np.testing.assert_allclose(
        float(cross_entropy(tl[0], ty)),
        float(jax_losses.cross_entropy(jl[0], jy)), rtol=1e-6)
    jp = [jax_losses.softmax_probs(z) for z in jl]
    tp = [softmax_probs(z) for z in tl]
    np.testing.assert_allclose(_np(tp[1]), np.asarray(jp[1]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(jsd_consistency(*tp)),
                               float(jax_losses.jsd_consistency(*jp)),
                               rtol=1e-5)
    for k in (1, 3):
        assert float(error_topk(tl[0], ty, k)) == float(
            jax_losses.error_topk(jl[0], jy, k))
    # bf16 logits: the loss is taken in fp32, as JAX promotes them
    bl = tl[2].bfloat16()
    assert cross_entropy(bl, ty).dtype == torch.float32
    np.testing.assert_allclose(
        float(cross_entropy(bl, ty)),
        float(jax_losses.cross_entropy(jl[2].astype(jnp.bfloat16), jy)),
        rtol=1e-6)


def test_schedules_match_jax():
    cases = [
        (cosine_lr(0.1, 4000), jax_schedules.cosine_lr(0.1, 4000)),
        (imagenet_step_lr(0.1, 90, 128, 50),
         jax_schedules.imagenet_step_lr(0.1, 90, 128, 50)),
        (poly_lr(0.01, 4000), jax_schedules.poly_lr(0.01, 4000)),
        (step_lr(0.01, 3, 20), jax_schedules.step_lr(0.01, 3, 20)),
    ]
    for port, jax_fn in cases:
        for s in (0, 1, 49, 50, 333, 1499, 1500, 3000, 3999):
            assert isinstance(port(s), float)
            # JAX computes in fp32: near the cosine's floor 1 + cos(·)
            # cancels, so the bound has an fp32-rounding floor of the base
            np.testing.assert_allclose(port(s), float(jax_fn(s)), rtol=1e-6,
                                       atol=1e-7 * port(0))


def test_recipes_resolve_as_jax_does():
    """Every classification recipe's regime (``regime: auto`` included)
    and training fields equal the JAX loader's: cnsn.yaml trains
    cn_image, sn.yaml plain.  (The segmentation recipes have a loader of
    their own in the JAX package.)"""
    paths = sorted(p for d in ("cifar10", "cifar100", "imagenet")
                   for p in glob.glob(os.path.join(_CONFIGS, d, "**",
                                                   "*.yaml"), recursive=True))
    assert len(paths) > 40
    fields = ("regime", "exp_id", "seed", "batch_size", "lr", "momentum",
              "weight_decay", "nesterov", "epochs", "schedule", "cn_prob")
    for p in paths:
        port, ref = load_config(p), jax_load_config(p)
        assert ({f: getattr(port, f) for f in fields}
                == {f: getattr(ref, f) for f in fields}), p
    imagenet = os.path.join(_CONFIGS, "imagenet", "resnet50")
    assert load_config(os.path.join(imagenet, "cnsn.yaml")).regime == \
        "cn_image"
    assert load_config(os.path.join(imagenet, "sn.yaml")).regime == "plain"


def test_the_cn_recipes_resolve_as_jax_does():
    """The recipes this slice trains: WRN-40-2 cn.yaml and cnsn.yaml train
    the cn regime (2 sites on per step), ImageNet resnet50/cn.yaml
    cn_image with crop 'both' on a plain ResNet-50; every recipe's
    CrossNorm knobs equal the JAX loader's."""
    wrn = os.path.join(_CONFIGS, "cifar10", "wideresnet")
    want = {os.path.join(wrn, "cn.yaml"): ("cn", "cn", "neither", 2, 0.5),
            os.path.join(wrn, "cnsn.yaml"): ("cn", "cnsn", "both", 2, 0.25),
            os.path.join(_CONFIGS, "imagenet", "resnet50", "cn.yaml"): (
                "cn_image", None, "both", None, 0.5)}
    for path, (regime, cnsn_type, crop, active_num, cn_prob) in want.items():
        cfg = load_config(path)
        assert (cfg.regime, cfg.cnsn_type, cfg.crop, cfg.active_num,
                cfg.cn_prob, cfg.beta) == (regime, cnsn_type, crop,
                                           active_num, cn_prob, 1), path
    fields = ("cnsn_type", "pos", "crop", "beta", "active_num", "cn_prob")
    for p in sorted(p for d in ("cifar10", "cifar100", "imagenet")
                    for p in glob.glob(os.path.join(_CONFIGS, d, "**",
                                                    "*.yaml"), recursive=True)):
        port, ref = load_config(p), jax_load_config(p)
        assert ({f: getattr(port, f) for f in fields}
                == {f: getattr(ref, f) for f in fields}), p


def test_other_regimes_are_not_ported_and_cn_num():
    """The three AugMix regimes, the last JAX regimes to port, are the
    port's own step methods now (their parity with JAX:
    test_torch_augmix_steps.py) with JAX's AugMix JSD weight, 12; cn_num
    is one site per bottleneck where cnsn_type has CrossNorm, as in JAX."""
    steps = StepFns()
    for name in ("augmix", "augmix_cn", "cn_image_augmix"):
        assert getattr(StepFns, name).__qualname__ == f"StepFns.{name}"
    assert steps.jsd_wt == JaxStepFns(JaxResNet(num_classes=10)).jsd_wt == 12
    for cnsn_type, want in (("sn", 0), ("cnsn", 4), ("cn", 4), (None, 0)):
        kw = dict(layers=(1, 1, 1, 1), pos="post", cnsn_type=cnsn_type)
        assert build_model("resnet50", 10, **kw).cn_num == want
        assert JaxResNet(num_classes=10, **kw).cn_num == want
