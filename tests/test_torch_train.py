"""The port's training slice against the JAX package, on the CPU: BN and
SelfNorm in train mode, image-space CrossNorm, the losses, schedules and
recipes, and three SGD steps of a reduced-depth ResNet-50+SN.

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
from cnsn_tpu.train.steps import create_train_state as jax_train_state
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.nn import BatchNorm, BatchNorm1dStats, SelfNorm
from cnsn_tpu_torch.ops import (cross_norm_2ins, grouped_permutation,
                                instance_norm_mix)
from cnsn_tpu_torch.train import (StepFns, create_train_state, cosine_lr,
                                  cross_entropy, error_topk, imagenet_step_lr,
                                  jsd_consistency, poly_lr, sample_cn_mask,
                                  softmax_probs, step_lr)
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax

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


def test_cross_norm_modes_not_ported_raise():
    x = torch.randn(2, 4, 4, 3)
    for kw in (dict(crop="style"), dict(crop="content"), dict(crop="both")):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            cross_norm_2ins(x, perm=torch.tensor([1, 0]), **kw)
    with pytest.raises(ValueError, match="crop must be one of"):
        cross_norm_2ins(x, crop="middle")


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


def test_other_regimes_are_not_ported_and_cn_num():
    steps = StepFns()
    for name in ("cn", "cn_consistency", "augmix", "augmix_cn",
                 "cn_image_consist", "cn_image_augmix"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            getattr(steps, name)(None, None, None)
    for cnsn_type, want in (("sn", 0), ("cnsn", 4), ("cn", 4), (None, 0)):
        kw = dict(layers=(1, 1, 1, 1), pos="post", cnsn_type=cnsn_type)
        assert build_model("resnet50", 10, **kw).cn_num == want
        assert JaxResNet(num_classes=10, **kw).cn_num == want


# ---- the trajectory: three SGD steps of a reduced-depth ResNet-50+SN ----
#
# Reference: JAX's StepFns run in float64.  This model and batch amplify
# float32 rounding step by step (measured against that float64 run, after
# step 3: JAX's own float32 run is off by 1.7e-3 in a loss, 0.29 of a
# tensor's max-abs in the state and 1.45 in a momentum buffer; the port's
# float32 run by 2.3e-3, 0.11 and 0.69).  So the semantics are held in
# float64, where the two packages agree to 1.4e-12 (losses), 6.0e-8
# (state) and 5.1e-8 (momentum); and the port's float32 run is held to be
# no farther from the float64 trajectory than twice the distance of JAX's
# float32 run.

KW = dict(layers=(1, 1, 1, 1), num_classes=10, pos="post", cnsn_type="sn",
          crop="neither", beta=1.0)
BATCH, SIZE = 4, 64  # 64² leaves layer4 at 2x2 (32² would leave it at 1x1)
KINDS = ("plain", "cn_image", "plain")
SGD = dict(momentum=0.9, weight_decay=1e-4, nesterov=False)
LR = (0.05, 4)  # cosine from 0.05 over 4 updates: each step's lr differs


def _find_trace(opt_state):
    """optax's momentum tree in a chained optimizer state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _find_trace(s)
            if found is not None:
                return found
    return None


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def _jax_run(dtype, kinds, rng):
    """JAX's StepFns over ``kinds`` from a fresh init; dtype float64 (all
    of it, under x64) or bfloat16 (compute; params fp32)."""
    images = rng.randn(len(kinds), BATCH, SIZE, SIZE, 3).astype(np.float32)
    labels = rng.randint(0, 10, (len(kinds), BATCH))
    bf16 = dtype == jnp.bfloat16
    model = JaxResNet(**KW, dtype=dtype if bf16 else None, stem="conv")
    tx = make_sgd(jax_schedules.cosine_lr(*LR), **SGD)
    state = jax_train_state(model, jax.random.key(0),
                            (BATCH, SIZE, SIZE, 3), tx)
    init = (_np_tree(state.params), _np_tree(state.batch_stats))
    if not bf16:
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, dtype), (
            state.params, state.batch_stats))
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=tx.init(params))
    steps = JaxStepFns(model)
    losses, perms = [], []
    for i, kind in enumerate(kinds):
        key = jax.random.key(100 + i)
        images_i = jnp.asarray(images[i], None if bf16 else dtype)
        args = (state, images_i, jnp.asarray(labels[i]), key)
        fn = getattr(steps, kind)
        if bf16:  # round at every bf16 cast, as the port does
            fn = fn.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        state, metrics = fn(*args)
        losses.append(float(metrics["loss"]))
        k_cn = jax.random.split(key)[0]
        perms.append(np.array(jax_cn.grouped_permutation(
            jax.random.split(k_cn, 4)[0], BATCH, 1)))
    return dict(images=images, labels=labels, init=init, losses=losses,
                perms=perms, params=_np_tree(state.params),
                stats=_np_tree(state.batch_stats),
                trace=_np_tree(_find_trace(state.opt_state)))


def _port_run(ref, dtype, kinds):
    """The port's StepFns over ``kinds`` from JAX's init: dtype float64
    (the whole model), float32, or bfloat16 (compute; params fp32)."""
    bf16 = dtype == torch.bfloat16
    model = build_model("resnet50", generator=torch.Generator(),
                        dtype=dtype if bf16 else None, **KW)
    model.load_state_dict(state_dict_from_jax(*ref["init"]), strict=True)
    data_dtype = torch.float32 if bf16 else dtype
    state = create_train_state(model.to(data_dtype), cosine_lr(*LR),
                               device="cpu", **SGD)
    steps = StepFns()
    losses = []
    for i, kind in enumerate(kinds):
        images = torch.from_numpy(ref["images"][i]).to(data_dtype)
        labels = torch.from_numpy(ref["labels"][i])
        if kind == "plain":
            state, metrics = steps.plain(state, images, labels)
        else:
            state, metrics = steps.cn_image(
                state, images, labels, perm=torch.from_numpy(ref["perms"][i]))
        losses.append(float(metrics["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def jax_trajectories():
    with jax.enable_x64(True):
        f64 = _jax_run(jnp.float64, KINDS, np.random.RandomState(0))
    return f64, _jax_run(jnp.float32, KINDS, np.random.RandomState(0))


def _worst(got, want):
    """Largest |got − want| of each tensor over that tensor's max-abs."""
    return max(float((got[k].double() - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def _errors(ref, losses, state, momentum):
    """(worst relative loss error, worst state error, worst momentum
    error) of a run against the reference run ``ref``."""
    loss_err = float(np.max(np.abs(np.array(losses) - ref["losses"])
                            / np.abs(ref["losses"])))
    want = state_dict_from_jax(ref["params"], ref["stats"])
    want_m = state_dict_from_jax(ref["trace"], {})
    assert set(state) == set(want) and set(momentum) == set(want_m)
    return loss_err, _worst(state, want), _worst(momentum, want_m)


def _port_errors(ref, dtype):
    state, losses = _port_run(ref, dtype, KINDS)
    assert state.step == 3
    opt = state.optimizer
    momentum = {name: opt.state[p]["momentum_buffer"]
                for name, p in state.model.named_parameters()}
    return _errors(ref, losses, state.model.state_dict(), momentum)


def test_three_sgd_steps_match_jax(jax_trajectories):
    """plain, cn_image (JAX's permutation fed in), plain: each step's loss,
    and after step 3 every parameter and running statistic and every
    momentum buffer, each over its tensor's max-abs, in float64."""
    f64, _ = jax_trajectories
    errs = _port_errors(f64, torch.float64)
    assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs


def test_three_sgd_steps_f32_no_farther_than_jax_f32(jax_trajectories):
    """The same three steps in float32: the port's run lies no farther
    from the float64 trajectory than twice JAX's float32 run does."""
    f64, f32 = jax_trajectories
    jax_errs = _errors(f64, f32["losses"],
                       {k: v.double() for k, v in state_dict_from_jax(
                           f32["params"], f32["stats"]).items()},
                       state_dict_from_jax(f32["trace"], {}))
    errs = _port_errors(f64, torch.float32)
    assert all(e <= 2 * j for e, j in zip(errs, jax_errs)), (errs, jax_errs)


def test_one_bf16_step_matches_jax_loss_and_gradients_are_finite():
    """bf16 compute (fp32 params): the loss within a gross-fault bound of
    JAX's (two bf16 forwards part by bf16 roundings), every gradient
    finite, every parameter still fp32."""
    ref = _jax_run(jnp.bfloat16, ("plain",), np.random.RandomState(1))
    state, losses = _port_run(ref, torch.bfloat16, ("plain",))
    np.testing.assert_allclose(losses, ref["losses"], rtol=2e-2)
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name
