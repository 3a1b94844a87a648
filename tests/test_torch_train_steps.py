"""Three SGD steps of a reduced-depth ResNet-50+SN (plain, cn_image,
plain) through the port's StepFns against JAX's, in float64, float32
and bf16, and one cn_image step at crop 'both' (split from
tests/test_torch_train.py, whose layer, loss, schedule and recipe
checks stay there, so that the two files balance over the test
workers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.models.resnet import ResNet as JaxResNet
from cnsn_tpu.ops import crossnorm as jax_cn
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import create_train_state as jax_train_state
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws


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


def test_one_cn_image_step_with_crop_both_matches_jax(monkeypatch):
    """resnet50/cn.yaml's image CrossNorm (crop 'both': the style
    statistics inside one box, applied inside another) for one step of
    the reduced ResNet-50+SN in float64: JAX's ``StepFns._cn_image``
    (compiled, its permutation and boxes recorded and fed to the port)
    against ``StepFns.cn_image``: the loss, the state and the momentum
    buffers, at the float64 trajectory's bounds."""
    draws = JaxDraws(monkeypatch)
    rng = np.random.RandomState(2)
    images = rng.randn(BATCH, SIZE, SIZE, 3)
    labels = rng.randint(0, 10, BATCH)
    with jax.enable_x64(True):
        model = JaxResNet(**KW, stem="conv")
        tx = make_sgd(jax_schedules.cosine_lr(*LR), **SGD)
        state = jax_train_state(model, jax.random.key(0),
                                (BATCH, SIZE, SIZE, 3), tx)
        init = (_np_tree(state.params), _np_tree(state.batch_stats))
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     (state.params, state.batch_stats))
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=tx.init(params))
        state, metrics = draws.jit(
            JaxStepFns(model, image_crop="both")._cn_image)(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(3))
        ref = dict(losses=[float(metrics["loss"])],
                   params=_np_tree(state.params),
                   stats=_np_tree(state.batch_stats),
                   trace=_np_tree(_find_trace(state.opt_state)))
    (site,) = draws.sites("both")
    assert set(site) == {"perm", "style_box", "content_box"}

    port = build_model("resnet50", generator=torch.Generator(), **KW)
    port.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(port.double(), cosine_lr(*LR), device="cpu",
                            **SGD)
    ts, got = StepFns(image_crop="both").cn_image(
        ts, torch.from_numpy(images), torch.from_numpy(labels), **site)
    opt = ts.optimizer
    momentum = {name: opt.state[p]["momentum_buffer"]
                for name, p in ts.model.named_parameters()}
    errs = _errors(ref, [float(got["loss"])], ts.model.state_dict(),
                   momentum)
    assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs
