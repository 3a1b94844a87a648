"""Port WideResNet (cnsn_tpu_torch.models.wideresnet) against the JAX
WideResNet on the CPU: the eval forward at every CNSN position, the
weight carry-over both ways, and one SGD step of the CIFAR SelfNorm
recipe (``cnsn_tpu/configs/cifar10/wideresnet/sn.yaml``) under
CNSN_CONV3X3=conv and =pallas.

A JAX WideResNet is initialised at reduced depth (16: both the unequal
first block and an equal block in each group) and width 2, its BN affine
and running statistics made random, and its trees carried into the port
with ``state_dict_from_jax``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import create_train_state as jax_train_state
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax

DEPTH, WIDEN = 16, 2
RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "cifar10", "wideresnet", "sn.yaml")
STEPS_PER_EPOCH = 390  # JAX's CIFAR-10 train loader: 50,000 // 128, drop_last


def _perturb(tree, rng, stats):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturb(dict(v), rng, stats)
            continue
        v = np.asarray(v, np.float32)
        if stats and k == "var":
            v = rng.uniform(0.5, 2.0, v.shape)
        elif stats:
            v = rng.randn(*v.shape) * 0.1
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k == "bias":
            v = rng.randn(*v.shape) * 0.1
        out[k] = np.asarray(v, np.float32)
    return out


def _same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if hasattr(a[k], "items"):
            _same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("pos", ["pre", "post", "residual", "identity"])
def test_eval_logits_match_jax(pos):
    """Eval logits at 16² in fp32; then the port's state_dict converts back
    into the JAX tree exactly, with no key missing."""
    rng = np.random.RandomState(0)
    kw = dict(depth=DEPTH, widen_factor=WIDEN, num_classes=10, pos=pos,
              cnsn_type="sn")
    jm = JaxWideResNet(**kw)
    x = rng.randn(4, 16, 16, 3).astype(np.float32)
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), False, None)
    params = _perturb(dict(v["params"]), rng, stats=False)
    stats = _perturb(dict(v["batch_stats"]), rng, stats=True)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), False, None))

    tm = WideResNet(**kw)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 10)
    # fp32 through 13 convs whose algorithms sum in other orders in the
    # two frameworks (~1e-6 relative per layer): 1e-4 of the logit scale
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())

    zeros = jax.tree.map(np.zeros_like, (params, stats))
    p2, s2, missing = convert_state_dict(tm.state_dict(), *zeros,
                                         strict=True)
    assert missing == []
    _same_tree(p2, params)
    _same_tree(s2, stats)


def test_wrn40_2_state_dict_keys_and_shapes_match_jax():
    """build_model('wideresnet') is WRN-40-2: the JAX tree (shapes only)
    carries over to exactly its state_dict keys and shapes, and its 18
    SelfNorm sites and 37 BatchNorms are all there."""
    jm = JaxWideResNet(depth=40, widen_factor=2, num_classes=10, pos="pre",
                       cnsn_type="sn")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), False,
        None))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         (dict(shapes["params"]),
                          dict(shapes["batch_stats"])))
    port = build_model("wideresnet", 10, pos="pre", cnsn_type="sn")
    port_sd = port.state_dict()
    assert ({k: tuple(t.shape) for k, t in state_dict_from_jax(*zeros).items()}
            == {k: tuple(t.shape) for k, t in port_sd.items()})
    assert sum(k.endswith("g_fc.weight") for k in port_sd) == 18
    assert sum(k.endswith("bn1.running_var") or k.endswith("bn2.running_var")
               for k in port_sd) == 37
    _, _, missing = convert_state_dict(port_sd, *zeros, strict=True)
    assert missing == []


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


def _np64(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def _worst(got, want):
    """Largest |got − want| of each tensor over that tensor's max-abs."""
    return max(float((got[k].double() - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


@pytest.mark.parametrize("mode", ["conv", "pallas"])
def test_one_sgd_step_of_the_sn_recipe_matches_jax(mode, monkeypatch):
    """sn.yaml (pos 'pre', SelfNorm, nesterov SGD, wd 5e-4, cosine LR over
    100 epochs of 390 steps) for one plain step, both packages in float64
    from the same initial weights: the loss, every parameter and running
    statistic after the step, and every momentum buffer.

    Under 'conv' both take their library's conv gradients in float64.
    Under 'pallas' both compute the stride-1 3x3 weight gradients in fp32
    (the Pallas kernel casts to fp32, ``conv_wgrad.py:76-77``, and so does
    the port's plain K4), summing in other orders: those gradients, and
    with them the momentum buffers, agree to fp32 rounding (1e-5 of each
    tensor's max-abs), the parameters to ~lr times that."""
    monkeypatch.setenv("CNSN_CONV3X3", mode)
    cfg = load_config(RECIPE)
    assert (cfg.regime, cfg.pos, cfg.cnsn_type, cfg.nesterov) == \
        ("plain", "pre", "sn", True)
    sgd = dict(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
               nesterov=cfg.nesterov)
    total = cfg.epochs * STEPS_PER_EPOCH
    kw = dict(depth=DEPTH, widen_factor=WIDEN, num_classes=cfg.num_classes,
              pos=cfg.pos, cnsn_type=cfg.cnsn_type)
    rng = np.random.RandomState(3)
    images = rng.randn(4, 16, 16, 3)
    labels = rng.randint(0, 10, 4)

    with jax.enable_x64(True):
        model = JaxWideResNet(**kw)
        tx = make_sgd(jax_schedules.cosine_lr(cfg.lr, total), **sgd)
        state = jax_train_state(model, jax.random.key(0), (4, 16, 16, 3), tx)
        init = (_np64(state.params), _np64(state.batch_stats))
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     (state.params, state.batch_stats))
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=tx.init(params))
        state, metrics = JaxStepFns(model).plain(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(1))
        want_loss = float(metrics["loss"])
        want = state_dict_from_jax(_np64(state.params),
                                   _np64(state.batch_stats))
        want_m = state_dict_from_jax(_np64(_find_trace(state.opt_state)), {})

    tm = WideResNet(**kw)
    tm.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(tm.double(), cosine_lr(cfg.lr, total),
                            device="cpu", **sgd)
    ts, got = StepFns().plain(ts, torch.from_numpy(images),
                              torch.from_numpy(labels))
    opt = ts.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in ts.model.named_parameters()}
    errs = (abs(float(got["loss"]) - want_loss) / abs(want_loss),
            _worst(ts.model.state_dict(), want), _worst(momentum, want_m))
    bounds = (1e-10, 1e-6, 1e-6) if mode == "conv" else (1e-10, 1e-6, 1e-5)
    assert all(e <= b for e, b in zip(errs, bounds)), errs


@pytest.mark.parametrize("cnsn_type,want", [("sn", 0), ("cn", 6),
                                            ("cnsn", 6)])
def test_cn_num_matches_jax_and_an_active_site_raises(cnsn_type, want):
    """One CrossNorm site per block where cnsn_type has CrossNorm
    (``wideresnet.py:89-92``); an active in-network site is not ported
    and raises, as on ResNet."""
    kw = dict(depth=DEPTH, widen_factor=WIDEN, pos="post",
              cnsn_type=cnsn_type)
    model = WideResNet(**kw)
    assert model.cn_num == JaxWideResNet(**kw).cn_num == want
    if want:
        active = torch.zeros(want, dtype=torch.bool)
        active[2] = True
        with pytest.raises(NotImplementedError, match="not ported yet"):
            model.train()(torch.randn(2, 16, 16, 3), active)
