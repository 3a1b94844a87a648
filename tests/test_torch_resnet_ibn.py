"""ResNet-50-IBN of the port (``models/resnet_ibn.py``, ``nn/norm.py``'s
``InstanceNorm`` and ``IBN``) against the JAX package's on the CPU.

The layers: forward and gradient within 1e-6 in float32 and to rounding
in float64, IBN's channel split checked half by half.  The models, IBN-a
here and IBN-b in test_torch_resnet_ibn_b.py, at layers (1, 1, 1, 1) and
64² (layer4 at 2²), SelfNorm at every pos: the port's weights carried
into JAX's tree (``convert_state_dict``, strict), eval logits of float64
models within 1e-6 (the port's eval SelfNorm computes x·g in fp32, as
the Pallas kernel does: ``ops/kernels/selfnorm.py``), one plain SGD step of the IBN-b recipe's optimizer in float64 against
JAX's ``StepFns`` (loss within 1e-10, every parameter, running statistic
and momentum buffer within 1e-6 of its tensor's max-abs), and JAX's
trees carried back (``state_dict_from_jax``, strict).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.models.resnet_ibn import ResNetIBN as JaxResNetIBN
from cnsn_tpu.nn.norm import IBN as JaxIBN
from cnsn_tpu.nn.norm import InstanceNorm as JaxInstanceNorm
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.nn import IBN, BatchNorm, InstanceNorm
from cnsn_tpu_torch.train import StepFns, create_train_state
from cnsn_tpu_torch.train.schedules import imagenet_step_lr
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_consistency import _jax_state
from test_torch_wideresnet import _find_trace, _np64

IBN_B = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "imagenet", "resnet50_ibn_b",
    "cnsn-augmix.yaml")
LAYERS = (1, 1, 1, 1)
IMAGE = 64
POSITIONS = ("residual", "pre", "post", "identity")
BOUNDS = (1e-10, 1e-6, 1e-6)
LOGIT_BOUND = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, torch's default
    pool (a thread a core in each worker) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worst(got, want):
    """Largest |got − want| of each tensor over that tensor's max-abs, or
    over 1e-9 where that is smaller: a BatchNorm bias whose output an
    InstanceNorm follows (IBN-b's bn3 and downsample before the post-add
    IN) has a zero gradient, and after a step it holds float64 rounding
    alone (~1e-18)."""
    return max(float((got[k].double() - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-9) for k in want)


def _grads_by_name(tree, prefix=""):
    """JAX's gradient tree in the port's parameter names, unrounded."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_grads_by_name(dict(v), f"{prefix}{k}."))
        else:
            out[prefix + {"scale": "weight"}.get(k, k)] = np.asarray(v)
    return out


def _nchw(x):
    """An NHWC array as the port's NCHW channels_last view."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _layer_vjp(jax_module, variables, x, g, train):
    """JAX's output, and the gradients of <out, g> in x and the params."""
    def f(params, x):
        out = jax_module.apply({**variables, "params": params}, x,
                               *([] if train is None else [not train]),
                               mutable=["batch_stats"])
        return out[0]
    out, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(gx), jax.tree.map(np.asarray, gp)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("kind", ["in", "ibn"])
def test_layer_forward_and_gradient_match_jax(kind, dtype, tol):
    """InstanceNorm (biased variance over H·W, no running statistics)
    and IBN in train mode (C=12: IN on channels 0–5, BN on 6–11): the
    output, the input's and the parameters' gradients, relative to each
    tensor's max-abs; IBN's running statistics after the step."""
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 5, 7, 12) * 2 + 0.5).astype(dtype)
    g = rng.randn(3, 5, 7, 12).astype(dtype)
    if kind == "in":
        jax_mod, port, train = JaxInstanceNorm(12), InstanceNorm(12), None
        v = jax_mod.init(jax.random.key(0), jnp.asarray(x))
    else:
        jax_mod, port, train = JaxIBN(12), IBN(12), True
        v = jax_mod.init(jax.random.key(0), jnp.asarray(x), False)
    # float32 values, which the port's state dict carries unrounded
    params, stats = (jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
        dict(t)) for t in (v["params"], v.get("batch_stats", {})))
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with jax.enable_x64(dtype == np.float64):
        cast = jax.tree.map(lambda a: jnp.asarray(a, dtype), (params, stats))
        out, gx, gp = _layer_vjp(jax_mod, {"params": cast[0],
                                           "batch_stats": cast[1]}, x, g,
                                 train)
    port = port.to(torch.float64 if dtype == np.float64 else torch.float32)
    xt = _nchw(x).requires_grad_()
    y = port.train()(xt)
    assert y.dtype == xt.dtype
    (y * _nchw(g)).sum().backward()
    got_out = y.detach().permute(0, 2, 3, 1).numpy()

    def err(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())
    assert err(got_out, out) <= tol
    assert err(xt.grad.permute(0, 2, 3, 1).numpy(), gx) <= tol
    want_grads = _grads_by_name(gp)
    assert set(want_grads) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        assert err(p.grad.numpy(), want_grads[name]) <= tol, name
    if kind == "ibn":
        # the split: channels 0–5 are the InstanceNorm of channels 0–5 alone
        half = InstanceNorm(6).to(port.IN.weight.dtype)
        half.load_state_dict(port.IN.state_dict())
        with torch.no_grad():
            np.testing.assert_array_equal(
                half(_nchw(x)[:, :6]).numpy(), y[:, :6].detach().numpy())
        assert isinstance(port.BN, BatchNorm) and port.BN.features == 6


def test_instance_norm_bf16_keeps_fp32_statistics():
    """A bf16 input: statistics in fp32, the output bf16, equal to the
    fp32 layer's output rounded once."""
    x = torch.randn(2, 4, 6, 6).to(torch.bfloat16)
    m = InstanceNorm(4)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5)
        y = m(x)
        want = m(x.float()).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


def ibn_sgd_case(variant, pos, cnsn_type="sn"):
    """One plain SGD step of the IBN-b recipe's optimizer (imagenet_step
    LR, momentum 0.9, wd 1e-4, no nesterov) on ResNet-50-IBN-``variant``
    at LAYERS and 64², b=4, in float64: JAX's (compiled) after its eval
    logits, from the port model's initial weights carried across; then
    the port's; returns (errors, the port's state, JAX's trees)."""
    cfg = load_config(IBN_B)
    ibn_cfg = {"a": ("a", "a", "a", None), "b": ("b", "b", None, None)}
    kw = dict(layers=LAYERS, ibn_cfg=ibn_cfg[variant], num_classes=10,
              pos=pos, cnsn_type=cnsn_type)
    sgd = dict(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
               nesterov=cfg.nesterov)
    lr = (cfg.lr, cfg.epochs, cfg.batch_size, 5005)
    rng = np.random.RandomState(11)
    images = rng.randn(4, IMAGE, IMAGE, 3)
    labels = rng.randint(0, 10, 4)
    port = build_model(f"resnet50_ibn_{variant}", 10,
                       generator=torch.Generator().manual_seed(2),
                       layers=LAYERS, pos=pos, cnsn_type=cnsn_type)
    with jax.enable_x64(True):
        model = JaxResNetIBN(**kw, stem="conv")
        tx = make_sgd(jax_schedules.imagenet_step_lr(*lr), **sgd)
        state, init = _jax_state(model, port, (4, IMAGE, IMAGE, 3), tx)
        steps = JaxStepFns(model)
        x = jnp.asarray(images)
        want_logits = np.asarray(steps.eval_step(state, x, jnp.asarray(
            labels))["logits"])
        new, metrics = steps.plain(state, x, jnp.asarray(labels),
                                   jax.random.key(0))
        want = (_np64(new.params), _np64(new.batch_stats),
                _np64(_find_trace(new.opt_state)))
        want_loss = float(metrics["loss"])
    port.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(port.double(), imagenet_step_lr(*lr),
                            device="cpu", **sgd)
    x = torch.from_numpy(images)
    got_logits = StepFns().eval_step(ts, x, torch.from_numpy(labels))[
        "logits"].numpy()
    logit_err = float(np.abs(got_logits - want_logits).max()
                      / np.abs(want_logits).max())
    ts, got = StepFns().plain(ts, x, torch.from_numpy(labels))
    opt = ts.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in ts.model.named_parameters()}
    errs = (abs(float(got["loss"]) - want_loss) / abs(want_loss),
            _worst(ts.model.state_dict(), state_dict_from_jax(*want[:2])),
            _worst(momentum, state_dict_from_jax(want[2], {})))
    return logit_err, errs, ts, want


@pytest.mark.parametrize("pos", POSITIONS)
def test_ibn_a_eval_logits_and_sgd_step_match_jax(pos):
    """IBN-a (IBN in bn1 of every block of stages 1–3): eval logits within
    LOGIT_BOUND, one SGD step within BOUNDS; JAX's updated trees load into the
    port model strictly, the IBN's IN and BN halves included."""
    logit_err, errs, ts, want = ibn_sgd_case("a", pos)
    assert logit_err <= LOGIT_BOUND
    assert all(e <= b for e, b in zip(errs, BOUNDS)), errs
    sd = state_dict_from_jax(*want[:2])
    assert {"layer1.0.bn1.IN.weight", "layer1.0.bn1.BN.running_var",
            "layer3.0.bn1.BN.bias", "layer4.0.bn1.running_mean"} <= set(sd)
    assert sd["layer1.0.bn1.IN.weight"].shape == (32,)
    ts.model.load_state_dict(sd, strict=True)
