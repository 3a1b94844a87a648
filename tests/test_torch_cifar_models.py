"""The port's three other CIFAR models (cnsn_tpu_torch.models: allconv,
densenet, resnext) against the JAX package's on the CPU: the eval logits
and the weight carry-over both ways at every CNSN position, AllConvNet's
dropout with JAX's masks,
the conv factory's routing (no grouped or AllConvNet conv ever takes
``ConvCustomBwd``), the full-size state dicts against JAX's, and the
layout the kernels receive.  The checks of a train-mode forward with
CrossNorm sites on and of one ``cn`` SGD step in float64 (JAX's draws fed
to the port) live here and run from one file a model
(``test_torch_allconv.py``, ``test_torch_densenet.py``,
``test_torch_resnext.py``).

Sizes: AllConvNet at its full widths (its 8×8 pool needs 32² input),
DenseNet at depth 7 (one dense layer a block: C = 24, 36, 48, so the
'conv1_pre' sites and the BatchNorms see C ≡ 4 (mod 8) and 'conv1_post'
sites C = 12), ResNeXt at depth 11 (one block a stage, each with a
downsample, so 'identity' shows the reference's quirk), both at 16².
JAX runs compiled (a model's first call op by op would compile each
operation on its own, slower on the CPU); its initial variables are the
port's, carried across by ``convert_state_dict``.  The float64 bounds are ``tests/test_torch_wideresnet.py``'s:
1e-10 of the scale for the loss and logits; 1e-6 of each tensor's
max-abs for the parameters, running statistics and momentum (JAX's trees
come across through ``state_dict_from_jax`` in float32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu_torch.nn.cnsn as port_cnsn
import cnsn_tpu_torch.nn.norm as port_norm
from cnsn_tpu.models.allconv import AllConvNet as JaxAllConvNet
from cnsn_tpu.models.densenet import DenseNet as JaxDenseNet
from cnsn_tpu.models.resnext import CifarResNeXt as JaxResNeXt
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import TrainState as JaxTrainState
from cnsn_tpu.train.steps import make_sgd, sample_cn_mask
from cnsn_tpu.models import build_model as jax_build_model
from cnsn_tpu.utils.torch_import import allconv_key_map as jax_allconv_map
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.allconv import (AllConvNet, Dropout,
                                           allconv_key_map)
from cnsn_tpu_torch.models.common import CONV3X3_MODES, Conv2d, ConvCustomBwd
from cnsn_tpu_torch.models.densenet import DenseNet
from cnsn_tpu_torch.models.resnext import CifarResNeXt
from cnsn_tpu_torch.ops.kernels.conv_wgrad import wgrad3x3_path
from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_wideresnet import _find_trace, _np64, _perturb, _same_tree, \
    _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)


_CIFAR10 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "cifar10")
# model → (JAX class, port class, reduced size, input side)
MODELS = {"allconv": (JaxAllConvNet, AllConvNet, dict(drop_rate=0.0), 32),
          "densenet": (JaxDenseNet, DenseNet, dict(depth=7), 16),
          "resnext": (JaxResNeXt, CifarResNeXt, dict(depth=11), 16)}
CASES = ([("allconv", p) for p in (1, 2, 3)]
         + [("densenet", p) for p in ("conv1_pre", "conv1_post")]
         + [("resnext", p) for p in ("residual", "identity", "pre", "post")])
STEPS_PER_EPOCH = 390


def _knobs(name, pos):
    """The model's cnsn.yaml knobs at ``pos``."""
    cfg = load_config(os.path.join(_CIFAR10, name, "cnsn.yaml"))
    return dict(pos=pos, cnsn_type=cfg.cnsn_type, crop=cfg.crop,
                beta=cfg.beta), cfg


def _key_map(name, pos):
    return allconv_key_map(pos) if name == "allconv" else None


_SHAPES = {}


def _init(jm, pm, hw, km):
    """Initial variables for the JAX model ``jm``: the port model ``pm``'s
    own init carried into JAX's tree by ``convert_state_dict`` (the tree's
    shapes from ``jax.eval_shape``, once per model: JAX's init compiled, or
    run op by op, costs seconds a model on the CPU)."""
    key = (repr(jm), hw)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((2, hw, hw, 3)), False, None))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         (dict(_SHAPES[key]["params"]),
                          dict(_SHAPES[key]["batch_stats"])))
    params, stats, missing = convert_state_dict(pm.state_dict(), *zeros,
                                                strict=True, key_map=km)
    assert missing == []
    return {"params": params, "batch_stats": stats}


def _pair(name, pos, rng, perturb=True):
    """A JAX model at reduced size with random (or initial) variables, and
    the port's model carrying them (through ``state_dict_from_jax``)."""
    jax_cls, port_cls, size, hw = MODELS[name]
    kw, _ = _knobs(name, pos)
    jm = jax_cls(num_classes=10, **size, **kw)
    pm = port_cls(num_classes=10, **size, **kw)
    v = _init(jm, pm, hw, _key_map(name, pos))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    if perturb:
        params = _perturb(params, rng, stats=False)
        stats = _perturb(stats, rng, stats=True)
    params, stats = jax.tree.map(np.asarray, (params, stats))
    pm.load_state_dict(state_dict_from_jax(params, stats,
                                           _key_map(name, pos)), strict=True)
    return jm, pm, params, stats, hw


@pytest.mark.parametrize("name,pos", CASES)
def test_eval_logits_and_weights_both_ways_match_jax(name, pos):
    """Eval logits in fp32 (a random tree carried into the port; its eval
    SelfNorm is K3's plain version, which computes in fp32 as the kernel
    does); the port's state_dict converts back into the JAX tree exactly,
    with no key missing."""
    rng = np.random.RandomState(0)
    jm, pm, params, stats, hw = _pair(name, pos, rng)
    x = rng.randn(4, hw, hw, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False, None))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 10)
    # fp32 convs summing in other orders in the two frameworks, as
    # tests/test_torch_wideresnet.py holds WRN's
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    zeros = jax.tree.map(np.zeros_like, (params, stats))
    p2, s2, missing = convert_state_dict(pm.state_dict(), *zeros,
                                         strict=True,
                                         key_map=_key_map(name, pos))
    assert missing == []
    _same_tree(p2, params)
    _same_tree(s2, stats)


_RUNS = {}


def _jax_cn_step(name, pos, monkeypatch):
    """One compiled JAX program per model and position, run once and shared
    by the two tests below: a ``cn`` SGD step of the model's cnsn.yaml
    (``StepFns._cn``: ``active_num`` sites on, nesterov SGD, its weight
    decay, cosine LR) from a random tree in float64, and beside it the
    train-mode forward that step takes (the same mask and key): its logits
    and running statistics.  The step's mask and each site's draws are
    recorded for the port.  Returns (config, images, labels, initial
    tree, mask, site draws, logits, running statistics, loss, state after,
    momentum after)."""
    if (name, pos) in _RUNS:
        return _RUNS[(name, pos)]
    draws = JaxDraws(monkeypatch)
    kw, cfg = _knobs(name, pos)
    rng = np.random.RandomState(3)
    with jax.enable_x64(True):
        jm, _, params, stats, hw = _pair(name, pos, rng)
        images = rng.randn(4, hw, hw, 3)
        labels = rng.randint(0, 10, 4)
        tx = make_sgd(jax_schedules.cosine_lr(
            cfg.lr, cfg.epochs * STEPS_PER_EPOCH), momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)
        init = _np64({"params": params, "batch_stats": stats})
        state = JaxTrainState.create(apply_fn=jm.apply, tx=tx, **init)
        steps = JaxStepFns(jm, active_num=cfg.active_num)
        key = jax.random.key(1)

        def run(state, images, labels):
            k_mask, k_fwd = jax.random.split(key)
            mask = sample_cn_mask(k_mask, jm.cn_num, cfg.active_num)
            logits, stats = steps._apply(state.params, state.batch_stats,
                                         images, mask, k_fwd)
            return (mask, logits, stats) + steps._cn(state, images, labels,
                                                     key)

        mask, logits, new_stats, new, metrics = draws.jit(run)(
            state, jnp.asarray(images), jnp.asarray(labels))
        km = _key_map(name, pos)
        out = (cfg, images, labels, (params, stats, km),
               np.array(mask).tolist(), draws.sites(kw["crop"])[:jm.cn_num],
               np.asarray(logits),
               state_dict_from_jax(params, _np64(new_stats), km),
               float(metrics["loss"]),
               state_dict_from_jax(_np64(new.params),
                                   _np64(new.batch_stats), km),
               state_dict_from_jax(_np64(_find_trace(new.opt_state)), {}, km))
    assert sum(out[4]) == cfg.active_num and len(out[5]) == jm.cn_num
    _RUNS[(name, pos)] = out
    return out


def _port_model(name, pos, tree):
    params, stats, km = tree
    kw, _ = _knobs(name, pos)
    pm = MODELS[name][1](num_classes=10, **MODELS[name][2], **kw)
    pm.load_state_dict(state_dict_from_jax(params, stats, km), strict=True)
    return pm.double()


def check_train_forward(name, pos, monkeypatch):
    """The train-mode forward of the cnsn.yaml knobs with its CrossNorm
    sites on (JAX's mask and draws), in float64: the logits and every
    running statistic after it (``test_torch_allconv.py``,
    ``test_torch_densenet.py`` and ``test_torch_resnext.py`` run it at
    each position, a file a model, so that the compiles spread over the
    test workers)."""
    _, images, _, tree, mask, sites, want, want_stats, *_ = _jax_cn_step(
        name, pos, monkeypatch)
    pm = _port_model(name, pos, tree)
    got = pm.train()(torch.from_numpy(images), mask, sites)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    sd = pm.state_dict()
    keys = [k for k in want_stats if k.endswith(("running_mean",
                                                 "running_var"))]
    assert keys and _worst({k: sd[k] for k in keys},
                           {k: want_stats[k] for k in keys}) <= 1e-6


def check_sgd_step(name, pos, monkeypatch):
    """One ``cn`` SGD step of the model's cnsn.yaml in float64 from the same
    random tree (AllConvNet's conv biases among it: from their zero init a
    bias before a BatchNorm has only rounding noise for a gradient), JAX's
    mask and draws fed in: the loss, every parameter and running statistic
    after the step, and every momentum buffer.  ResNeXt at 'identity'
    holds the quirk's SelfNorm parameters, which no gradient reaches:
    weight decay still moves them in both packages."""
    (cfg, images, labels, tree, mask, sites, _, _, want_loss, want,
     want_m) = _jax_cn_step(name, pos, monkeypatch)
    ts = create_train_state(
        _port_model(name, pos, tree),
        cosine_lr(cfg.lr, cfg.epochs * STEPS_PER_EPOCH),
        momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        nesterov=cfg.nesterov, device="cpu")
    ts, got = StepFns(active_num=cfg.active_num).cn(
        ts, torch.from_numpy(images), torch.from_numpy(labels), mask=mask,
        draws=sites)
    opt = ts.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in ts.model.named_parameters()}
    errs = (abs(float(got["loss"]) - want_loss) / abs(want_loss),
            _worst(ts.model.state_dict(), want), _worst(momentum, want_m))
    assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs


def test_allconv_dropout_takes_jax_masks(monkeypatch):
    """AllConvNet at the reference's drop_rate 0.5 in train mode: JAX's
    two dropout masks (its Bernoulli draws, returned by the compiled
    forward) given to the port give JAX's logits in float64; without
    masks the port draws its own, keeping about half and scaling by 2."""
    traced = []
    bernoulli = jax.random.bernoulli

    def record(*a, **k):
        out = bernoulli(*a, **k)
        traced.append(out)
        return out

    monkeypatch.setattr(jax.random, "bernoulli", record)
    rng = np.random.RandomState(4)
    kw = dict(pos=1, cnsn_type="sn")
    jm = JaxAllConvNet(num_classes=10, **kw)

    def forward(v, xx):
        traced.clear()
        logits, _ = jm.apply(v, xx, True, None,
                             rngs={"dropout": jax.random.key(5)},
                             mutable=["batch_stats"])
        return logits, list(traced)

    with jax.enable_x64(True):
        v = _init(jm, AllConvNet(num_classes=10, **kw), 32,
                  allconv_key_map(1))
        params = _perturb(dict(v["params"]), rng, stats=False)
        stats = _perturb(dict(v["batch_stats"]), rng, stats=True)
        x = rng.randn(4, 32, 32, 3)
        logits, masks = jax.jit(forward)(
            _np64({"params": params, "batch_stats": stats}), jnp.asarray(x))
        want = np.asarray(logits)
    masks = [torch.from_numpy(np.array(m)) for m in masks]
    assert [tuple(m.shape) for m in masks] == [(4, 16, 16, 96),
                                               (4, 8, 8, 192)]
    pm = AllConvNet(num_classes=10, **kw)
    pm.load_state_dict(state_dict_from_jax(params, stats,
                                           allconv_key_map(1)), strict=True)
    got = pm.double().train()(torch.from_numpy(x), dropout_masks=masks)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    drop = next(m for m in pm.features if isinstance(m, Dropout))
    y = drop(torch.ones(4, 96, 16, 16, dtype=torch.float64))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert abs(float((y > 0).double().mean()) - 0.5) < 0.02
    assert torch.equal(drop.eval()(y), y)


def test_allconv_key_map_is_jaxs():
    for pos in (1, 2, 3):
        assert allconv_key_map(pos) == jax_allconv_map(pos)


@pytest.mark.parametrize("mode", ["conv", *CONV3X3_MODES])
def test_grouped_and_allconv_convs_never_take_custom_gradients(mode,
                                                              monkeypatch):
    """Under every CNSN_CONV3X3: ResNeXt's grouped 3×3 convs stay
    ``Conv2d`` (cuDNN), each weight (O, I/groups, 3, 3); AllConvNet builds
    no ``ConvCustomBwd``; the ungrouped 3×3 convs of ResNeXt (the stem)
    and DenseNet take one exactly when the mode is not 'conv'."""
    monkeypatch.setenv("CNSN_CONV3X3", mode)
    rx = CifarResNeXt(depth=11, num_classes=10)
    grouped = [m for n, m in rx.named_modules() if n.endswith("conv_conv")]
    assert len(grouped) == 3
    for m in grouped:
        assert type(m) is Conv2d and m.groups == 4
        assert m.weight.shape[1] * 4 == m.weight.shape[0]
    custom = mode != "conv"
    assert isinstance(rx.conv_1_3x3, ConvCustomBwd) == custom
    assert not any(isinstance(m, ConvCustomBwd)
                   for m in AllConvNet(num_classes=10).modules())
    dn = DenseNet(depth=7, num_classes=10)
    threes = [m for m in dn.modules()
              if isinstance(m, Conv2d) and m.weight.shape[2] == 3]
    assert len(threes) == 4
    assert all(isinstance(m, ConvCustomBwd) == custom for m in threes)
    x = torch.randn(2, 16, 16, 3)
    logits = rx.train()(x)
    logits.sum().backward()
    assert all(m.weight.grad is not None for m in grouped)


@pytest.mark.parametrize("name", ["allconv", "densenet", "resnext"])
def test_registry_builds_jaxs_full_size_models(name):
    """build_model at the full size (AllConvNet with pos '1' as the YAMLs
    write it, DenseNet-40-12, ResNeXt-29 4×32d): the JAX tree (shapes
    only) carries over to exactly its state_dict keys and shapes, back
    with no key missing; cn_num as JAX's."""
    kw, cfg = _knobs(name, None)
    kw["pos"] = load_config(os.path.join(_CIFAR10, name, "cnsn.yaml")).pos
    jm = jax_build_model(name, 10, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, 32, 32, 3)), False, None))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         (dict(shapes["params"]),
                          dict(shapes["batch_stats"])))
    port = build_model(name, 10, **kw)
    km = _key_map(name, int(kw["pos"]) if name == "allconv" else None)
    assert ({k: tuple(t.shape)
             for k, t in state_dict_from_jax(*zeros, km).items()}
            == {k: tuple(t.shape) for k, t in port.state_dict().items()})
    _, _, missing = convert_state_dict(port.state_dict(), *zeros,
                                       strict=True, key_map=km)
    assert missing == []
    assert port.cn_num == jm.cn_num == {"allconv": 9, "densenet": 36,
                                        "resnext": 9}[name]


def test_densenet_k4_paths_at_bf16():
    """Under CNSN_CONV3X3=pallas at bf16, DenseNet-40-12's 37 3×3 convs go
    to K4: the stem (3→24) and the first dense layer (24→12) to the
    narrow kernel, the other 35 (Cin 36…444 > 32, Cout 12) to wmma, by
    ``wgrad3x3_path``'s rule at their shapes."""
    model = build_model("densenet", 10, pos="conv1_pre", cnsn_type="cnsn")
    paths = []

    def hook(module, inputs, out):
        x = inputs[0].permute(0, 2, 3, 1).to(torch.bfloat16)
        dy = torch.empty(out.permute(0, 2, 3, 1).shape, dtype=torch.bfloat16)
        paths.append(wgrad3x3_path(x.contiguous(), dy))

    for m in model.modules():
        if isinstance(m, Conv2d) and m.weight.shape[2] == 3:
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.eval()(torch.zeros(1, 32, 32, 3))
    assert {p: paths.count(p) for p in set(paths)} == {"narrow": 2,
                                                        "wmma": 35}


@pytest.mark.parametrize("name", ["allconv", "densenet", "resnext"])
def test_kernels_receive_nhwc_contiguous_tensors(name, monkeypatch):
    """The K1, K2 and K3 entry points see NHWC-contiguous tensors (what
    their CUDA wrappers require) in a train forward with CrossNorm on and
    in an eval forward of the model's cnsn.yaml."""
    seen = []

    def watch(fn):
        def wrapped(x, *a, **k):
            seen.append(x.is_contiguous())
            return fn(x, *a, **k)
        return wrapped

    bn = port_norm.BnSums
    monkeypatch.setattr(port_norm, "BnSums", type(
        "BnSums", (), {"apply": staticmethod(watch(bn.apply))}))
    monkeypatch.setattr(port_cnsn, "instance_mean_std",
                        watch(port_cnsn.instance_mean_std))
    monkeypatch.setattr(port_cnsn, "selfnorm_infer",
                        watch(port_cnsn.selfnorm_infer))
    _, cfg = _knobs(name, None)
    size = {"allconv": {}, "densenet": dict(depth=7),
            "resnext": dict(depth=11)}[name]
    model = MODELS[name][1](num_classes=10, pos=cfg.pos,
                            cnsn_type=cfg.cnsn_type, crop=cfg.crop, **size)
    x = torch.randn(2, 32, 32, 3)
    model.train()(x, [True] * model.cn_num,
                  generator=torch.Generator().manual_seed(0))
    n_train = len(seen)
    with torch.no_grad():
        model.eval()(x)
    assert n_train > 0 and len(seen) > n_train and all(seen)
