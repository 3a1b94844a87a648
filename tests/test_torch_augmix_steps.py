"""The AugMix regimes of the port (``StepFns.augmix``, ``augmix_cn`` and
``cn_image_augmix``) against JAX's ``StepFns`` on the CPU, in float64,
JAX's site masks, permutations and boxes fed in, and the Trainer's gate
between each gated step and ``augmix``.

``augmix`` and ``augmix_cn``: cifar10/wideresnet/cnsn-augmix.yaml (CNSN
at pos 'post', crop 'style', 1 site on, consist_wt 10) on WRN-10-2 at
16², b=4; ``cn_image_augmix``: imagenet/resnet50_ibn_b/cnsn-augmix.yaml
(SelfNorm at pos 'residual', image CrossNorm crop 'neither') on
ResNet-50-IBN-b at layers (1, 1, 1, 1) and 64².  The views are made by
the host AugMix of both packages from one image batch.  The bounds are
test_torch_consistency.py's: loss, ce and jsd within 1e-10 relative,
every parameter, running statistic and momentum buffer within 1e-6 of
its tensor's max-abs (or of 1e-9, for the BatchNorm biases that IBN-b's
InstanceNorms leave without a gradient: test_torch_resnet_ibn.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.train.trainer as jax_trainer_mod
from cnsn_tpu.models.resnet_ibn import ResNetIBN as JaxResNetIBN
from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.data import augmix, normalize
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
from cnsn_tpu_torch.train.trainer import Trainer
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_consistency import BOUNDS, _jax_state, _stub
from test_torch_resnet_ibn import _worst
from test_torch_trainer import _configs, small  # noqa: F401 (fixture)
from test_torch_wideresnet import _find_trace, _np64

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs")
WRN_AUGMIX = os.path.join(_CONFIGS, "cifar10", "wideresnet",
                          "cnsn-augmix.yaml")
IBN_AUGMIX = os.path.join(_CONFIGS, "imagenet", "resnet50_ibn_b",
                          "cnsn-augmix.yaml")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, torch's default
    pool (a thread a core in each worker) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _views(b, size, seed):
    """(3, b, size, size, 3) float64 views (clean, AugMix, AugMix) of a
    random image batch by the port's host AugMix, and labels."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3), np.uint8)
    views = [(normalize(im), augmix(rng, im, normalize, size),
              augmix(rng, im, normalize, size)) for im in images]
    return (np.stack([np.stack(v) for v in zip(*views)]).astype(np.float64),
            rng.randint(0, 10, b))


def _run(jax_model, port, step, images, labels, cfg, lr, draws, feed):
    """JAX's ``step`` (compiled, its draws recorded) and the port's, from
    the same initial weights, in float64, ``feed(draws)`` the port's
    keyword arguments; the errors."""
    sgd = dict(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
               nesterov=cfg.nesterov)
    with jax.enable_x64(True):
        tx = make_sgd(jax_schedules.cosine_lr(*lr), **sgd)
        state, init = _jax_state(jax_model, port, images.shape[1:], tx)
        new, metrics = draws.jit(getattr(JaxStepFns(
            jax_model, active_num=cfg.active_num or 1,
            consist_wt=cfg.consist_wt or 0.0, image_crop=cfg.crop,
            image_beta=cfg.beta), "_" + step))(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(5))
        want_metrics = {k: float(metrics[k]) for k in ("loss", "ce", "jsd")}
        want = (_np64(new.params), _np64(new.batch_stats),
                _np64(_find_trace(new.opt_state)))
    port.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(port.double(), cosine_lr(*lr), device="cpu",
                            **sgd)
    steps = StepFns(active_num=cfg.active_num or 1,
                    consist_wt=cfg.consist_wt or 0.0, image_crop=cfg.crop,
                    image_beta=cfg.beta)
    ts, got = getattr(steps, step)(
        ts, torch.from_numpy(images), torch.from_numpy(labels), **feed(draws))
    assert ts.step == 1 and set(got) == {"loss", "ce", "jsd", "err1"}
    np.testing.assert_allclose(float(got["err1"]), float(metrics["err1"]))
    opt = ts.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in ts.model.named_parameters()}
    return (max(abs(float(got[k]) - want_metrics[k]) / abs(want_metrics[k])
                for k in ("loss", "ce", "jsd")),
            _worst(ts.model.state_dict(), state_dict_from_jax(*want[:2])),
            _worst(momentum, state_dict_from_jax(want[2], {})))


@pytest.mark.parametrize("step", ["augmix", "augmix_cn"])
def test_cifar_augmix_steps_match_jax(step, monkeypatch):
    """One step of cnsn-augmix.yaml's two step functions: the 3B forward
    (and, gated, the two CrossNorm forwards of the clean view with JAX's
    masks and site draws)."""
    draws = JaxDraws(monkeypatch)
    cfg = load_config(WRN_AUGMIX)
    assert (cfg.regime, cfg.crop, cfg.active_num, cfg.consist_wt) == \
        ("cn_augmix", "style", 1, 10)
    kw = dict(depth=10, widen_factor=2, num_classes=10, pos=cfg.pos,
              cnsn_type=cfg.cnsn_type, crop=cfg.crop, beta=cfg.beta)
    images, labels = _views(4, 16, 3)

    def feed(d):
        if step == "augmix":
            return {}
        masks = [np.array(m).tolist() for m in d.masks]
        sites = d.sites(cfg.crop)
        n = len(sites) // 2
        assert len(masks) == 2 and n == JaxWideResNet(**kw).cn_num
        return dict(masks=masks, draws=(sites[:n], sites[n:]))

    errs = _run(JaxWideResNet(**kw), WideResNet(**kw), step, images, labels,
                cfg, (cfg.lr, 7800), draws, feed)
    assert all(e <= b for e, b in zip(errs, BOUNDS)), errs


def test_cn_image_augmix_step_matches_jax(monkeypatch):
    """One ``cn_image_augmix`` step of the IBN-b recipe: image CrossNorm
    over the whole 3B batch (JAX's permutation of 3B instances fed in),
    then the AugMix update."""
    draws = JaxDraws(monkeypatch)
    cfg = load_config(IBN_AUGMIX)
    assert (cfg.regime, cfg.crop, cfg.pos, cfg.cnsn_type) == \
        ("cn_image_augmix", "neither", "residual", "sn")
    kw = dict(layers=(1, 1, 1, 1), num_classes=10, pos=cfg.pos,
              cnsn_type=cfg.cnsn_type)
    images, labels = _views(4, 64, 4)
    images = images * 0.5 + 0.1  # not CIFAR's statistics

    def feed(d):
        (image_draw,) = d.sites(cfg.crop)
        assert image_draw["perm"].shape == (12,)
        return image_draw

    errs = _run(JaxResNetIBN(ibn_cfg=("b", "b", None, None), stem="conv",
                             **kw),
                build_model("resnet50_ibn_b", generator=torch.Generator(),
                            **kw),
                "cn_image_augmix", images, labels, cfg, (0.05, 4), draws,
                feed)
    assert all(e <= b for e, b in zip(errs, BOUNDS)), errs


def test_augmix_steps_draw_what_they_are_not_given():
    """Without masks, draws or a permutation, each gated step draws them
    from the generator: the same seed gives the same step, bit for bit;
    loss = ce + 12 · jsd for ``augmix``."""
    def run(name, seed):
        model = WideResNet(depth=10, widen_factor=1, pos="post",
                           cnsn_type="cnsn", crop="style",
                           generator=torch.Generator().manual_seed(1))
        ts = create_train_state(model, lambda s: 0.1, device="cpu")
        images = torch.randn(3, 4, 16, 16, 3,
                             generator=torch.Generator().manual_seed(2))
        labels = torch.tensor([0, 1, 2, 3])
        steps = StepFns(active_num=1, consist_wt=10.0)
        kw = ({} if name == "augmix"
              else dict(generator=torch.Generator().manual_seed(seed)))
        _, metrics = getattr(steps, name)(ts, images, labels, **kw)
        return metrics, [p.detach().clone() for p in model.parameters()]

    for name in ("augmix", "augmix_cn", "cn_image_augmix"):
        (m1, p1), (m2, p2) = run(name, 3), run(name, 3)
        assert set(m1) == {"loss", "ce", "jsd", "err1"}
        assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    m, _ = run("augmix", 0)
    np.testing.assert_allclose(float(m["loss"]),
                               float(m["ce"]) + 12 * float(m["jsd"]),
                               rtol=1e-6)


@pytest.mark.parametrize("over,regime,steps", [
    ({}, "cn_augmix", ("augmix_cn", "augmix")),
    (dict(no_jsd=True), "cn_augmix", ("cn", "plain")),
], ids=["cn_augmix", "no_jsd"])
def test_trainer_gate_dispatches_the_augmix_steps(small, over, regime,
                                                  steps, tmp_path):
    """Two epochs of 8 steps at b=16 through the host AugMix loader (the
    first 128 synthetic images): each step's function (the gated step
    when RandomState(seed).rand() < cn_prob, else the other) and its
    labels, equal to JAX's Trainer's; the batches are (3, B, 32, 32, 3),
    or (B, 32, 32, 3) under no_jsd."""
    cfg, jcfg = _configs(WRN_AUGMIX, tmp_path, batch_size=16, **over)
    assert cfg.regime == jcfg.regime == regime
    port, jt = Trainer(cfg, device="cpu"), jax_trainer_mod.Trainer(jcfg)
    for ld in (port.train_loader, jt.train_loader):
        d = ld.data
        ld.data = type(d)(d.images[:128], d.labels[:128], d.num_classes)
    calls, shapes = [], []
    _stub(port, jt, calls, steps)
    recorded = {name: getattr(port.steps, name) for name in steps}

    def shape_of(name):
        def step(state, im, lb, **kw):
            shapes.append(tuple(im.shape))
            return recorded[name](state, im, lb, **kw)
        return step
    for name in steps:
        setattr(port.steps, name, shape_of(name))
    try:
        for _ in range(2):
            port.train_epoch()
            jt.train_epoch()
    finally:
        port.close()
        jt.close()
    got = [c[1:] for c in calls if c[0] == "port"]
    want = [c[1:] for c in calls if c[0] == "jax"]
    assert len(got) == 2 * 128 // 16 and got == want
    assert 0 < sum(name == steps[0] for name, _ in got) < len(got)
    view = () if cfg.no_jsd else (3,)
    assert set(shapes) == {view + (16, 32, 32, 3)}
