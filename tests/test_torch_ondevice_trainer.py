"""The port's Trainer with ``ondevice_augmix`` against the JAX package's on
the CPU: cifar10/wideresnet/cnsn-augmix.yaml at cn_prob 0 (every step an
``augmix`` step), a WRN-10-2 patched into both model factories (this file
only), the synthetic set's geometry batches ('train_geom', held equal to
JAX's in tests/test_torch_data.py).

The chain's views are float32 in both packages and differ within its
bounds (tests/test_torch_augmix_device.py), so the Trainer is held in two
parts, each through a seam of the port's Trainer:

* the views: ``augmix_draws`` replays the draws of the key JAX's Trainer
  splits off each step (``cnsn_tpu/train/trainer.py:210-212, 246``), and
  each step's views are within the chain's bounds of JAX's;
* the trajectory: ``augmix_views`` hands JAX's views to the port's steps,
  both Trainers in float64 from JAX's weights: each step's loss within
  1e-10, the state after the epoch within 1e-6.

Then one ImageNet step on a PIL-written folder ('train_geom', the ImageNet
statistics), and ``no_jsd`` with ``ondevice_augmix`` raising in both
packages.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.data.augmix_jax as jax_augmix
import cnsn_tpu.train.trainer as jax_trainer_mod
import cnsn_tpu_torch.models as port_models
import cnsn_tpu_torch.train.trainer as trainer_mod
from cnsn_tpu.config import load_config as jax_load_config
from cnsn_tpu.data import cifar as jax_cifar
from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.data import cifar
from cnsn_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                            imagenet_normalize)
from cnsn_tpu_torch.models.resnet import ResNet
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.train.trainer import Trainer
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_augmix_device import (FLIP_SHARE, PIXEL_TOL, jax_batch,
                                      jax_draws)
from test_torch_imagenet_data import write_folder
from test_torch_threads import one_thread  # noqa: F401 (autouse)
from test_torch_wideresnet import _find_trace, _np64, _worst

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs")
AUGMIX = os.path.join(_CONFIGS, "cifar10", "wideresnet", "cnsn-augmix.yaml")
IBN_AUGMIX = os.path.join(_CONFIGS, "imagenet", "resnet50_ibn_b",
                          "cnsn-augmix.yaml")
DEPTH, WIDEN, BATCH, IMAGES = 10, 2, 8, 16
OVER = dict(synthetic_data=True, snapshot=False, batch_size=BATCH,
            eval_batch_size=64, ondevice_augmix=True, cn_prob=0.0)


def _knobs(kw):
    return {k: v for k, v in kw.items()
            if v is not None and k not in ("remat", "generator")}


class _F64WideResNet(WideResNet):
    """WRN whose float64 parameters see float64 images."""

    def forward(self, images, **kw):
        return super().forward(images.double(), **kw)


@pytest.fixture
def small(monkeypatch):
    def jax_build(name, num_classes, **kw):
        return JaxWideResNet(depth=DEPTH, widen_factor=WIDEN,
                             num_classes=num_classes, **_knobs(kw))

    def port_build(name, num_classes, generator=None, **kw):
        return _F64WideResNet(depth=DEPTH, widen_factor=WIDEN,
                              num_classes=num_classes, generator=generator,
                              **_knobs(kw))

    monkeypatch.setattr(jax_trainer_mod, "build_model", jax_build)
    monkeypatch.setattr(trainer_mod, "build_model", port_build)
    monkeypatch.setattr(port_models, "build_model", port_build)


def _trainers(tmp_path):
    """Both Trainers of the recipe, their loaders the same IMAGES
    synthetic images in 'train_geom'."""
    cfg = load_config(AUGMIX, exp_dir=str(tmp_path / "port"), **OVER)
    jcfg = jax_load_config(AUGMIX, num_devices=1,
                           exp_dir=str(tmp_path / "jax"), **OVER)
    assert (cfg.regime, cfg.cn_prob, cfg.aug_severity) == ("cn_augmix", 0.0,
                                                           3)
    jt = jax_trainer_mod.Trainer(jcfg)
    pt = Trainer(cfg, device="cpu")
    assert pt.train_loader.mode == jt.train_loader.mode == "train_geom"
    pt.train_loader = cifar.CifarLoader(
        cifar.load_cifar("", synthetic=True, synthetic_size=IMAGES), BATCH,
        mode="train_geom", seed=cfg.seed)
    jt.train_loader = jax_cifar.CifarLoader(
        jax_cifar.load_cifar("", synthetic=True, synthetic_size=IMAGES),
        BATCH, mode="train_geom", seed=cfg.seed)
    return pt, jt


def _record_jax_views(monkeypatch):
    """JAX's augmix_batch, each call's key, batch and views recorded.  The
    views come from ``jax_batch``, JAX's chain in one program half the
    size of ``augmix_batch``'s (held equal to it in
    tests/test_torch_augmix_device.py), under the knobs' values at the
    call.  It runs in 32-bit mode whatever the caller's: under x64 its
    ops' branches differ in type (the Dirichlet weights and levels turn
    float64), which ``lax.switch`` refuses; its views are float32 either
    way."""
    calls = []

    def record(key, images, **kw):
        knobs = (os.environ.get("CNSN_AUGMIX_SHEAR", "matmul"),
                 os.environ.get("CNSN_AUGMIX_EQ", "onehot"))
        with jax.enable_x64(False):
            views = jnp.asarray(jax_batch(key, np.asarray(images), knobs,
                                          **kw))
        calls.append((key, np.asarray(images), np.asarray(views), kw))
        return views

    monkeypatch.setattr(jax_augmix, "augmix_batch", record)
    return calls


def test_views_match_jax_trainer(small, monkeypatch, tmp_path):
    """Each step's views from the draws of JAX's per-step key, within the
    chain's bounds of JAX's; the geometry batch the same; the views on
    the batch's device, the CIFAR statistics.  JAX's step is left out
    (its keys and batches do not depend on it; the trajectory test runs
    it), which spares its compile."""
    pt, jt = _trainers(tmp_path)
    pt.state.model.double()
    calls = _record_jax_views(monkeypatch)
    jt.steps.augmix = lambda state, im, lb, key: (state, {"loss": 0.0})
    jt.train_epoch()
    assert len(calls) == IMAGES // BATCH
    keys = iter(calls)
    seen = []

    def draws(n):
        key, _, _, kw = next(keys)
        assert kw == dict(severity=3.0, mixture_width=3, mixture_depth=-1)
        return jax_draws(key, n, kw["severity"])

    views = pt.augmix_views

    def record(images_u8):
        out = views(images_u8)
        seen.append((images_u8.numpy(), out.numpy()))
        return out

    monkeypatch.setattr(pt, "augmix_draws", draws)
    monkeypatch.setattr(pt, "augmix_views", record)
    pt.train_epoch()
    assert len(seen) == len(calls)
    flips = total = 0
    for (images, got), (_, want_images, want, _) in zip(seen, calls):
        np.testing.assert_array_equal(images, want_images)
        assert images.dtype == np.uint8 and got.shape == (3, BATCH, 32, 32,
                                                          3)
        diff = np.abs(got - want) * 127.5
        flips += int((diff > PIXEL_TOL).sum())
        total += diff.size
    print(f"{flips} of {total} view pixels past {PIXEL_TOL} (step flips)")
    assert flips <= FLIP_SHARE * total


def test_trajectory_on_jax_views_matches_jax_in_float64(small, monkeypatch,
                                                       tmp_path):
    """JAX's views fed to the port's augmix steps, both in float64 from
    JAX's initial weights: each step's loss and the epoch's mean within
    1e-10, every parameter, running statistic and momentum buffer after
    the epoch within 1e-6."""
    pt, jt = _trainers(tmp_path)
    calls = _record_jax_views(monkeypatch)
    with jax.enable_x64(True):
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     (jt.state.params, jt.state.batch_stats))
        init = jt.state
        jt.state = jt.dp.replicate(jt.state.replace(
            params=params, batch_stats=stats,
            opt_state=jt.state.tx.init(params)))
        want_losses, augmix = [], jt.steps.augmix

        def record_jax(*args):
            state, metrics = augmix(*args)
            want_losses.append(float(metrics["loss"]))
            return state, metrics

        jt.steps.augmix = record_jax
        want_avg = jt.train_epoch()
        want = state_dict_from_jax(_np64(jt.state.params),
                                   _np64(jt.state.batch_stats))
        want_m = state_dict_from_jax(_np64(_find_trace(jt.state.opt_state)),
                                     {})
    assert len(calls) == len(want_losses) == IMAGES // BATCH
    pt.state.model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, init.params),
        jax.tree.map(np.asarray, init.batch_stats)), strict=True)
    pt.state.model.double()
    jax_views = iter(calls)
    monkeypatch.setattr(pt, "augmix_views",
                        lambda im: torch.from_numpy(next(jax_views)[2]))
    got_losses, augmix_port = [], pt.steps.augmix

    def record_port(*args):
        state, metrics = augmix_port(*args)
        got_losses.append(float(metrics["loss"]))
        return state, metrics

    pt.steps.augmix = record_port
    got_avg = pt.train_epoch()
    assert pt.state.step == IMAGES // BATCH
    opt = pt.state.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in pt.state.model.named_parameters()}
    loss_err = max(abs(g - w) / abs(w) for g, w in
                   zip(got_losses + [got_avg], want_losses + [want_avg]))
    errs = (loss_err, _worst(pt.state.model.state_dict(), want),
            _worst(momentum, want_m))
    assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs


def test_no_jsd_with_ondevice_augmix_raises(tmp_path):
    over = dict(OVER, no_jsd=True)
    with pytest.raises(ValueError, match="ondevice_augmix"):
        Trainer(load_config(AUGMIX, exp_dir=str(tmp_path), **over),
                device="cpu")
    assert os.listdir(tmp_path) == []
    with pytest.raises(ValueError, match="ondevice_augmix"):
        jax_trainer_mod.Trainer(jax_load_config(
            AUGMIX, num_devices=1, exp_dir=str(tmp_path), **over))


def test_one_imagenet_step_builds_views_on_the_batch(monkeypatch, tmp_path):
    """resnet50_ibn_b/cnsn-augmix.yaml with ondevice_augmix on a
    PIL-written folder (a ResNet-50 at layers (1, 1, 1, 1) patched in, at
    64²): the loader hands over uint8 geometry, the clean view is that
    batch under the ImageNet statistics, the views carry the Trainer's
    draws, the step moves the weights; ``all_ops`` does not reach the
    chain (the nine default ops, as in JAX)."""
    def port_build(name, num_classes, generator=None, **kw):
        return ResNet(layers=(1, 1, 1, 1), num_classes=num_classes,
                      generator=generator, **_knobs(kw))

    monkeypatch.setattr(trainer_mod, "build_model", port_build)
    root = str(tmp_path / "data")
    classes = (("n01", 4, 70, 80), ("n02", 4, 90, 66))
    write_folder(os.path.join(root, "train"), 1, classes)
    write_folder(os.path.join(root, "validation"), 2, classes)
    cfg = load_config(IBN_AUGMIX, data_dir=root, image_size=64,
                      batch_size=4, eval_batch_size=4, snapshot=False,
                      workers=2, ondevice_augmix=True, all_ops=True,
                      exp_dir=str(tmp_path / "exp"))
    assert cfg.regime == "cn_image_augmix"
    pt = Trainer(cfg, device="cpu")
    assert pt.train_loader.mode == "train_geom"
    seen, views, drawn = [], pt.augmix_views, pt.augmix_draws

    def record_draws(n):
        d = drawn(n)
        seen.append(("draws", d))
        return d

    def record(images_u8):
        out = views(images_u8)
        seen.append(("views", images_u8.numpy(), out.numpy()))
        return out

    monkeypatch.setattr(pt, "augmix_draws", record_draws)
    monkeypatch.setattr(pt, "augmix_views", record)
    before = [p.detach().clone() for p in pt.state.model.parameters()]
    loss = pt.train_epoch()
    assert np.isfinite(loss) and pt.state.step == 2
    assert [s[0] for s in seen] == ["draws", "views"] * 2
    for (_, d), (_, images, out) in zip(seen[::2], seen[1::2]):
        assert images.dtype == np.uint8 and images.shape == (4, 64, 64, 3)
        assert out.shape == (3, 4, 64, 64, 3)
        # the chain's (z − 255·mean) / (255·std), within float32 rounding
        # of the host's (z / 255 − mean) / std
        np.testing.assert_array_equal(out[0], (
            images.astype(np.float32) - IMAGENET_MEAN * np.float32(255))
            / (IMAGENET_STD * np.float32(255)))
        np.testing.assert_allclose(
            out[0], np.stack([imagenet_normalize(im) for im in images]),
            rtol=0, atol=2e-6)
        assert int(d["op"].max()) < 9 and d["level"].max() < 1.0
    assert any(not torch.equal(a, p)
               for a, p in zip(before, pt.state.model.parameters()))
