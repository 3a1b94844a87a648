"""The port's host AugMix worker processes (``data/workers.py``'s
``PrefetchPool`` under the CIFAR and ImageNet loaders) against the JAX
package's serial and thread paths, bit for bit, and the pools' life in
the Trainer: they outlive ``fit()`` (the JAX Trainer's ``fit()`` closes
them, so a second ``fit()`` there runs serial AugMix) and stop at
``close()``.  Every pool here has 2 workers and is closed in a
``finally`` or a ``with``; the pool tests live in this one file, so that
``--dist loadfile`` keeps them on one worker.
"""
import os

import numpy as np
import torch

import cnsn_tpu_torch.train.trainer as trainer_mod
from cnsn_tpu.data import cifar as jax_cifar
from cnsn_tpu.data import imagenet as jax_imagenet
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.data import cifar, imagenet
from cnsn_tpu_torch.data.workers import PrefetchPool
from cnsn_tpu_torch.models.wideresnet import WideResNet
from test_torch_imagenet_data import write_folder
from test_torch_threads import one_thread  # noqa: F401 (autouse)


_WRN_AUGMIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "cifar10", "wideresnet",
    "cnsn-augmix.yaml")


def _equal_epochs(got_loader, want_loader, epochs=2):
    for _ in range(epochs):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_imagenet_pool_matches_jax_threads(tmp_path):
    """train_augmix through 2 worker processes: two epochs equal to JAX's
    thread path (PIL decode)."""
    folder = write_folder(str(tmp_path))
    kw = dict(mode="train_augmix", seed=7, image_size=32, workers=2)
    with imagenet.ImageNetLoader(imagenet.scan_image_folder(folder), 4,
                                 mp_workers=2, **kw) as pooled:
        assert pooled._pool is not None
        _equal_epochs(pooled, jax_imagenet.ImageNetLoader(
            jax_imagenet.scan_image_folder(folder), 4, use_native=False,
            **kw))
    assert pooled._pool is None


def test_cifar_pools_match_jax_serial():
    """Both CIFAR AugMix modes through 2 worker processes: two epochs
    equal to JAX's serial loader; after close() the loader goes on
    serially with the same bits."""
    for mode in ("train_augmix", "train_augmix_nojsd"):
        data = cifar.load_cifar("", synthetic=True, synthetic_size=24)
        ref = jax_cifar.load_cifar("", synthetic=True, synthetic_size=24)
        want = jax_cifar.CifarLoader(ref, 8, mode=mode, seed=3)
        pooled = cifar.CifarLoader(data, 8, mode=mode, seed=3, workers=2)
        try:
            _equal_epochs(pooled, want)
        finally:
            pooled.close()
        assert pooled._pool is None
        _equal_epochs(pooled, want, epochs=1)


def test_pool_maps_in_order_and_refuses_use_after_close():
    with PrefetchPool(2) as pool:
        out = list(pool.run(abs, iter([([-1, -2, 3], "a"), ([-4], "b")])))
    assert out == [([1, 2, 3], "a"), ([4], "b")]
    try:
        next(pool.run(abs, iter([([-1], None)])))
    except RuntimeError as e:
        assert "after close" in str(e)
    else:
        raise AssertionError("a closed pool ran")


def test_trainer_pool_outlives_fit_and_stops_at_close(monkeypatch,
                                                      tmp_path):
    """cnsn-augmix.yaml (cn_augmix) at augmix_workers=2 on WRN-10-2, the
    steps stubbed: the pool serves two fit() calls (one epoch each), the
    same pool both times, and close() stops it."""
    monkeypatch.setattr(trainer_mod, "build_model",
                        lambda name, classes, generator=None, num_groups=1,
                        **kw:
                        WideResNet(depth=10, widen_factor=1,
                                   num_classes=classes, generator=generator,
                                   **{k: v for k, v in kw.items()
                                      if v is not None}))
    cfg = load_config(_WRN_AUGMIX, synthetic_data=True, snapshot=False,
                      augmix_workers=2, batch_size=128, eval_batch_size=512,
                      epochs=2, exp_dir=str(tmp_path))
    t = trainer_mod.Trainer(cfg, device="cpu")
    try:
        pool = t.train_loader._pool
        assert pool is not None and t.train_loader.mode == "train_augmix"
        seen = []

        def step(state, images, labels, generator=None):
            seen.append(tuple(images.shape))
            return state, {"loss": torch.zeros(())}

        t.steps.augmix = t.steps.augmix_cn = step
        t.fit(epochs=1)
        assert t.train_loader._pool is pool and pool._pool is not None
        t.fit(epochs=1)
        assert t.train_loader._pool is pool
        assert seen == [(3, 128, 32, 32, 3)] * 8
    finally:
        t.close()
    assert t.train_loader._pool is None and pool._pool is None
