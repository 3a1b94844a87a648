"""The port's ImageNet data and host AugMix (cnsn_tpu_torch.data) against
the JAX package's on the CPU, bit for bit: the ImageNet transforms, the
folder scan, the ImageNet-C layout, ``augmix()``, and the ImageNet and
CIFAR AugMix loaders' batches without worker processes (the pools:
tests/test_torch_pools.py).

The JAX loader takes its native C++ decoder for JPEG folders wherever
``csrc/libcnsn_loader.so`` is built; it is built with ``use_native=False``
here, so that both packages decode with PIL and the port is what is
compared.
"""
import importlib
import os

import numpy as np
import pytest
from PIL import Image

from cnsn_tpu.data import cifar as jax_cifar
from cnsn_tpu.data import imagenet as jax_imagenet
from cnsn_tpu.data import transforms as jax_transforms
from cnsn_tpu_torch.data import cifar, imagenet, transforms

# the modules (both packages export a function of the same name)
augmix = importlib.import_module("cnsn_tpu_torch.data.augmix")
jax_augmix = importlib.import_module("cnsn_tpu.data.augmix")

# (class, images, height, width): sizes that exercise both crop paths
_CLASSES = (("n01", 3, 60, 80), ("n02", 2, 90, 70), ("n03", 3, 50, 50))


def write_folder(root, seed=0, classes=_CLASSES, quality=90):
    """A class-per-folder tree of JPEGs (and one PNG, in a subfolder) of
    smooth random content, written by PIL."""
    rng = np.random.RandomState(seed)
    for name, n, h, w in classes:
        for i in range(n):
            d = os.path.join(root, name, "sub") if i == 0 else os.path.join(
                root, name)
            os.makedirs(d, exist_ok=True)
            base = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
            img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
            ext = ".png" if (name, i) == ("n02", 1) else ".jpeg"
            img.save(os.path.join(d, f"{i}{ext}"), quality=quality)
        # not an image: skipped by both scanners
        open(os.path.join(root, name, "notes.txt"), "w").close()
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(str(tmp_path_factory.mktemp("imagenet")))


def test_scan_and_imagenet_c_dir_match_jax(folder):
    got = imagenet.scan_image_folder(folder)
    want = jax_imagenet.scan_image_folder(folder)
    assert got.classes == want.classes == ["n01", "n02", "n03"]
    assert got.samples == want.samples and len(got.samples) == 8
    assert any(p.endswith(".png") for p, _ in got.samples)
    assert imagenet.imagenet_c_dir("/c", "fog", 3) == \
        jax_imagenet.imagenet_c_dir("/c", "fog", 3) == "/c/fog/3"


@pytest.mark.parametrize("seed", range(6))
def test_imagenet_transforms_match_jax(seed):
    """RandomResizedCrop (its 10 attempts and the centre fallback, which a
    tall thin image forces), the 256 → 224 centre crop, the normalization
    and its constants."""
    rng = np.random.RandomState(seed)
    h, w = ((300, 40) if seed == 5 else (rng.randint(40, 300),
                                          rng.randint(40, 300)))
    img = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
    a, b = np.random.RandomState(seed), np.random.RandomState(seed)
    got = transforms.random_resized_crop(a, img, 48)
    want = jax_transforms.random_resized_crop(b, img, 48)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert a.rand() == b.rand()  # the same draws were taken
    np.testing.assert_array_equal(
        np.asarray(transforms.center_crop_resize(img, 64, 56)),
        np.asarray(jax_transforms.center_crop_resize(img, 64, 56)))
    arr = np.asarray(got)
    out = transforms.imagenet_normalize(arr)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jax_transforms.imagenet_normalize(arr))
    np.testing.assert_array_equal(transforms.IMAGENET_MEAN,
                                  jax_transforms.IMAGENET_MEAN)
    np.testing.assert_array_equal(transforms.IMAGENET_STD,
                                  jax_transforms.IMAGENET_STD)


@pytest.mark.parametrize("all_ops", [False, True])
@pytest.mark.parametrize("depth", [-1, 2])
def test_augmix_matches_jax(all_ops, depth):
    """Five views each of three images, at CIFAR's normalization and
    ImageNet's: equal bits, and the same draws taken."""
    rng = np.random.RandomState(1)
    for size, pre in ((32, transforms.normalize),
                      (40, transforms.imagenet_normalize)):
        for k in range(3):
            img = rng.randint(0, 256, (size, size, 3), np.uint8)
            a = np.random.RandomState(10 + k)
            b = np.random.RandomState(10 + k)
            for _ in range(5):
                got = augmix.augmix(a, img, pre, size, all_ops=all_ops,
                                    mixture_depth=depth, aug_severity=3)
                want = jax_augmix.augmix(b, img, pre, size, all_ops=all_ops,
                                         mixture_depth=depth, aug_severity=3)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
            assert a.rand() == b.rand()
    assert len(augmix.AUGMENTATIONS) == 9
    assert len(augmix.AUGMENTATIONS_ALL) == 13


def _epochs(got_loader, want_loader, epochs=2):
    assert len(got_loader) == len(want_loader)
    for _ in range(epochs):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    return got


@pytest.mark.parametrize("mode,batch", [("train", 3), ("eval", 3),
                                        ("train_augmix", 4)])
def test_imagenet_loader_matches_jax(folder, mode, batch):
    """Two epochs (RandomState(seed + epoch * 1009)) on two threads:
    every image and label, the dropped (train) or short (eval) last
    batch, and the view axis of train_augmix."""
    kw = dict(mode=mode, seed=5, image_size=32, workers=2, aug_severity=1)
    got = _epochs(imagenet.ImageNetLoader(imagenet.scan_image_folder(folder),
                                          batch, **kw),
                  jax_imagenet.ImageNetLoader(
                      jax_imagenet.scan_image_folder(folder), batch,
                      use_native=False, **kw))
    images, labels = got[-1]
    if mode == "train_augmix":
        assert images.shape == (3, 4, 32, 32, 3)
        assert not np.array_equal(images[0], images[1])
    else:
        assert images.shape[1:] == (32, 32, 3)
        assert images.shape[0] == (2 if mode == "eval" else 3)
    assert labels.dtype == np.int32


@pytest.mark.parametrize("mode", ["train_augmix", "train_augmix_nojsd"])
def test_cifar_augmix_loader_matches_jax(mode):
    """Two epochs of the CIFAR AugMix modes, serially, at the recipes'
    severity 3 and at all_ops: equal bits to JAX's loader."""
    for kw in (dict(aug_severity=3), dict(aug_severity=1, all_ops=True,
                                          mixture_depth=1)):
        data = cifar.load_cifar("", synthetic=True, synthetic_size=20)
        ref = jax_cifar.load_cifar("", synthetic=True, synthetic_size=20)
        got = _epochs(cifar.CifarLoader(data, 8, mode=mode, seed=2, **kw),
                      jax_cifar.CifarLoader(ref, 8, mode=mode, seed=2, **kw))
        images, labels = got[-1]
        assert images.shape == ((3, 8, 32, 32, 3) if mode == "train_augmix"
                                else (8, 32, 32, 3))
        assert images.dtype == np.float32 and len(labels) == 8
