"""The port's CIFAR data (cnsn_tpu_torch.data) against the JAX package's
on the CPU: the datasets as loaded (synthetic, and fake pickled
cifar-10-batches-py / cifar-100-python files), the transforms, CIFAR-C,
and the loader's batches in every ported mode over two epochs, bit for
bit."""
import os
import pickle

import numpy as np
import pytest

from cnsn_tpu.data import cifar as jax_cifar
from cnsn_tpu.data import transforms as jax_transforms
from cnsn_tpu_torch.data import cifar, transforms

# images per fake pickle file: 5 train batches of 23 and a test batch of 37
# (CIFAR-10), or one file each (CIFAR-100)
_PER_FILE, _TEST = 23, 37


def _pickle(path, data, labels_key, labels):
    with open(path, "wb") as f:
        pickle.dump({"data": data, labels_key: labels,
                     "batch_label": "fake"}, f)


@pytest.fixture(scope="module")
def cifar_dirs(tmp_path_factory):
    """A data_dir holding fake cifar-10-batches-py and cifar-100-python
    trees in the published layout: rows of 3072 uint8 (R, G, B planes)."""
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.RandomState(5)
    c10 = root / "cifar-10-batches-py"
    c10.mkdir()
    for i in range(1, 6):
        _pickle(c10 / f"data_batch_{i}",
                rng.randint(0, 256, (_PER_FILE, 3072), np.uint8), "labels",
                rng.randint(0, 10, _PER_FILE).tolist())
    _pickle(c10 / "test_batch", rng.randint(0, 256, (_TEST, 3072), np.uint8),
            "labels", rng.randint(0, 10, _TEST).tolist())
    c100 = root / "cifar-100-python"
    c100.mkdir()
    for name, n in (("train", 5 * _PER_FILE), ("test", _TEST)):
        _pickle(c100 / name, rng.randint(0, 256, (n, 3072), np.uint8),
                "fine_labels", rng.randint(0, 100, n).tolist())
    return str(root)


def _load(module, source, data_dir, train):
    if source == "synthetic":
        return module.load_cifar("", "cifar10", train, synthetic=True,
                                 synthetic_size=100)
    return module.load_cifar(data_dir, source, train)


@pytest.mark.parametrize("source", ["synthetic", "cifar10", "cifar100"])
@pytest.mark.parametrize("train", [True, False])
def test_load_cifar_matches_jax(source, train, cifar_dirs):
    got = _load(cifar, source, cifar_dirs, train)
    want = _load(jax_cifar, source, cifar_dirs, train)
    assert got.images.dtype == np.uint8 and got.images.shape[1:] == (32, 32, 3)
    assert got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.num_classes == want.num_classes


@pytest.mark.parametrize("source", ["synthetic", "cifar10", "cifar100"])
@pytest.mark.parametrize("mode", ["train", "train_geom", "eval"])
def test_loader_batches_are_bit_identical_to_jax(source, mode, cifar_dirs):
    """Two epochs (the per-epoch RandomState(seed + epoch*1009)), batch 16:
    every image and label equal, dtypes and the dropped or short last
    batch included."""
    data = _load(cifar, source, cifar_dirs, mode != "eval")
    ref = _load(jax_cifar, source, cifar_dirs, mode != "eval")
    got_loader = cifar.CifarLoader(data, 16, mode=mode, seed=3)
    want_loader = jax_cifar.CifarLoader(ref, 16, mode=mode, seed=3)
    assert len(got_loader) == len(want_loader)
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    assert got_loader.epoch == 2
    if mode == "eval":  # every image once, in order, the last batch short
        assert sum(len(lb) for _, lb in got) == len(data.labels)


def test_loader_drop_last_and_close():
    data = cifar.load_cifar("", synthetic=True, synthetic_size=40)
    assert len(cifar.CifarLoader(data, 16)) == 2
    assert len(cifar.CifarLoader(data, 16, drop_last=False)) == 3
    loader = cifar.CifarLoader(data, 16, mode="eval")
    assert [len(lb) for _, lb in loader] == [16, 16, 8]
    loader.close()
    loader.close()  # idempotent


@pytest.mark.parametrize("mode", ["train_augmix", "train_augmix_nojsd"])
def test_augmix_modes_raise(mode):
    """The AugMix modes, which raised before the AugMix slice, build
    their views (JAX's bits: tests/test_torch_imagenet_data.py); an
    unknown mode raises."""
    data = cifar.load_cifar("", synthetic=True, synthetic_size=8)
    images, labels = next(iter(cifar.CifarLoader(data, 4, mode=mode)))
    assert images.shape == ((3, 4, 32, 32, 3) if mode == "train_augmix"
                            else (4, 32, 32, 3))
    assert images.dtype == np.float32 and labels.shape == (4,)
    with pytest.raises(ValueError, match="unknown mode"):
        cifar.CifarLoader(data, 4, mode="nope")


@pytest.mark.parametrize("name", ["cifar_train_transform", "cifar_train_geom",
                                  "random_crop_pad", "random_hflip"])
def test_random_transforms_match_jax(name):
    img = np.random.RandomState(0).randint(0, 256, (32, 32, 3), np.uint8)
    ours, ref = getattr(transforms, name), getattr(jax_transforms, name)
    for seed in range(6):
        got = ours(np.random.RandomState(seed), img)
        want = ref(np.random.RandomState(seed), img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_normalize_and_eval_transform_match_jax():
    img = np.random.RandomState(1).randint(0, 256, (32, 32, 3), np.uint8)
    np.testing.assert_array_equal(transforms.cifar_eval_transform(img),
                                  jax_transforms.cifar_eval_transform(img))
    np.testing.assert_array_equal(transforms.normalize(img, 0.4, 0.2),
                                  jax_transforms.normalize(img, 0.4, 0.2))


def test_load_cifar_c_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    np.save(tmp_path / "labels.npy", rng.randint(0, 10, 30).astype(np.int64))
    for c in cifar.CORRUPTIONS[:2]:
        np.save(tmp_path / f"{c}.npy",
                rng.randint(0, 256, (30, 32, 32, 3), np.uint8))
    assert cifar.CORRUPTIONS == jax_cifar.CORRUPTIONS
    for c in cifar.CORRUPTIONS[:2]:
        got = cifar.load_cifar_c(str(tmp_path), c)
        want = jax_cifar.load_cifar_c(str(tmp_path), c)
        assert got[1].dtype == np.int32
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_the_data_modules_import_no_pil():
    """Only the modules that decode or augment images import PIL (the
    ImageNet transforms, host AugMix, the ImageNet loader); the card's
    machine has it, with its own JPEG codec (PIL 12.2.0 on the H100
    machine, ``PIL.features.check('jpg')`` True there)."""
    import ast
    root = os.path.dirname(cifar.__file__)
    for fn in os.listdir(root):
        if fn.endswith(".py"):
            tree = ast.parse(open(os.path.join(root, fn)).read())
            names = [a.name for n in ast.walk(tree)
                     if isinstance(n, ast.Import) for a in n.names]
            names += [n.module or "" for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom)]
            uses_pil = any(m.split(".")[0] == "PIL" for m in names)
            assert uses_pil == (fn in ("augmix.py", "imagenet.py",
                                       "transforms.py")), fn
