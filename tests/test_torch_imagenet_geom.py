"""The ImageNet loader's 'train_geom' mode (the input of on-device
AugMix: RandomResizedCrop and a flip, uint8) against the JAX package's
``ImageNetLoader(..., mode="train_geom", use_native=False)`` (its PIL
path; its native decoder has no counterpart in the port) on a PIL-written
folder: two epochs, every image and label equal, at two batch sizes and
two thread counts."""
import numpy as np
import pytest

from cnsn_tpu.data import imagenet as jax_imagenet
from cnsn_tpu_torch.data import imagenet
from test_torch_imagenet_data import _epochs, write_folder
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(str(tmp_path_factory.mktemp("imagenet_geom")), 3)


@pytest.mark.parametrize("batch,workers,size", [(3, 2, 32), (4, 1, 48)])
def test_train_geom_matches_jax_pil_path(folder, batch, workers, size):
    kw = dict(mode="train_geom", seed=11, image_size=size, workers=workers)
    loader = imagenet.ImageNetLoader(imagenet.scan_image_folder(folder),
                                     batch, **kw)
    got = _epochs(loader, jax_imagenet.ImageNetLoader(
        jax_imagenet.scan_image_folder(folder), batch, use_native=False,
        **kw))
    images, labels = got[-1]
    assert images.dtype == np.uint8 and images.shape == (batch, size, size,
                                                         3)
    assert labels.dtype == np.int32
    assert len(loader) == 8 // batch   # the last short batch dropped


def test_train_geom_is_train_before_normalizing(folder):
    """The same draws as 'train': its batch is 'train_geom''s, normalized
    with the ImageNet statistics."""
    from cnsn_tpu_torch.data.transforms import imagenet_normalize
    data = imagenet.scan_image_folder(folder)
    geom = list(imagenet.ImageNetLoader(data, 4, mode="train_geom", seed=2,
                                        image_size=32, workers=2))
    train = list(imagenet.ImageNetLoader(data, 4, mode="train", seed=2,
                                         image_size=32, workers=2))
    for (g, gl), (t, tl) in zip(geom, train):
        np.testing.assert_array_equal(
            np.stack([imagenet_normalize(im) for im in g]), t)
        np.testing.assert_array_equal(gl, tl)
