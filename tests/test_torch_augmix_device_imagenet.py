"""On-device AugMix at 64² with the ImageNet statistics against the JAX
package's chain on the CPU (the 32² chain, each op alone and the draws:
test_torch_augmix_device.py, whose replay of JAX's key tree this file
uses).  B=2 at the ImageNet recipes' severity 1; the knobs at a mixture
width of 1, every branch three ops deep.  Each XLA compile of JAX's chain
costs 5–20 s on the CPU, and the severity is part of its cache key."""
import numpy as np
import pytest

from cnsn_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from test_torch_augmix_device import KNOBS, chain_case
from test_torch_threads import one_thread  # noqa: F401 (autouse)

IMAGENET = dict(mean=tuple(map(float, IMAGENET_MEAN)),
                std=tuple(map(float, IMAGENET_STD)))


def test_chain_matches_jax_64(monkeypatch):
    chain_case(64, 2, IMAGENET, (10, 11), monkeypatch=monkeypatch,
               severity=1.0)


@pytest.mark.parametrize("knobs", KNOBS)
def test_chain_matches_jax_64_knobs(knobs, monkeypatch):
    chain_case(64, 2, IMAGENET, (12, 13), knobs, monkeypatch=monkeypatch,
               severity=1.0, mixture_width=1, mixture_depth=3)


def test_imagenet_statistics_are_float32_values():
    """The Trainer passes the float32 statistics as Python floats, as the
    JAX Trainer does: 255·mean in float32 is the same either way."""
    np.testing.assert_array_equal(
        np.asarray(IMAGENET["mean"], np.float32), IMAGENET_MEAN)
    np.testing.assert_array_equal(
        np.asarray(IMAGENET["std"], np.float32), IMAGENET_STD)
