"""The port's PSANet (cnsn_tpu_torch.segmentation.pspnet: PSA, PSANet)
against the JAX package's, on the CPU, in float64, at psa_type 0
(collect), 1 (distribute) and 2 (both), with the over-complete attention
map expanded by the static gather (here) and ``compact``
(``test_torch_psa_compact.py``, to spread the XLA compiles); at the knobs
and the reduced depth of ``test_torch_psp_models.py`` (its helpers): 65²
images, layer4 at 9², shrunk by 2 to 5² (the mask 9×9, or 25 channels
compact).
Held: eval logits (upsampled and at stride 8), train-mode logits, every
running statistic after the train forward, the weights carried back; the
gather against the reference's psa_mask scatter on the CPU; and the size
rule both packages keep."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.segmentation.pspnet as jax_psp
from cnsn_tpu_torch.segmentation import PSA, PSANet
from test_torch_psp_models import (BACKBONE_BN, KW, SIZE,  # noqa: F401
                                   _images, check_model, jax_outputs,
                                   small)  # (small: a fixture)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

# PSA's BatchNorms a type: reduce, attention (and their _p twins), proj
PSA_BN = {0: 3, 1: 3, 2: 5}


def check_psanet(psa_type, compact, rng):
    """PSANet of ``psa_type`` (compact or not) against JAX's."""
    knobs = dict(psa_type=psa_type, compact=compact, shrink_factor=2)
    x = _images(rng)
    ref = jax_outputs(jax_psp.PSANet(**knobs, **KW), x, rng)
    model = PSANet(image_hw=(SIZE, SIZE), **knobs, **KW)
    psa = model.psa
    assert psa.hw == (5, 5) and psa.mask == (9, 9)
    assert psa.attention[3].weight.shape[0] == (25 if compact else 81)
    assert (psa.mask_index is None) == compact
    assert (psa.reduce_p is None) == (psa_type != 2)
    check_model(model, ref, BACKBONE_BN + PSA_BN[psa_type] + 2)


@pytest.mark.parametrize("psa_type", [0, 1, 2])
def test_psanet_matches_jax(psa_type, small):
    """The over-complete map expanded by the gather (compact: the
    companion file ``test_torch_psa_compact.py``)."""
    check_psanet(psa_type, False, small)


def _scatter(y, mask_h, mask_w, distribute):
    """The reference's psa_mask scatter (segmentation/lib/psa, CPU
    semantics), as JAX's tests/test_segmentation.py holds it: y (n,
    mask_h·mask_w, h, w) → the zero-filled (n, h·w, h·w) buffer."""
    n, _, h, w = y.shape
    out = np.zeros((n, h * w, h * w), y.dtype)
    half_h, half_w = (mask_h - 1) // 2, (mask_w - 1) // 2
    for i in range(h):
        for j in range(w):
            p = i * w + j
            for dh in range(mask_h):
                a = dh + i - half_h
                for dw in range(mask_w):
                    b = dw + j - half_w
                    if 0 <= a < h and 0 <= b < w:
                        g = a * w + b
                        v = y[:, dh * mask_w + dw, i, j]
                        if distribute:
                            out[:, p, g] = v
                        else:
                            out[:, g, p] = v
    return out


@pytest.mark.parametrize("mask", [(9, 9), (3, 5)])
@pytest.mark.parametrize("distribute", [False, True])
def test_expand_matches_the_reference_scatter(distribute, mask):
    """``PSA._expand`` (and the distribute transpose) equals the scatter,
    the full 2h − 1 window and one smaller than the grid."""
    rng = np.random.RandomState(3)
    y = rng.randn(2, mask[0] * mask[1], 5, 5)
    psa = PSA(64, 8, feature_hw=(9, 9), mask_h=mask[0], mask_w=mask[1])
    a = psa._expand(torch.from_numpy(y), psa.mask_index)
    if distribute:
        a = a.transpose(1, 2)
    np.testing.assert_array_equal(a.numpy(),
                                  _scatter(y, *mask, distribute))


def test_feature_size_rule_raises_in_both_packages(small):
    """At 713² layer4 is 90², and (90 − 1) % 2 != 0: PSANet at
    shrink_factor 2 refuses it in both packages (JAX at its first call,
    the port when built); 705² (89²) is the nearest size below that
    passes."""
    with pytest.raises(ValueError, match="shrink_factor"):
        PSANet(19, image_hw=(713, 713))
    # 73²: the reduced backbone's layer4 at 10²
    with pytest.raises(AssertionError, match="shrink_factor"):
        jax.eval_shape(lambda: jax_psp.PSANet(classes=5).init(
            {"params": jax.random.key(0)}, jnp.zeros((1, 73, 73, 3)), False,
            None, None))
    model = PSANet(19, image_hw=(705, 705))
    assert model.psa.hw == (45, 45) and model.psa.mask == (89, 89)
    assert tuple(model.psa.attention[3].weight.shape) == (7921, 512, 1, 1)
    assert tuple(model.psa.mask_index.shape) == (2025, 2025)
    assert "psa.mask_index" not in model.state_dict()
