"""The port's segmentation losses, upsampling, metrics and optimizer
(cnsn_tpu_torch.segmentation: upsample.py, train_seg.py) against the JAX
package's, on the CPU, in float64.

The JAX segmentation modules cast the logits to float32 whatever their
type (``upsample.py:56``, ``train_seg.py:40``, ``fcn.py:105``); the port
keeps at least float32, so float64 logits stay float64.  To hold the two
in float64, the JAX side runs with those modules' ``jnp.float32`` read as
float64 (``jax_float64``, a test-only proxy of the modules' ``jnp``); the
interpolation matrices stay the JAX package's float32 values on both
sides.  The fixture is shared with the other seg test files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cnsn_tpu.segmentation.fcn as jax_fcn
import cnsn_tpu.segmentation.train_seg as jax_train_seg
import cnsn_tpu.segmentation.upsample as jax_upsample
from cnsn_tpu.train.schedules import poly_lr as jax_poly_lr
import cnsn_tpu_torch.segmentation.fcn as port_fcn
from cnsn_tpu_torch.segmentation import SegResNet, fcn_cnsn
from cnsn_tpu_torch.segmentation import train_seg, upsample
from cnsn_tpu_torch.segmentation.train_seg import (HEAD_PREFIXES,
                                                   make_seg_optimizer)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-10  # float64, the same operations in other orders


class _JnpFloat64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def patch_jax_float64(monkeypatch):
    """Make the JAX seg modules' fixed float32 casts float64 casts."""
    for mod in (jax_upsample, jax_train_seg, jax_fcn):
        monkeypatch.setattr(mod, "jnp", _JnpFloat64())


@pytest.fixture
def jax_float64(monkeypatch):
    patch_jax_float64(monkeypatch)
    with jax.enable_x64(True):
        yield


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("out_size,in_size", [(33, 5), (65, 9), (713, 90),
                                              (8, 8), (97, 13)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_bilinear_matrix_bit_equal(out_size, in_size, align_corners):
    got = upsample.bilinear_matrix(out_size, in_size, align_corners)
    want = jax_upsample.bilinear_matrix(out_size, in_size, align_corners)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bilinear_matrix_refuses_downscale():
    with pytest.raises(ValueError, match="upscale only"):
        upsample.bilinear_matrix(4, 9)


def _logits_labels(seed, b=2, h=5, w=7, out=(33, 41), k=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, h, w, k) * 3
    labels = rng.randint(0, k, (b,) + out)
    labels[0, :3] = 255
    labels[-1, :, :2] = 255
    return logits, labels


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_upsample_nll_sum_and_argmax_match_jax(jax_float64, align_corners,
                                               seed):
    """upsample_nll_sum's (sum, count) within 1e-10, its gradient with
    respect to the logits too, and upsample_argmax equal."""
    logits, labels = _logits_labels(seed)
    want_s, want_n = jax_upsample.upsample_nll_sum(
        jnp.asarray(logits), jnp.asarray(labels), 255, align_corners)
    want_g = jax.grad(lambda z: jax_upsample.upsample_nll_sum(
        z, jnp.asarray(labels), 255, align_corners)[0])(jnp.asarray(logits))
    want_p = jax_upsample.upsample_argmax(jnp.asarray(logits), *labels.shape[1:],
                                          align_corners)
    z = torch.from_numpy(logits).requires_grad_()
    s, n = upsample.upsample_nll_sum(z, torch.from_numpy(labels), 255,
                                     align_corners)
    s.backward()
    assert s.dtype == torch.float64 and int(n) == int(want_n)
    _close(float(s.detach()), float(want_s))
    _close(z.grad.numpy(), np.asarray(want_g))
    pred = upsample.upsample_argmax(torch.from_numpy(logits),
                                    *labels.shape[1:], align_corners)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("seed,hw,out", [(0, (9, 6), (72, 48)),
                                         (1, (5, 5), (40, 40)),
                                         (2, (12, 7), (96, 56))])
def test_matmul_ce_equals_resize_ce(seed, hw, out):
    """The class-major fused CE equals the masked CE of the logits
    upsampled by F.interpolate, within 1e-10, and so do the argmaxes, at
    8× (the heads' stride), where the interpolation weights are dyadic:
    the matrices hold the JAX package's float32 weights, which elsewhere
    are F.interpolate's float64 ones rounded (the next test)."""
    logits, labels = _logits_labels(seed, h=hw[0], w=hw[1], out=out)
    z = torch.from_numpy(logits)
    lab = torch.from_numpy(labels)
    s, n = upsample.upsample_nll_sum(z, lab)
    up = F.interpolate(z.permute(0, 3, 1, 2), size=labels.shape[1:],
                       mode="bilinear", align_corners=False)
    s2, n2 = train_seg.masked_nll_sum(up.permute(0, 2, 3, 1), lab)
    assert int(n) == int(n2)
    _close(float(s), float(s2))
    np.testing.assert_array_equal(
        upsample.upsample_argmax(z, *labels.shape[1:]).numpy(),
        up.argmax(dim=1).numpy())


def test_matmul_ce_against_resize_ce_at_the_recipe_shape():
    """At 713² from 90² the weights are not dyadic: the two losses differ
    by no more than the float32 rounding of the weights (2^-24 of each,
    a few logits' worth) allows."""
    logits, labels = _logits_labels(4, b=1, h=90, w=90, out=(713, 713),
                                    k=19)
    z = torch.from_numpy(logits)
    lab = torch.from_numpy(labels)
    s, _ = upsample.upsample_nll_sum(z, lab)
    up = F.interpolate(z.permute(0, 3, 1, 2), size=(713, 713),
                       mode="bilinear", align_corners=False)
    s2, _ = train_seg.masked_nll_sum(up.permute(0, 2, 3, 1), lab)
    bound = 4 * 2.0 ** -24 * float(z.abs().max()) * int((lab != 255).sum())
    assert abs(float(s) - float(s2)) <= bound


@pytest.mark.parametrize("shape,size", [((2, 5, 5, 19), (33, 33)),
                                        ((1, 9, 7, 3), (65, 50)),
                                        ((2, 90, 90, 4), (713, 713))])
def test_interpolate_equals_jax_image_resize_upscaling(shape, size):
    """The eval upsample, F.interpolate(bilinear, align_corners=False), is
    jax.image.resize('bilinear') when upscaling (float64)."""
    x = np.random.RandomState(3).randn(*shape)
    with jax.enable_x64(True):
        want = np.asarray(jax.image.resize(
            jnp.asarray(x), (shape[0], *size, shape[3]), "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=size,
                        mode="bilinear", align_corners=False)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_metrics_equal_jax(seed):
    rng = np.random.RandomState(seed)
    k = 19
    pred = rng.randint(0, k, (2, 33, 41))
    target = rng.randint(0, k, (2, 33, 41))
    target[0, :5] = 255
    target[1, 3, :7] = 255
    got = train_seg.seg_metrics(torch.from_numpy(pred),
                                torch.from_numpy(target), k)
    want = jax_train_seg.seg_metrics(jnp.asarray(pred), jnp.asarray(target),
                                     k)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_seg_metrics_ignores_values_outside_the_classes():
    """A target value that is neither a class nor ignore_label counts in
    no histogram, as JAX's one_hot of it is zero."""
    pred = torch.tensor([[0, 1, 2, 3]])
    target = torch.tensor([[0, 7, 2, 255]])
    got = train_seg.seg_metrics(pred, target, 4)
    want = jax_train_seg.seg_metrics(jnp.asarray(pred.numpy()),
                                     jnp.asarray(target.numpy()), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_nll_and_cross_entropy_match_jax(jax_float64, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 9, 11, 6) * 2
    labels = rng.randint(0, 6, (2, 9, 11))
    labels[0, 0] = 255
    ws, wn = jax_train_seg.masked_nll_sum(jnp.asarray(logits),
                                          jnp.asarray(labels))
    wce = jax_train_seg.masked_cross_entropy(jnp.asarray(logits),
                                             jnp.asarray(labels))
    gs, gn = train_seg.masked_nll_sum(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    gce = train_seg.masked_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(labels))
    assert int(gn) == int(wn)
    _close(float(gs), float(ws))
    _close(float(gce), float(wce))


def test_all_ignored_labels_give_zero_loss():
    logits = torch.randn(1, 3, 3, 4, dtype=torch.float64)
    labels = torch.full((1, 3, 3), 255)
    assert float(train_seg.masked_cross_entropy(logits, labels)) == 0.0
    s, n = upsample.upsample_nll_sum(logits, torch.full((1, 9, 9), 255))
    assert float(s) == 0.0 and int(n) == 0


def test_optimizer_head_groups_and_poly_schedule(monkeypatch):
    """The head groups are JAX's ``label_mask`` (the first name component
    among the head prefixes) with lr_scale 10; the schedule is JAX's poly
    at each update count."""
    monkeypatch.setattr(port_fcn, "seg_resnet50",
                        lambda **kw: SegResNet(layers=(1, 1, 1, 1), **kw))
    model = fcn_cnsn(5, generator=torch.Generator())
    opt, sched = make_seg_optimizer(model, 0.01, 40, 0.9, 0.9, 1e-4)
    body, head = opt.param_groups
    assert (body["lr_scale"], head["lr_scale"]) == (1.0, 10.0)
    names = {id(p): n for n, p in model.named_parameters()}
    assert {names[id(p)].split(".")[0] for p in head["params"]} == {
        "classifier", "aux_classifier"}
    assert all(names[id(p)].startswith("backbone.") for p in body["params"])
    assert len(body["params"]) + len(head["params"]) == len(names)
    for g in (body, head):
        assert (g["momentum"], g["weight_decay"], g["nesterov"],
                g["dampening"]) == (0.9, 1e-4, False, 0.0)
    want = jax_poly_lr(0.01, 40, 0.9)
    for s in (0, 1, 7, 39):
        assert abs(sched(s) - float(want(s))) <= 1e-6 * 0.01  # fp32 JAX
    assert "classifier" in HEAD_PREFIXES and "psa_attn" in HEAD_PREFIXES
