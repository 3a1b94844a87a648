"""The port's PSPNet and PSALite (cnsn_tpu_torch.segmentation.pspnet: PPM,
ClsHead, PSPNet, PSALite, psa_mask_indices) and ``vis.py`` against the
JAX package's, on the CPU, in float64.

Both packages' ``pspnet.seg_resnet50`` is replaced by a backbone of layers
(1, 1, 1, 1) (this file only), at the GTAV recipe's CNSN knobs, 5 classes,
65² images (layer4 at 9²).  A JAX model is initialised, its parameters
and statistics made random (fp32 numbers), and carried into the port by
``state_dict_from_jax`` (the heads' names through ``SEG_KEY_MAP``); the
port's state dict goes back through ``convert_state_dict`` unchanged.
JAX's eval logits (upsampled and at stride 8), its train-mode logits and
its updated BatchNorm statistics come from one compiled program a model;
the heads' dropout is 0 (JAX draws its mask from its own key).  The JAX
modules' float32 casts are read as float64 (``patch_psp_float64``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.segmentation.pspnet as jax_psp
import cnsn_tpu.segmentation.vis as jax_vis
from cnsn_tpu.segmentation import SegResNet as JaxSegResNet
import cnsn_tpu_torch.segmentation.pspnet as port_psp
from cnsn_tpu_torch.segmentation import PPM, PSALite, PSPNet, SegResNet, vis
from cnsn_tpu_torch.segmentation.fcn import ClsHead
from cnsn_tpu_torch.utils.jax_params import (PSP_KEY_MAP, SEG_KEY_MAP,
                                             state_dict_from_jax)
from test_torch_seg_models import _perturb, _port, _round_trip, _worst
from test_torch_seg_ops import _JnpFloat64, patch_jax_float64
from test_torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-10  # of each tensor's max-abs: float64, other summation orders
SIZE = 65
LAYERS = (1, 1, 1, 1)
KW = dict(classes=5, block_idxs="1_2_3_4", pos="residual", cn_pos="post",
          cnsn_type="cnsn", crop="style", dropout=0.0)


def patch_psp_float64(monkeypatch):
    """The JAX seg modules' float32 casts as float64 casts
    (``test_torch_seg_ops.patch_jax_float64``, and ``pspnet.py``'s)."""
    patch_jax_float64(monkeypatch)
    monkeypatch.setattr(jax_psp, "jnp", _JnpFloat64())


def reduce_depth(monkeypatch):
    """Both packages' PSP/PSA backbones at layers (1, 1, 1, 1)."""
    monkeypatch.setattr(jax_psp, "seg_resnet50",
                        lambda **kw: JaxSegResNet(layers=LAYERS, **kw))
    monkeypatch.setattr(port_psp, "seg_resnet50",
                        lambda **kw: SegResNet(layers=LAYERS, **kw))


def _init_tree(variables, rng):
    """JAX's initial kernels with random norm affines, biases and running
    statistics (``test_torch_seg_models._perturb``)."""
    return (_perturb(dict(variables["params"]), rng, False),
            _perturb(dict(variables.get("batch_stats", {})), rng, True))


def init_jit(jm, shape, rng):
    """``test_torch_seg_models._init`` with JAX's init compiled (op by
    op, the PPM's 50 pooled cells alone take seconds each)."""
    v = jax.jit(lambda: jm.init({"params": jax.random.key(0),
                                 "crossnorm": jax.random.key(1)},
                                jnp.zeros(shape), False, None, None))()
    return _init_tree(v, rng)


def jax_outputs(jm, x, rng):
    """JAX's model with random weights and statistics at ``x``: eval
    logits at stride 8 and upsampled (the model's own upsampling,
    ``_resize_align_corners``, applied to them), train-mode logits
    (upsampled) and the statistics after that forward, from one compiled
    program."""
    params, stats = init_jit(jm, x.shape, rng)

    @jax.jit
    def run(p, s, xx):
        v = {"params": p, "batch_stats": s}
        low = jm.apply(v, xx, False, None, None, upsample=False)
        ev = tuple(jax_psp._resize_align_corners(z, xx.shape[1:3])
                   for z in low)
        tr, mut = jm.apply(v, xx, True, None, None, mutable=["batch_stats"])
        return ev, low, tr, mut["batch_stats"]

    out = jax.tree.map(np.asarray, run(params, stats, jnp.asarray(x)))
    return dict(x=x, params=params, stats=stats, eval=out[0], low=out[1],
                train=out[2], new_stats=out[3])


def check_model(model, ref, n_bn):
    """The port's model against ``jax_outputs``: eval and train logits
    within TOL of each one's max-abs, every running statistic after the
    train forward within 1e-6 (fp32 carry), and the weights carried
    back."""
    model = _port(model, ref["params"], ref["stats"])
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        got = model.eval()(x) + model(x, upsample=False)
    for g, w in zip(got, ref["eval"] + ref["low"]):
        assert tuple(g.shape) == w.shape
        assert _worst(g.numpy(), w) <= TOL
    assert got[0].shape == (2, SIZE, SIZE, 5)
    assert got[2].shape == (2, 9, 9, 5)
    _round_trip(model, ref["params"], ref["stats"])
    with torch.no_grad():
        got = model.train()(x)
    for g, w in zip(got, ref["train"]):
        assert _worst(g.numpy(), w) <= TOL
    want = state_dict_from_jax({}, ref["new_stats"], SEG_KEY_MAP)
    sd = model.state_dict()
    assert len(want) == 2 * n_bn
    for k, w in want.items():
        assert _worst(sd[k].numpy(), w.numpy()) <= 1e-6, k


@pytest.fixture
def small(monkeypatch):
    reduce_depth(monkeypatch)
    patch_psp_float64(monkeypatch)
    with jax.enable_x64(True):
        yield np.random.RandomState(0)


def _images(rng):
    return rng.randn(2, SIZE, SIZE, 3) * 1.2 + 0.2


# BatchNorms with running statistics: 17 in the backbone (stem, 4 × 3,
# 4 downsamples), 4 SelfNorm BatchNorm1d, and the heads' own
BACKBONE_BN = 17 + 4


def test_pspnet_matches_jax(small):
    x = _images(small)
    ref = jax_outputs(jax_psp.PSPNet(**KW), x, small)
    model = PSPNet(**KW)
    assert (model.cn_num, model.has_img_cn) == (4, False)
    check_model(model, ref, BACKBONE_BN + 4 + 2)


def test_psalite_matches_jax(small):
    x = _images(small)
    ref = jax_outputs(jax_psp.PSALite(**KW), x, small)
    model = PSALite(image_hw=(SIZE, SIZE), **KW)
    assert model.grid == 9 and model.psa_attn.weight.shape[0] == 81
    check_model(model, ref, BACKBONE_BN + 1 + 2)


def test_psalite_grid_at_the_recipe_size():
    """At 713² (layer4 at 90²) the grid is the 15×15 JAX pools to."""
    model = PSALite(19, image_hw=(713, 713))
    assert model.grid == 15 and model.feature_hw == (90, 90)
    assert tuple(model.psa_attn.weight.shape) == (225, 512, 1, 1)
    assert tuple(model.cls[0].weight.shape) == (512, 2560, 3, 3)


def _module_map(prefix):
    return {k[len(prefix):]: v[len(prefix):] for k, v in PSP_KEY_MAP.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("train", [False, True])
def test_ppm_matches_jax(train, small):
    """PPM alone at 9² × 64 → 4 bins of 16: the concatenated output, and
    in train mode the bins' statistics."""
    x = small.randn(2, 9, 9, 64) + 0.3
    jm = jax_psp.PPM(16)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros(x.shape), False)
    params, stats = _init_tree(v, small)
    got_j = jm.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x), train, mutable=["batch_stats"])
    want, new = jax.tree.map(np.asarray, got_j)
    key_map = _module_map("ppm.")
    port = PPM(64, 16)
    port.load_state_dict(state_dict_from_jax(params, stats, key_map),
                         strict=True)
    port.double().train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 64 + 4 * 16, 9, 9)
    assert _worst(got.permute(0, 2, 3, 1).numpy(), want) <= TOL
    if train:
        sd = port.state_dict()
        for k, w in state_dict_from_jax({}, new["batch_stats"],
                                        key_map).items():
            assert _worst(sd[k].numpy(), w.numpy()) <= 1e-6, k


@pytest.mark.parametrize("train", [False, True])
def test_cls_head_matches_jax(train, small):
    """_ClsHead (3×3 conv 32 → 8, BN, ReLU, dropout 0, 1×1 conv with bias
    → 5) against the port's ClsHead."""
    x = small.randn(2, 7, 7, 32)
    jm = jax_psp._ClsHead(8, 5, 0.0)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros(x.shape), False)
    params, stats = _init_tree(v, small)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train,
                               mutable=["batch_stats"])[0])
    port = ClsHead(32, 8, 5, dropout=0.0)
    port.load_state_dict(state_dict_from_jax(params, stats,
                                             _module_map("cls.")),
                         strict=True)
    port.double().train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _worst(got.permute(0, 2, 3, 1).numpy(), want) <= TOL


def test_state_dict_keys_are_the_references():
    model = PSPNet(19, block_idxs="1_2_3_4", pos="residual", cn_pos="post",
                   cnsn_type="cnsn", crop="style",
                   generator=torch.Generator())
    keys = set(model.state_dict())
    for k in ("ppm.features.0.1.weight", "ppm.features.3.2.running_var",
              "cls.0.weight", "cls.1.running_mean", "cls.4.bias",
              "aux.0.weight", "aux.4.weight",
              "backbone.layer4.2.cnsn.selfnorm.g_fc.weight"):
        assert k in keys, k
    assert tuple(model.cls[0].weight.shape) == (512, 4096, 3, 3)
    assert tuple(model.aux[0].weight.shape) == (256, 1024, 3, 3)
    assert tuple(model.ppm.features[2][1].weight.shape) == (512, 2048, 1, 1)
    assert model.ppm.features[3][0].output_size == 6
    # 'psp' dilation: every 3×3 of layer3 at 2, of layer4 at 4
    assert model.backbone.layer3[0].conv2.dilation == 2
    assert model.backbone.layer4[0].conv2.dilation == 4
    assert model.cn_num == 16 and model.UPSAMPLE_ALIGN_CORNERS


def test_resize_align_corners_matches_jax(small):
    """F.interpolate(align_corners=True) against JAX's linspace gather, in
    float64, at the recipe's upsampling (90 → 713), PSA's round trip
    (89 → 45 → 89) and the PPM's (1, 2, 3, 6 → 90)."""
    for src, dst in ((90, 713), (45, 89), (89, 45), (1, 90), (2, 90),
                     (3, 90), (6, 90)):
        x = small.randn(2, src, src, 3)
        want = np.asarray(jax_psp._resize_align_corners(jnp.asarray(x),
                                                        (dst, dst)))
        got = port_psp._resize_align_corners(
            torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst))
        assert _worst(got.permute(0, 2, 3, 1).numpy(), want) <= TOL, (src,
                                                                     dst)


@pytest.mark.parametrize("h,w,mask_h,mask_w", [
    (5, 5, 9, 9), (5, 5, 3, 3), (4, 6, 7, 11), (6, 4, 5, 3),
    (45, 45, 89, 89)])
def test_psa_mask_indices_equal(h, w, mask_h, mask_w):
    got = port_psp.psa_mask_indices(h, w, mask_h, mask_w)
    want = jax_psp.psa_mask_indices(h, w, mask_h, mask_w)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_mask_window_smaller_than_grid():
    """A 3×3 window on a 5×5 grid (JAX tests/test_segmentation.py:192):
    each position sees at most 9 globals; the centre its full window."""
    idx = port_psp.psa_mask_indices(5, 5, 3, 3)
    sentinel = 9
    assert all((idx[:, p] != sentinel).sum() <= 9 for p in range(25))
    col = idx[:, 12].reshape(5, 5)
    assert col[2, 2] == 4 and (col != sentinel).sum() == 9


def test_vis_equals_jax():
    for name in ("CITYSCAPES_CLASSES", "GTAV_CLASSES"):
        assert getattr(vis, name) == getattr(jax_vis, name)
    for name in ("CITYSCAPES_PALETTE", "GTAV_PALETTE"):
        got, want = getattr(vis, name), getattr(jax_vis, name)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    for ds in ("cityscapes", "GTAV", "gtav"):
        (gn, gp), (wn, wp) = vis.class_metadata(ds), jax_vis.class_metadata(ds)
        assert gn == wn
        np.testing.assert_array_equal(gp, wp)
    with pytest.raises(KeyError):
        vis.class_metadata("ade20k")
    rng = np.random.RandomState(4)
    label = rng.randint(0, 22, (17, 23))
    label[3:6] = 255
    for kw in ({}, dict(ignore_label=0), dict(palette=vis.GTAV_PALETTE[:5])):
        got, want = vis.colorize(label, **kw), jax_vis.colorize(label, **kw)
        assert got.dtype == np.uint8 and got.shape == (17, 23, 3)
        np.testing.assert_array_equal(got, want)
