"""The port's segmentation models (cnsn_tpu_torch.segmentation: SegResNet,
FCNHead, FCNCNSN) against the JAX package's, on the CPU, in float64.

A JAX model is initialised, its parameters and BatchNorm statistics made
random (fp32 values), and carried into the port with
``state_dict_from_jax`` (the heads' names through ``SEG_KEY_MAP``); the
port's state dict goes back through ``convert_state_dict`` unchanged.
Both run the same NHWC images: the eval forward (SelfNorm through K3's
plain version) and the train forward (batch statistics, SelfNorm through
K1's plain version, the running statistics updated).  The full-depth
FCN-CNSN is compiled once in this file (eval and train outputs of one
program); the variants of the backbone run at layers (1, 1, 1, 1).
The heads' dropout is 0 where the train forward is compared (JAX draws
its mask from its own key); its rate is held on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.segmentation import FCNCNSN as JaxFCNCNSN
from cnsn_tpu.segmentation import SegResNet as JaxSegResNet
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.segmentation import FCNCNSN, SegResNet, fcn_cnsn
from cnsn_tpu_torch.segmentation.fcn import FCNHead
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_seg_ops import patch_jax_float64
from test_torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-10  # of each tensor's max-abs: float64, other summation orders
FULL_SIZE = 65
FCN_KW = dict(classes=5, block_idxs="1_2_3_4", pos="residual",
              cn_pos="post", cnsn_type="cnsn", crop="style", dropout=0.0)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def _perturb(tree, rng, stats):
    """JAX's initial weights (kernels, g_fc) with random norm affines,
    biases and running statistics, fp32 numbers in float64 arrays
    (``state_dict_from_jax`` carries fp32 into the port)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturb(dict(v), rng, stats)
            continue
        a = np.asarray(v, np.float64)
        if stats:
            a = (rng.uniform(0.5, 2.0, a.shape) if k == "var"
                 else rng.randn(*a.shape) * 0.3)
        elif k == "scale":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif k == "bias":
            a = rng.randn(*a.shape) * 0.1
        out[k] = a.astype(np.float32).astype(np.float64)
    return out


def _init(jm, shape, rng):
    v = jm.init({"params": jax.random.key(0),
                 "crossnorm": jax.random.key(1)},
                jnp.zeros(shape), False, None, None)
    return (_perturb(dict(v["params"]), rng, False),
            _perturb(dict(v.get("batch_stats", {})), rng, True))


def _worst(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _port(model, params, stats):
    model.load_state_dict(state_dict_from_jax(params, stats, SEG_KEY_MAP),
                          strict=True)
    return model.double()


def _round_trip(model, params, stats):
    """The port's state dict carried back into the JAX trees equals them."""
    p, s, missing = convert_state_dict(
        model.state_dict(), jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, stats), strict=True, key_map=SEG_KEY_MAP,
        dtype=np.float64)
    assert not missing
    for got, want in ((p, params), (s, stats)):
        jax.tree.map(np.testing.assert_array_equal, got, _np(want))


@pytest.fixture(scope="module")
def full_fcn():
    """The full-depth FCN-CNSN at 65² (layer4 at 9²): JAX's eval logits
    (upsampled and at stride 8), its train-mode logits and updated
    statistics, from one compiled program."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, FULL_SIZE, FULL_SIZE, 3) * 1.2 + 0.2
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        patch_jax_float64(mp)
        jm = JaxFCNCNSN(**FCN_KW)
        params, stats = _init(jm, x.shape, rng)

        @jax.jit
        def run(p, s, xx):
            v = {"params": p, "batch_stats": s}
            ev = jm.apply(v, xx, False, None, None)
            low = jm.apply(v, xx, False, None, None, upsample=False)
            tr, mut = jm.apply(v, xx, True, None, None,
                               mutable=["batch_stats"])
            return ev, low, tr, mut["batch_stats"]

        out = jax.tree.map(np.asarray, run(params, stats, jnp.asarray(x)))
    return dict(x=x, params=params, stats=stats, eval=out[0], low=out[1],
                train=out[2], new_stats=out[3])


def test_full_fcn_cnsn_eval_logits_match_jax(full_fcn):
    model = _port(FCNCNSN(**FCN_KW), full_fcn["params"], full_fcn["stats"])
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(full_fcn["x"])
        got = model(x)
        low = model(x, upsample=False)
    for g, w in zip(got + low, full_fcn["eval"] + full_fcn["low"]):
        assert tuple(g.shape) == w.shape
        assert _worst(g.numpy(), w) <= TOL
    assert got[0].shape == (2, FULL_SIZE, FULL_SIZE, 5)
    assert low[0].shape == (2, 9, 9, 5)
    _round_trip(model, full_fcn["params"], full_fcn["stats"])


def test_full_fcn_cnsn_train_forward_matches_jax(full_fcn):
    """A train-mode forward (no CrossNorm on): the logits, and every
    BatchNorm's and SelfNorm BatchNorm1d's running statistics after it."""
    model = _port(FCNCNSN(**FCN_KW), full_fcn["params"], full_fcn["stats"])
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(full_fcn["x"]))
    for g, w in zip(got, full_fcn["train"]):
        assert _worst(g.numpy(), w) <= TOL
    want = state_dict_from_jax({}, full_fcn["new_stats"], SEG_KEY_MAP)
    sd = model.state_dict()
    assert len(want) == 2 * (53 + 16 + 2)  # 53 + 2 BN, 16 SelfNorm BN1d
    for k, w in want.items():
        assert _worst(sd[k].numpy(), w.numpy()) <= 1e-6, k  # fp32 carry


def test_state_dict_keys_are_the_references():
    model = fcn_cnsn(19, generator=torch.Generator())
    keys = set(model.state_dict())
    for k in ("backbone.conv1.weight", "backbone.bn1.running_var",
              "backbone.layer1.0.conv1.weight",
              "backbone.layer1.0.downsample.0.weight",
              "backbone.layer4.2.cnsn.selfnorm.g_fc.weight",
              "backbone.layer3.5.cnsn.selfnorm.g_bn.running_mean",
              "classifier.0.weight", "classifier.1.running_var",
              "classifier.4.weight", "classifier.4.bias",
              "aux_classifier.0.weight", "aux_classifier.4.bias"):
        assert k in keys, k
    assert model.cn_num == 16 and not model.has_img_cn
    assert tuple(model.classifier[4].weight.shape) == (19, 512, 1, 1)
    assert tuple(model.aux_classifier[0].weight.shape) == (256, 1024, 3, 3)
    assert model.backbone.layer4[0].conv2.dilation == 2
    assert model.backbone.layer4[1].conv2.dilation == 4
    assert model.backbone.layer3[0].conv2.dilation == 1
    assert model.backbone.layer3[1].conv2.dilation == 2


BACKBONES = {
    "cnsn_residual_post": dict(block_idxs="1_2_3_4", pos="residual",
                               cn_pos="post", cnsn_type="cnsn"),
    "sn_post": dict(block_idxs="1_3", pos="post", cn_pos=None,
                    cnsn_type="sn"),
    "cn_slot_residual": dict(block_idxs="1_2", pos="residual", cn_pos=None,
                             cnsn_type="cn"),
    "sn_identity_psp": dict(block_idxs="1_2_3_4", pos="identity",
                            cn_pos=None, cnsn_type="sn",
                            dilation_mode="psp"),
    "img_cn_and_cnsn": dict(block_idxs="0_1_2_3_4", pos="residual",
                            cn_pos="post", cnsn_type="cnsn"),
    "plain": dict(block_idxs="", pos=None, cn_pos=None, cnsn_type=None),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_out_aux_match_jax(name, monkeypatch):
    """SegResNet at layers (1, 1, 1, 1), 41²: out (layer4) and aux
    (layer3) in eval and train mode (CrossNorm off), cn_num and
    has_img_cn, and the weights carried back."""
    kw = dict(BACKBONES[name], crop="style")
    rng = np.random.RandomState(1)
    x = rng.randn(2, 41, 41, 3)
    patch_jax_float64(monkeypatch)
    with jax.enable_x64(True):
        jm = JaxSegResNet(layers=(1, 1, 1, 1), **kw)
        params, stats = _init(jm, x.shape, rng)

        @jax.jit
        def run(p, s, xx):
            v = {"params": p, "batch_stats": s}
            return (jm.apply(v, xx, False, None, None),
                    jm.apply(v, xx, True, None, None,
                             mutable=["batch_stats"])[0])

        want = jax.tree.map(np.asarray, run(params, stats, jnp.asarray(x)))
    model = _port(SegResNet(layers=(1, 1, 1, 1), **kw), params, stats)
    assert (model.cn_num, model.has_img_cn) == (jm.cn_num,
                                                bool(jm.has_img_cn))
    with torch.no_grad():
        got = (model.eval()(torch.from_numpy(x)),
               model.train()(torch.from_numpy(x)))
    for g, w in zip(got, want):
        for k in ("out", "aux"):
            assert _worst(g[k].numpy(), w[k]) <= TOL, (name, k)
    model.load_state_dict(state_dict_from_jax(params, stats, SEG_KEY_MAP))
    _round_trip(model, params, stats)


def test_remat_raises_naming_its_item():
    """(The name predates remat's port.)  remat builds: True
    rematerialises every stage's bottlenecks, a spec the listed stages
    (JAX's ``remat_stages``; tests/test_torch_remat.py holds the steps)."""
    assert SegResNet(layers=(1, 1, 1, 1), remat=True).remat_stages == {
        1, 2, 3, 4}
    assert SegResNet(layers=(1, 1, 1, 1), remat="1_2").remat_stages == {1, 2}


def test_head_dropout_rate_and_eval_identity():
    """FCNHead's Dropout(0.1): in train mode a tenth of the features is
    zeroed and the rest scaled by 1/0.9 before the classifier; in eval
    it is the identity.  The default rate is JAX's."""
    assert JaxFCNCNSN().dropout == 0.1
    head = FCNHead(64, 3, generator=torch.Generator().manual_seed(0))
    drop = head[3]
    assert drop.p == 0.1
    torch.manual_seed(0)
    x = torch.ones(4, 16, 32, 32)
    y = drop.train()(x)
    zero = float((y == 0).double().mean())
    assert abs(zero - 0.1) < 0.01
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert torch.equal(drop.eval()(x), x)
    head.eval()
    z = torch.randn(2, 64, 6, 6).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(head(z), head(z))
