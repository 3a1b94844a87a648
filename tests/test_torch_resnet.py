"""Port ResNet (cnsn_tpu_torch.models) against the JAX ResNet, eval mode.

A JAX ResNet is initialised (its default S2D stem is algebraically the
port's plain 7×7/s2 stem on the same parameter), its BN affine and
running statistics are made random and non-trivial, and the trees are
carried into the port with ``state_dict_from_jax``.  Both run the same
NHWC images, in fp32 and with bf16 compute.

XLA on the CPU computes a bf16 convolution in fp32 and, by default, may
skip rounding its output to bf16 ("excess precision").  The bf16 JAX
forwards here are compiled with ``xla_allow_excess_precision`` off, so
they round wherever the model casts to bf16, as the port does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.models.resnet import Bottleneck as JaxBottleneck
from cnsn_tpu.models.resnet import ResNet as JaxResNet
from cnsn_tpu.models.resnet import resnet50 as jax_resnet50
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.resnet import Bottleneck, ResNet, resnet50
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax


def _perturb(tree, rng, stats):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturb(dict(v), rng, stats)
            continue
        v = np.asarray(v, np.float32)
        if stats and k == "var":
            v = rng.uniform(0.5, 2.0, v.shape)
        elif stats:
            v = rng.randn(*v.shape) * 0.1
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k == "bias":
            v = rng.randn(*v.shape) * 0.1
        out[k] = np.asarray(v, np.float32)
    return out


def _apply_rounding_bf16(module, params, stats, x):
    """``module``'s eval forward, compiled to round at every bf16 cast."""
    fn = jax.jit(lambda p, s, x: module.apply(
        {"params": p, "batch_stats": s}, x, False, None))
    compiled = fn.lower(params, stats, x).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(params, stats, x).astype(jnp.float32))


def _same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if hasattr(a[k], "items"):
            _same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("pos,cnsn_type,dtype", [
    ("residual", "sn", "float32"), ("pre", "sn", "float32"),
    ("post", "sn", "float32"), ("identity", "sn", "float32"),
    (None, None, "float32"), ("post", "sn", "bfloat16")])
def test_eval_logits_match_jax(pos, cnsn_type, dtype):
    """Eval logits of a full-width ResNet(layers=(1,1,1,1)) at 64²; then
    the port's state_dict converts back into the JAX tree exactly."""
    rng = np.random.RandomState(0)
    kw = dict(layers=(1, 1, 1, 1), num_classes=10, pos=pos,
              cnsn_type=cnsn_type)
    jm = JaxResNet(**kw)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), False, None)
    params = _perturb(dict(v["params"]), rng, stats=False)
    stats = _perturb(dict(v["batch_stats"]), rng, stats=True)
    bf16 = dtype == "bfloat16"
    if bf16:
        want = _apply_rounding_bf16(JaxResNet(**kw, dtype=jnp.bfloat16),
                                    params, stats, jnp.asarray(x))
    else:
        want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), False, None))

    tm = ResNet(**kw, dtype=torch.bfloat16 if bf16 else None)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (2, 10) and got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    scale = np.abs(want).max()
    if bf16:
        # The logits are bf16: one ulp at the largest is 2^(e-7) for
        # 2^e <= scale.  Two bf16 forwards that round at the same places
        # still part by an ulp or two here (a last-bit difference in one
        # conv sum flips a rounding, and 17 layers carry it on), which is
        # also how far the fp32 forward lies from either.  So this case
        # bounds faults of the bf16 path at 4 ulps; where the casts fall
        # is held bit for bit by test_bottleneck_bf16_rounds_where_jax_does.
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)
    else:
        # fp32 through 17 convs: the frameworks' conv algorithms sum in
        # other orders, ~1e-6 relative per layer; held to 1e-4 of the
        # logit scale.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)

    zeros = jax.tree.map(np.zeros_like, (params, stats))
    p2, s2, missing = convert_state_dict(tm.state_dict(), *zeros,
                                         strict=True)
    assert missing == []
    _same_tree(p2, params)
    _same_tree(s2, stats)


@pytest.mark.parametrize("inplanes,planes,stride", [(64, 64, 1),
                                                    (256, 128, 2)])
def test_bottleneck_bf16_rounds_where_jax_does(inplanes, planes, stride):
    """One bf16 bottleneck (with its downsample branch) on the same bf16
    input: the port casts where the JAX block does (conv outputs, BN
    computed in fp32 and rounded once, the residual add), so nearly every
    output element is bit-equal.  A cast in another place (BN in bf16, a
    conv or BN output left in fp32) makes 28-52% of them differ; a
    last-bit difference in a conv sum flips about 0.2%.  Plain blocks
    (no SelfNorm): the SelfNorm gate's bf16 rounding is held against the
    Pallas kernel in tests/test_torch_ops.py."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 14, 14, inplanes).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kw = dict(pos=None, cnsn_type=None, stride=stride, has_downsample=True)
    jm = JaxBottleneck(inplanes, planes, crop="neither", beta=1.0,
                       dtype=jnp.bfloat16, **kw)
    v = jm.init({"params": jax.random.key(0)}, xb, False, None)
    params = _perturb(dict(v["params"]), rng, stats=False)
    stats = _perturb(dict(v["batch_stats"]), rng, stats=True)
    want = _apply_rounding_bf16(jm, params, stats, xb)

    tm = Bottleneck(inplanes, planes, dtype=torch.bfloat16, **kw)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    assert np.mean(got != want) <= 0.01


def test_resnet50_state_dict_keys_and_shapes_match_jax():
    """The full (3,4,6,3) SN-post ResNet-50: the JAX tree (shapes only,
    no compute) converts to exactly the port's state_dict keys and
    shapes, and the port's state_dict loads into the JAX tree with no
    key missing."""
    jm = jax_resnet50(num_classes=1000, pos="post", cnsn_type="sn")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 224, 224, 3)),
        False, None))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         (dict(shapes["params"]),
                          dict(shapes["batch_stats"])))
    carried = state_dict_from_jax(*zeros)
    port = resnet50(num_classes=1000, pos="post", cnsn_type="sn")
    port_sd = port.state_dict()
    assert ({k: tuple(t.shape) for k, t in carried.items()}
            == {k: tuple(t.shape) for k, t in port_sd.items()})
    assert sum(k.endswith("g_fc.weight") for k in port_sd) == 16
    _, _, missing = convert_state_dict(port_sd, *zeros, strict=True)
    assert missing == []


def test_build_model_names():
    assert isinstance(build_model("resnet50", 10, layers=None), ResNet)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model("allconv", 10)
    with pytest.raises(ValueError, match="unknown model"):
        build_model("vgg", 10)


def test_bf16_compute_keeps_fp32_params():
    m = ResNet(layers=(1, 1, 1, 1), num_classes=4, pos="post",
               cnsn_type="sn", dtype=torch.bfloat16).eval()
    with torch.no_grad():
        y = m(torch.randn(2, 32, 32, 3))
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    assert all(p.dtype == torch.float32 for p in m.parameters())
