"""The port's conv2d_custom_bwd (cnsn_tpu_torch.ops.convdot), K4's plain
version and the CNSN_CONV3X3 model gate, against the JAX package on the
CPU.

Inputs are numpy draws handed to both packages.  JAX's Pallas K4 runs in
interpret mode here (``pallas_dispatch`` on the CPU), as its own tests
run it.  Tolerances are 1e-5 of the largest magnitude in fp32: both
sides sum fp32 products over a few hundred rows in other orders (~1e-7
of that scale), where a flipped, shifted or transposed index is off by
the gradient's whole size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.ops.convdot import conv2d_custom_bwd as jax_conv2d_custom_bwd
from cnsn_tpu.ops.pallas.conv_wgrad import wgrad3x3_pallas, wgrad3x3_tiled
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.common import Conv2d, ConvCustomBwd
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.ops.convdot import conv2d_custom_bwd, routes_to_k4
from cnsn_tpu_torch.ops.kernels import wgrad3x3_reference

REL = 1e-5


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=what)


def _cotangent(shape):
    """Non-uniform, so that flipped or shifted indices cannot cancel
    (``tests/test_convdot.py:10-16``)."""
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float32) / n).reshape(shape)


def _jax_grads(x, k, stride, wgrad, dgrad):
    def loss(x, k):
        y = jax_conv2d_custom_bwd(x, k, stride, 1, wgrad, dgrad)
        return jnp.sum(y * _cotangent(y.shape)), y
    (_, y), (dx, dk) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(jnp.asarray(x),
                                                        jnp.asarray(k))
    return y, dx, dk


def _port_grads(x, k, stride, wgrad, dgrad):
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    y = conv2d_custom_bwd(tx, tk, stride, 1, wgrad, dgrad)
    (y * torch.from_numpy(_cotangent(tuple(y.shape)))).sum().backward()
    return y.detach(), tx.grad, tk.grad


def _inputs(seed, shape=(2, 9, 9, 5), cout=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    k = rng.randn(3, 3, shape[-1], cout).astype(np.float32)
    return x, k


def _compare(x, k, stride, wgrad, dgrad):
    want = _jax_grads(x, k, stride, wgrad, dgrad)
    got = _port_grads(x, k, stride, wgrad, dgrad)
    for g, w, what in zip(got, want, ("y", "dx", "dk")):
        assert tuple(g.shape) == w.shape, what
        _close(g.numpy(), w, what)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("wgrad,dgrad", [("dot", "dot"), ("dot", "auto"),
                                         ("auto", "dot"), ("auto", "auto")])
def test_conv2d_custom_bwd_matches_jax(stride, wgrad, dgrad):
    """Forward, dx and dk in every (wgrad, dgrad) of the dot lowering."""
    _compare(*_inputs(stride), stride, wgrad, dgrad)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("wgrad", ["pallas", "pallas_tiled"])
def test_conv2d_custom_bwd_pallas_modes_match_jax(wgrad, stride,
                                                  monkeypatch):
    """K4's modes: at stride 1 the port's wgrad3x3 (its plain version on
    the CPU) against JAX's Pallas kernels in interpret mode, the tiled
    one forced past its shape gate; at stride 2 both take the library
    gradient."""
    monkeypatch.setenv("CNSN_WGRAD_TILED_FORCE", "1")
    _compare(*_inputs(10 + stride, (4, 8, 8, 4), 6), stride, wgrad, "auto")


@pytest.mark.parametrize("shape,cout", [((3, 10, 12, 8), 16),
                                        ((2, 9, 7, 3), 16)])
def test_wgrad3x3_reference_matches_pallas_kernels(shape, cout):
    """The plain version against both TPU entry points (interpret mode),
    at the shape of tests/test_convdot.py and at Cin=3 (the WRN stem)."""
    rng = np.random.RandomState(shape[-1])
    x = rng.randn(*shape).astype(np.float32)
    dy = rng.randn(*shape[:3], cout).astype(np.float32)
    got = wgrad3x3_reference(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and got.shape == (3, 3, shape[-1], cout)
    for fn in (wgrad3x3_pallas, wgrad3x3_tiled):
        want = fn(jnp.asarray(x), jnp.asarray(dy), 1, interpret=True)
        _close(got.numpy(), want, fn.__name__)
    # float64 is cast to fp32, as the Pallas kernel casts it
    got64 = wgrad3x3_reference(torch.from_numpy(x).double(),
                               torch.from_numpy(dy).double())
    assert got64.dtype == torch.float32 and torch.equal(got64, got)


MODES = ("conv", "dot", "wgrad", "dgrad", "pallas", "pallas_tiled")


@pytest.mark.parametrize("mode", MODES)
def test_conv3x3_model_gate_keeps_state_dict_and_forward(mode, monkeypatch):
    """Every CNSN_CONV3X3 value builds the same parameters and a forward
    bit-identical to the stock conv's, in train and eval mode; the value
    reaches every 3x3 conv as JAX's factory maps it."""
    x = torch.from_numpy(np.random.RandomState(20).randn(
        2, 16, 16, 3).astype(np.float32))

    def run():
        model = WideResNet(depth=16, pos="post", cnsn_type="sn",
                           generator=torch.Generator().manual_seed(0))
        train = model.train()(x)
        with torch.no_grad():
            return model, train, model.eval()(x)

    monkeypatch.setenv("CNSN_CONV3X3", "conv")
    ref, ref_train, ref_eval = run()
    monkeypatch.setenv("CNSN_CONV3X3", mode)
    model, train, evl = run()
    sd, ref_sd = model.state_dict(), ref.state_dict()
    assert list(sd) == list(ref_sd)
    assert all(torch.equal(sd[k], ref_sd[k]) for k in ref_sd)
    assert torch.equal(train, ref_train) and torch.equal(evl, ref_eval)
    convs3 = [m for m in model.modules()
              if isinstance(m, Conv2d) and m.weight.shape[-1] == 3]
    assert len(convs3) == 13  # the stem and two in each of 6 blocks
    want = {"conv": None, "dot": ("dot", "dot"), "wgrad": ("dot", "auto"),
            "dgrad": ("auto", "dot"), "pallas": ("pallas", "auto"),
            "pallas_tiled": ("pallas_tiled", "auto")}[mode]
    for m in convs3:
        if want is None:
            assert type(m) is Conv2d
        else:
            assert isinstance(m, ConvCustomBwd)
            assert (m.wgrad, m.dgrad) == want


def test_conv3x3_model_gate_rejects_unknown_values(monkeypatch):
    monkeypatch.setenv("CNSN_CONV3X3", "palas")
    with pytest.raises(ValueError, match="CNSN_CONV3X3"):
        build_model("wideresnet", 10, cnsn_type="sn", pos="pre")


def _k4_sites(model, image):
    """ConvCustomBwd modules whose weight gradient goes to K4, read from
    the input shapes of one forward at ``image``²."""
    sites = []

    def hook(module, inputs, out):
        _, cin, h, w = inputs[0].shape
        if routes_to_k4(module.wgrad, module.stride, module.weight.shape[2:],
                        h, w, cin, module.weight.shape[0]):
            sites.append(module)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, ConvCustomBwd)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, image, image, 3))
    for h in handles:
        h.remove()
    return len(sites)


@pytest.mark.parametrize("name,image,mode,want", [
    ("wideresnet", 32, "pallas", 35), ("resnet50", 224, "pallas", 13),
    ("resnet50", 224, "pallas_tiled", 2)])
def test_k4_sites_per_model(name, image, mode, want, monkeypatch):
    """WRN-40-2: every 3x3 conv but the two stride-2 transitions (35);
    ResNet-50 v1.5: the 13 stride-1 3x3 convs, 2 of them (layer4, 7x7
    512→512) inside the tiled kernel's shape gate."""
    monkeypatch.delenv("CNSN_WGRAD_TILED_FORCE", raising=False)
    monkeypatch.setenv("CNSN_CONV3X3", mode)
    kw = dict(cnsn_type="sn", pos="pre" if name == "wideresnet" else "post")
    model = build_model(name, 10, generator=torch.Generator().manual_seed(0),
                        **kw)
    assert _k4_sites(model, image) == want
