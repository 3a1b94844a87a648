"""Torch-checkpoint importer tests: conv/linear/BN mapping semantics via
a mini golden model, and key coverage on a real model tree."""
import numpy as np
import jax
import jax.numpy as jnp
import torch
import torch.nn as tnn
from flax import linen as nn

from cnsn_tpu.models import build_model
from cnsn_tpu.nn.norm import BatchNorm
from cnsn_tpu.utils.torch_import import convert_state_dict
from test_torch_threads import one_thread  # noqa: F401 (autouse)


class MiniTorch(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 8, 3, stride=2, padding=1, bias=False)
        self.bn1 = tnn.BatchNorm2d(8)
        self.fc = tnn.Linear(8, 5)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = x.mean(dim=(2, 3))
        return self.fc(x)


class MiniFlax(nn.Module):
    @nn.compact
    def __call__(self, x, train=False, cn_active=None):
        x = nn.Conv(8, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                    use_bias=False, name="conv1")(x)
        x = nn.relu(BatchNorm(8, name="bn1")(x, True))
        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(5, name="fc")(x)


def test_mini_golden_logits_match():
    tmodel = MiniTorch().eval()
    # perturb BN running stats so eval actually uses them
    with torch.no_grad():
        tmodel.bn1.running_mean.normal_()
        tmodel.bn1.running_var.uniform_(0.5, 2.0)

    fmodel = MiniFlax()
    x = np.random.RandomState(0).randn(4, 16, 16, 3).astype(np.float32)
    variables = fmodel.init(jax.random.key(0), jnp.asarray(x))
    params, stats, missing = convert_state_dict(
        tmodel.state_dict(), dict(variables["params"]),
        dict(variables["batch_stats"]), strict=True)
    assert not missing

    t_out = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2))).detach().numpy()
    f_out = fmodel.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x))
    np.testing.assert_allclose(t_out, np.asarray(f_out), rtol=1e-4, atol=1e-5)


def test_resnet50_key_coverage():
    """A synthetic torchvision-style resnet50 state_dict maps fully onto
    our tree (all keys consumed, none missing)."""
    model = build_model("resnet50", num_classes=1000)
    variables = model.init({"params": jax.random.key(0)},
                           jnp.zeros((1, 64, 64, 3)), False, None)

    # Build the torch-style key list from our own tree structure.
    sd = {}

    def conv(name, kern):
        kh, kw, i, o = kern.shape
        sd[name + ".weight"] = torch.zeros(o, i, kh, kw)

    def bn(name, scale):
        c = scale.shape[0]
        sd[name + ".weight"] = torch.ones(c)
        sd[name + ".bias"] = torch.zeros(c)
        sd[name + ".running_mean"] = torch.zeros(c)
        sd[name + ".running_var"] = torch.ones(c)
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    p = variables["params"]
    conv("conv1", p["conv1"]["kernel"])
    bn("bn1", p["bn1"]["scale"])
    for s, blocks in zip(range(1, 5), (3, 4, 6, 3)):
        for i in range(blocks):
            blk = p[f"layer{s}_{i}"]
            for c in ("conv1", "conv2", "conv3"):
                conv(f"layer{s}.{i}.{c}", blk[c]["kernel"])
            for b in ("bn1", "bn2", "bn3"):
                bn(f"layer{s}.{i}.{b}", blk[b]["scale"])
            if "downsample_conv" in blk:
                conv(f"layer{s}.{i}.downsample.0",
                     blk["downsample_conv"]["kernel"])
                bn(f"layer{s}.{i}.downsample.1",
                   blk["downsample_bn"]["scale"])
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)

    params, stats, missing = convert_state_dict(
        sd, dict(variables["params"]), dict(variables["batch_stats"]),
        strict=True)
    assert not missing
