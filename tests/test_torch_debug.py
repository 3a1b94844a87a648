"""The port's numerics guard (``cnsn_tpu_torch/utils/debug.py::checked``)
against JAX's ``checked`` (checkify's float checks), on the CPU: JAX's
``test_checked_raises_on_nan`` case in both packages; a WRN-10-2 SGD
step that is clean (the wrapped step equal to the unwrapped one bit for
bit) and then has a NaN pixel (raised, the op named); a hand-written
kernel's output, which no op sees, reported through ``WATCHERS``."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.utils.debug import checked as jax_checked
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.ops.kernels._build import WATCHERS, watch
from cnsn_tpu_torch.train import StepFns, create_train_state
from cnsn_tpu_torch.utils.debug import NonFiniteError, checked
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("value,raises", [(2.0, False), (-1.0, True),
                                          (0.0, True)])
def test_checked_raises_on_nan_as_jax(value, raises):
    """log(2) passes, log(−1) (NaN) raises in both; log(0) = −Inf raises
    in the port, which checks Inf too (checkify's float checks do not)."""
    port = checked(lambda x: {"loss": torch.log(x)})
    jf = jax_checked(lambda x: {"loss": jnp.log(x)})
    if not raises:
        assert np.isclose(float(port(torch.tensor(value))["loss"]),
                          np.log(value))
        assert np.isclose(float(jf(jnp.asarray(value))["loss"]),
                          np.log(value))
        return
    with pytest.raises(NonFiniteError, match="aten.log"):
        port(torch.tensor(value))
    if value < 0:
        with pytest.raises(Exception):
            jf(jnp.asarray(value))


def test_step_clean_then_nan():
    model = WideResNet(depth=10, widen_factor=2, num_classes=10,
                       cnsn_type="sn", pos="pre",
                       generator=torch.Generator().manual_seed(0))
    states = [create_train_state(m, lambda s: 0.1, device="cpu")
              for m in (model, copy.deepcopy(model))]
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(8, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, 8))
    steps = StepFns()
    _, want = steps.plain(states[0], images, labels)
    _, got = checked(steps.plain)(states[1], images, labels)
    assert torch.equal(got["loss"], want["loss"])
    sd = states[1].model.state_dict()
    for k, v in states[0].model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    images[3, 5, 7, 1] = float("nan")
    with pytest.raises(NonFiniteError) as err:
        checked(steps.plain)(states[1], images, labels)
    assert err.value.op.startswith("aten.")
    assert WATCHERS == []


def test_kernel_outputs_are_checked():
    """A kernel's output is seen only through its wrapper's ``watch``
    (here an Inf that no op made)."""
    written = torch.tensor([1.0, float("inf")])

    def step(x):
        watch("bn_sums", written)
        return x * 2

    assert torch.equal(checked(lambda x: x * 2)(torch.ones(3)),
                       torch.full((3,), 2.0))
    with pytest.raises(NonFiniteError, match=r"bn_sums \(hand-written"):
        checked(step)(torch.ones(3))
    assert WATCHERS == []
