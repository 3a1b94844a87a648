"""ResNet-50-IBN-b of the port against the JAX package's on the CPU, at
every SelfNorm pos (test_torch_resnet_ibn.py's checks), and one ``cn``
step of CNSN at pos 'post', where the blocks with a post-add
InstanceNorm keep no CNSN site: JAX's site mask and draws fed in, so the
port's sites must be JAX's, in JAX's order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.models.resnet_ibn import ResNetIBN as JaxResNetIBN
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.nn import InstanceNorm
from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_consistency import _jax_state
from test_torch_resnet_ibn import (BOUNDS, IMAGE, LOGIT_BOUND, POSITIONS,
                                   _worst, ibn_sgd_case)
from test_torch_wideresnet import _find_trace, _np64


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, torch's default
    pool (a thread a core in each worker) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pos", POSITIONS)
def test_ibn_b_eval_logits_and_sgd_step_match_jax(pos):
    """IBN-b (an InstanceNorm stem; IN after the add of the last block of
    stages 1–2, which then keep no CNSN at pos 'post'): eval logits within
    LOGIT_BOUND, one SGD step within BOUNDS; JAX's trees load back strictly."""
    logit_err, errs, ts, want = ibn_sgd_case("b", pos)
    assert logit_err <= LOGIT_BOUND
    assert all(e <= b for e, b in zip(errs, BOUNDS)), errs
    sd = state_dict_from_jax(*want[:2])
    assert {"bn1.weight", "layer1.0.IN.bias", "layer2.0.IN.weight"} <= set(sd)
    assert "bn1.running_mean" not in sd
    ts.model.load_state_dict(sd, strict=True)
    model = ts.model
    assert isinstance(model.bn1, InstanceNorm)
    assert [b.IN is not None for layer in (model.layer1, model.layer2,
                                           model.layer3, model.layer4)
            for b in layer] == [True, True, False, False]
    assert [b.cnsn is not None for layer in (model.layer1, model.layer2,
                                             model.layer3, model.layer4)
            for b in layer] == ([False, False, True, True] if pos == "post"
                                else [True] * 4)


def test_ibn_b_cn_step_keeps_jax_sites(monkeypatch):
    """CNSN at pos 'post' on IBN-b at layers (1, 1, 1, 1) and 128² (the
    box sampler needs planes of 4² or more): the first two stages' blocks
    are their last and lose their site (cn_num 2, not 4, as in JAX); one
    ``cn`` step with 1 of the 2 sites on, crop 'both', in float64, JAX's
    mask and draws fed in: loss within 1e-10 and the state within 1e-6."""
    draws = JaxDraws(monkeypatch)
    layers = (1, 1, 1, 1)
    kw = dict(layers=layers, num_classes=10, pos="post", cnsn_type="cnsn",
              crop="both")
    port = build_model("resnet50_ibn_b", generator=torch.Generator(), **kw)
    jax_model = JaxResNetIBN(ibn_cfg=("b", "b", None, None), stem="conv",
                             **kw)
    assert port.cn_num == jax_model.cn_num == 2
    rng = np.random.RandomState(12)
    images = rng.randn(4, 2 * IMAGE, 2 * IMAGE, 3)
    labels = rng.randint(0, 10, 4)
    lr = (0.05, 4)
    with jax.enable_x64(True):
        tx = make_sgd(jax_schedules.cosine_lr(*lr))
        state, init = _jax_state(jax_model, port, images.shape, tx)
        new, metrics = draws.jit(JaxStepFns(jax_model, active_num=1)._cn)(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(4))
        want = (_np64(new.params), _np64(new.batch_stats),
                _np64(_find_trace(new.opt_state)))
        want_loss = float(metrics["loss"])
    mask = draws.mask()
    assert sum(mask) == 1
    port.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(port.double(), cosine_lr(*lr), device="cpu")
    ts, got = StepFns(active_num=1).cn(
        ts, torch.from_numpy(images), torch.from_numpy(labels), mask=mask,
        draws=draws.sites("both"))
    opt = ts.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in ts.model.named_parameters()}
    errs = (abs(float(got["loss"]) - want_loss) / abs(want_loss),
            _worst(ts.model.state_dict(), state_dict_from_jax(*want[:2])),
            _worst(momentum, state_dict_from_jax(want[2], {})))
    assert all(e <= b for e, b in zip(errs, BOUNDS)), errs
