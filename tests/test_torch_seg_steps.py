"""The port's segmentation SGD steps (cnsn_tpu_torch.segmentation.
SegStepFns.plain and .aug) against JAX's SegStepFns, on the CPU, in
float64, at an FCN-CNSN of layers (1, 1, 1, 1) (the JAX FCN's backbone
factory patched in this file only): two steps from the same weights, a
plain and an aug one in either order, so that the poly schedule's second
value and the 10× head groups both show.  JAX's aug step is compiled with
its draws recorded (the site mask, each site's partner permutation and
style box: ``test_torch_cnsn_sites.JaxDraws``) and fed to the port.
The heads' dropout is 0 here (its rate: ``test_torch_seg_models.py``).
Held: each step's loss and its main and aux parts, the histograms, and
after the second step every parameter and running statistic and every
momentum buffer, at the float64 bounds of tests/test_torch_train.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.segmentation.fcn as jax_fcn
from cnsn_tpu.segmentation import FCNCNSN as JaxFCNCNSN
from cnsn_tpu.segmentation import SegResNet as JaxSegResNet
from cnsn_tpu.segmentation import SegStepFns as JaxSegStepFns
from cnsn_tpu.segmentation import SegTrainState as JaxSegTrainState
from cnsn_tpu.segmentation import make_seg_optimizer as jax_seg_optimizer
import cnsn_tpu_torch.segmentation.fcn as port_fcn
from cnsn_tpu_torch.segmentation import SegResNet, SegStepFns, fcn_cnsn
from cnsn_tpu_torch.segmentation.train_seg import create_seg_train_state
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_seg_models import _init
from test_torch_seg_ops import patch_jax_float64
from test_torch_wideresnet import _find_trace, _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)

LAYERS = (1, 1, 1, 1)
KW = dict(classes=5, block_idxs="1_2_3_4", pos="residual", cn_pos="post",
          cnsn_type="cnsn", crop="style", dropout=0.0)
B, SIZE = 2, 65  # 65² keeps layer4 at 9², big enough for a style box
OPT = dict(base_lr=0.01, max_iter=3, power=0.9, momentum=0.9,
           weight_decay=1e-4)
RUNS = {"matmul": ("plain", "aug"), "resize": ("aug", "plain")}


def _jax_run(monkeypatch, kinds, lowres_ce, rng):
    draws = JaxDraws(monkeypatch)
    patch_jax_float64(monkeypatch)
    monkeypatch.setattr(jax_fcn, "seg_resnet50",
                        lambda **kw: JaxSegResNet(layers=LAYERS, **kw))
    images = rng.randn(len(kinds), B, SIZE, SIZE, 3)
    labels = rng.randint(0, 5, (len(kinds), B, SIZE, SIZE))
    labels[:, :, :4] = 255
    with jax.enable_x64(True):
        jm = JaxFCNCNSN(**KW)
        params, stats = _init(jm, images.shape[1:], rng)
        init = (params, stats)
        tx = jax_seg_optimizer(params, OPT["base_lr"], OPT["max_iter"],
                               OPT["power"], OPT["momentum"],
                               OPT["weight_decay"])
        state = JaxSegTrainState.create(apply_fn=jm.apply, params=params,
                                        batch_stats=stats, tx=tx)
        steps = JaxSegStepFns(jm, num_classes=5, lowres_ce=lowres_ce)
        metrics, fed = [], []
        for i, kind in enumerate(kinds):
            args = (state, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                    jax.random.key(40 + i))
            if kind == "aug":
                state, m = draws.jit(steps._make_step(True))(*args)
                fed.append(dict(mask=draws.mask(),
                                draws=draws.sites(KW["crop"])))
            else:
                state, m = steps.plain(*args)
                fed.append({})
            metrics.append(jax.tree.map(np.asarray, m))
        want = state_dict_from_jax(_np64(state.params),
                                   _np64(state.batch_stats), SEG_KEY_MAP)
        want_m = state_dict_from_jax(_np64(_find_trace(state.opt_state)), {},
                                     SEG_KEY_MAP)
    assert int(state.step) == len(kinds) and jm.cn_num == 4
    return dict(images=images, labels=labels, init=init, metrics=metrics,
                fed=fed, want=want, want_m=want_m)


@pytest.mark.parametrize("mode", sorted(RUNS))
def test_two_steps_match_jax(mode, monkeypatch):
    kinds = RUNS[mode]
    ref = _jax_run(monkeypatch, kinds, mode == "matmul",
                   np.random.RandomState(7))
    monkeypatch.setattr(port_fcn, "seg_resnet50",
                        lambda **kw: SegResNet(layers=LAYERS, **kw))
    model = fcn_cnsn(5, **{k: v for k, v in KW.items() if k != "classes"})
    model.load_state_dict(state_dict_from_jax(*ref["init"], SEG_KEY_MAP),
                          strict=True)
    state = create_seg_train_state(model.double(), device="cpu", **OPT)
    steps = SegStepFns(model, num_classes=5, lowres_ce=mode == "matmul")
    for i, kind in enumerate(kinds):
        images = torch.from_numpy(ref["images"][i])
        labels = torch.from_numpy(ref["labels"][i])
        fed = ref["fed"][i]
        if kind == "aug":
            assert sum(fed["mask"]) == 1 and len(fed["draws"]) == 4
            state, got = steps.aug(state, images, labels, **fed)
        else:
            state, got = steps.plain(state, images, labels)
        want = ref["metrics"][i]
        for k in ("loss", "main_loss", "aux_loss"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-10 * abs(
                float(want[k])), (i, k)
        for k in ("intersection", "union", "target"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert state.step == 2
    opt = state.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in state.model.named_parameters()}
    assert set(momentum) == set(ref["want_m"])
    assert _worst(state.model.state_dict(), ref["want"]) <= 1e-6
    assert _worst(momentum, ref["want_m"]) <= 1e-6
