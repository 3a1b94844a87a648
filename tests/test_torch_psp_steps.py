"""The port's segmentation SGD steps on PSPNet (SegStepFns.plain and .aug
of gtav_fcn50_cnsn.yaml's knobs with arch=psp) against JAX's, on the
CPU, in float64, at the reduced depth of ``test_torch_psp_models.py``
(both packages' ``pspnet.seg_resnet50`` patched in this file only): a
plain step then an aug step from the same weights, the class-major fused
CE with the align-corners matrices (PSPNet's ``UPSAMPLE_ALIGN_CORNERS``),
the poly schedule's second value and the 10× head groups (the backbone's
and ``ppm``/``cls``/``aux``).  JAX's aug step is compiled with its draws
recorded (``test_torch_cnsn_sites.JaxDraws``) and fed to the port.  Held:
each step's loss and its main and aux parts within 1e-10, the histograms
equal, and after the second step every parameter, running statistic and
momentum buffer within 1e-6 of each tensor's max-abs."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cnsn_tpu.segmentation import SegStepFns as JaxSegStepFns
from cnsn_tpu.segmentation import SegTrainState as JaxSegTrainState
from cnsn_tpu.segmentation import make_seg_optimizer as jax_seg_optimizer
from cnsn_tpu.segmentation.pspnet import PSPNet as JaxPSPNet
from cnsn_tpu_torch.segmentation import PSPNet, SegStepFns
from cnsn_tpu_torch.segmentation.train_seg import (HEAD_PREFIXES,
                                                   create_seg_train_state,
                                                   label_groups)
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_psp_models import KW, init_jit, small  # noqa: F401 (a fixture)
from test_torch_wideresnet import _find_trace, _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)

B, SIZE = 2, 65
OPT = dict(base_lr=0.01, max_iter=3, power=0.9, momentum=0.9,
           weight_decay=1e-4)
KINDS = ("plain", "aug")


def _jax_run(monkeypatch, rng):
    draws = JaxDraws(monkeypatch)
    images = rng.randn(len(KINDS), B, SIZE, SIZE, 3)
    labels = rng.randint(0, 5, (len(KINDS), B, SIZE, SIZE))
    labels[:, :, :4] = 255
    jm = JaxPSPNet(**KW)
    params, stats = init_jit(jm, images.shape[1:], rng)
    tx = jax_seg_optimizer(params, OPT["base_lr"], OPT["max_iter"],
                           OPT["power"], OPT["momentum"],
                           OPT["weight_decay"])
    state = JaxSegTrainState.create(apply_fn=jm.apply, params=params,
                                    batch_stats=stats, tx=tx)
    steps = JaxSegStepFns(jm, num_classes=5, lowres_ce=True)
    assert steps.align_corners
    metrics, fed = [], []
    for i, kind in enumerate(KINDS):
        args = (state, jnp.asarray(images[i]), jnp.asarray(labels[i]),
                jax.random.key(40 + i))
        if kind == "aug":
            state, m = draws.jit(steps._make_step(True))(*args)
            fed.append(dict(mask=draws.mask(), draws=draws.sites("style")))
        else:
            state, m = jax.jit(steps._make_step(False))(*args)
            fed.append({})
        metrics.append(jax.tree.map(np.asarray, m))
    want = state_dict_from_jax(_np64(state.params), _np64(state.batch_stats),
                               SEG_KEY_MAP)
    want_m = state_dict_from_jax(_np64(_find_trace(state.opt_state)), {},
                                 SEG_KEY_MAP)
    assert int(state.step) == len(KINDS) and jm.cn_num == 4
    return dict(images=images, labels=labels, init=(params, stats),
                metrics=metrics, fed=fed, want=want, want_m=want_m)


def test_plain_then_aug_step_match_jax(small, monkeypatch):
    ref = _jax_run(monkeypatch, small)
    model = PSPNet(**KW)
    model.load_state_dict(state_dict_from_jax(*ref["init"], SEG_KEY_MAP),
                          strict=True)
    state = create_seg_train_state(model.double(), device="cpu", **OPT)
    _, head = label_groups(model, HEAD_PREFIXES)
    heads = {n.split(".")[0] for n, p in model.named_parameters()
             if any(p is q for q in head)}
    assert heads == {"ppm", "cls", "aux"}
    steps = SegStepFns(model, num_classes=5, lowres_ce=True)
    assert steps.align_corners
    for i, kind in enumerate(KINDS):
        images = torch.from_numpy(ref["images"][i])
        labels = torch.from_numpy(ref["labels"][i])
        if kind == "aug":
            fed = ref["fed"][i]
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
