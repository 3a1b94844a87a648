"""The port's train steps at two data-parallel ranks against JAX's
``StepFns(num_groups=2)`` under ``DataParallel(make_mesh(2))`` (run as
``tests/test_parallel.py`` runs it), in float64 on the CPU.

JAX shards the batch over two of its eight CPU devices, its statistics
global (GSPMD), its CrossNorm pairing within each device's half
(``grouped_permutation(n, 2)``).  The port runs each step on two gloo
ranks (one ``RankPool`` for the module), each on its half of the batch:
K2's plain sums all-reduced forward and backward, SelfNorm's BatchNorm1d
over the gathered batch, the gradients averaged.  JAX's draws (the site
masks, each site's global permutation and boxes) are recorded and fed to
both ranks, each taking its block.  The steps: ``plain`` and ``cn`` on
AllConvNet (full widths, 32², dropout 0), ``cn_image`` at crop 'both' on
a reduced ResNet-50+SN at 128² (a box crop never ends on a 2×2 plane:
ROADMAP queue 1), ``cn_consistency`` on WRN-10-2 (cnsn-consist.yaml) and
``augmix_cn`` on WRN-10-2 (cnsn-augmix.yaml's views; these two in
``test_torch_dp_consist.py``, which imports this file's helpers), each at
a global batch of 4.  Bounds: the global loss (and ce, jsd) within 1e-10
relative; every parameter, running statistic and momentum buffer within
1e-6 of its tensor's max-abs, on both ranks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnsn_tpu.models.allconv import AllConvNet as JaxAllConvNet
from cnsn_tpu.models.resnet import ResNet as JaxResNet
from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu.parallel import DataParallel as JaxDataParallel
from cnsn_tpu.parallel import make_mesh as jax_make_mesh
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import TrainState as JaxTrainState
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.models.allconv import allconv_key_map
from cnsn_tpu_torch.parallel import RankPool
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_dp_ranks import PORT, W, _port_rank
from test_torch_wideresnet import _find_trace, _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs")
JAX = {"allconv": JaxAllConvNet, "resnet": JaxResNet, "wrn": JaxWideResNet}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, str(tmp_path_factory.mktemp("store")), device="cpu",
                  timeout=90) as pool:
        yield pool


def _jax_state(model, port, shape, tx, key_map):
    """JAX's train state in float64 from the port model's initial
    variables (``test_torch_consistency.py``'s, with ``key_map``), and
    those variables."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "crossnorm": jax.random.key(1),
         "dropout": jax.random.key(2)}, jnp.zeros(shape), False, None))
    params, stats, missing = convert_state_dict(
        port.state_dict(), *jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32),
            (dict(shapes["params"]), dict(shapes["batch_stats"]))),
        strict=True, key_map=key_map)
    assert missing == []
    init = (_np64(params), _np64(stats))
    params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 (params, stats))
    return JaxTrainState.create(apply_fn=model.apply, params=params,
                                batch_stats=stats, tx=tx), init


def _check(ranks, monkeypatch, name, kw, key_map, step, images, labels,
           cfg, lr, steps_kw, feed, crop=None, key=5, jax_kw=None):
    """JAX's ``step`` sharded over two devices (compiled, its draws
    recorded) against the port's on two ranks, from the same weights."""
    draws = JaxDraws(monkeypatch)
    sgd = dict(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
               nesterov=cfg.nesterov)
    shape = images.shape[1:] if images.ndim == 5 else images.shape
    jm = JAX[name](num_groups=W, **kw, **(jax_kw or {}))
    with jax.enable_x64(True):
        tx = make_sgd(jax_schedules.cosine_lr(*lr), **sgd)
        state, init = _jax_state(jm, PORT[name](**kw), shape, tx, key_map)
        dp = JaxDataParallel(jax_make_mesh(W))
        state = dp.replicate(state)
        im, lb = dp.shard_inputs(jnp.asarray(images), jnp.asarray(labels))
        new, metrics = draws.jit(getattr(
            JaxStepFns(jm, num_groups=W, **steps_kw), "_" + step))(
            state, im, lb, jax.random.key(key))
        want_metrics = {k: float(metrics[k]) for k in ("loss", "ce", "jsd")
                        if k in metrics}
        want = (state_dict_from_jax(_np64(new.params),
                                    _np64(new.batch_stats), key_map),
                state_dict_from_jax(_np64(_find_trace(new.opt_state)), {},
                                    key_map))
    got = ranks.run(_port_rank, name, kw, key_map, init, step, images,
                    labels, lr, sgd, steps_kw, feed(draws, crop))
    for metrics_r, state_r, momentum_r in got:
        errs = (max(abs(metrics_r[k] - v) / abs(v)
                    for k, v in want_metrics.items()),
                _worst(state_r, want[0]), _worst(momentum_r, want[1]))
        assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs
    return draws


def _allconv(cfg_name):
    cfg = load_config(os.path.join(_CONFIGS, "cifar10", "allconv",
                                   cfg_name))
    kw = dict(num_classes=10, pos=1, cnsn_type=cfg.cnsn_type, crop=cfg.crop,
              beta=cfg.beta, drop_rate=0.0)
    return cfg, kw


def test_plain_step_on_two_ranks_matches_jax_data_parallel(ranks,
                                                           monkeypatch):
    cfg, kw = _allconv("cnsn.yaml")
    rng = np.random.RandomState(0)
    _check(ranks, monkeypatch, "allconv", kw, allconv_key_map(1), "plain",
           rng.randn(4, 32, 32, 3), rng.randint(0, 10, 4), cfg,
           (cfg.lr, 390), {}, lambda d, c: {})


def test_cn_step_on_two_ranks_matches_jax_data_parallel(ranks, monkeypatch):
    """AllConvNet cnsn.yaml's cn step: JAX's site mask and each active
    site's global pairing (within each device's half) and boxes."""
    cfg, kw = _allconv("cnsn.yaml")
    rng = np.random.RandomState(1)

    def feed(d, crop):
        sites = d.sites(crop)
        for s in sites:  # the pairing never crosses the halves
            perm = s["perm"].numpy()
            assert sorted(perm[:2]) == [0, 1] and sorted(perm[2:]) == [2, 3]
        return {"mask": d.mask(), "draws": sites}

    _check(ranks, monkeypatch, "allconv", kw, allconv_key_map(1), "cn",
           rng.randn(4, 32, 32, 3), rng.randint(0, 10, 4), cfg,
           (cfg.lr, 390), dict(active_num=cfg.active_num), feed,
           crop=cfg.crop)


def test_cn_image_step_at_crop_both_matches_jax_data_parallel(ranks,
                                                              monkeypatch):
    """Image CrossNorm at crop 'both' on the reduced ResNet-50+SN at
    128²: JAX's global pairing and its two boxes."""
    kw = dict(layers=(1, 1, 1, 1), num_classes=10, pos="post",
              cnsn_type="sn", crop="neither", beta=1.0)
    cfg = load_config(os.path.join(_CONFIGS, "imagenet", "resnet50",
                                   "cn.yaml"))
    rng = np.random.RandomState(2)

    def feed(d, crop):
        (site,) = d.sites("both")
        assert set(site) == {"perm", "style_box", "content_box"}
        return site

    _check(ranks, monkeypatch, "resnet", kw, None, "cn_image",
           rng.randn(4, 128, 128, 3), rng.randint(0, 10, 4), cfg, (0.05, 4),
           dict(image_crop="both", image_beta=1.0), feed,
           jax_kw=dict(stem="conv"))
