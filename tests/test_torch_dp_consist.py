"""The consistency and AugMix-CrossNorm steps at two data-parallel ranks
against JAX's ``StepFns(num_groups=2)`` under ``DataParallel(
make_mesh(2))``: ``test_torch_dp_steps.py``'s check (split from it so
that the two files balance over the test workers), for
``cn_consistency`` on WRN-10-2 (cnsn-consist.yaml: a clean and two
CrossNorm forwards in one graph) and ``augmix_cn`` (cnsn-augmix.yaml's
views).
"""
import os

import numpy as np

from cnsn_tpu_torch.config import load_config
from test_torch_augmix_steps import _views
from test_torch_dp_steps import _CONFIGS, _check, ranks  # noqa: F401
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def test_cn_consistency_step_matches_jax_data_parallel(ranks, monkeypatch):
    """cnsn-consist.yaml on WRN-10-2 at 16²: a clean and two CrossNorm
    forwards in one graph, JAX's two masks and both forwards' draws."""
    cfg = load_config(os.path.join(_CONFIGS, "cifar10", "wideresnet",
                                   "cnsn-consist.yaml"))
    kw = dict(depth=10, widen_factor=2, num_classes=10, pos=cfg.pos,
              cnsn_type=cfg.cnsn_type, crop=cfg.crop, beta=cfg.beta)
    rng = np.random.RandomState(6)

    def feed(d, crop):
        sites = d.sites(crop)
        n = len(sites) // 2
        return {"masks": [np.array(m).tolist() for m in d.masks],
                "draws": (sites[:n], sites[n:])}

    _check(ranks, monkeypatch, "wrn", kw, None, "cn_consistency",
           rng.randn(4, 16, 16, 3), rng.randint(0, 10, 4), cfg,
           (cfg.lr, 390), dict(active_num=cfg.active_num,
                               consist_wt=cfg.consist_wt), feed,
           crop=cfg.crop, key=7)


def test_augmix_cn_step_matches_jax_data_parallel(ranks, monkeypatch):
    """cnsn-augmix.yaml's augmix_cn on WRN-10-2 at 16²: the 3B forward of
    the views sharded on their batch axis, then two CrossNorm forwards of
    the clean view with JAX's masks and draws."""
    cfg = load_config(os.path.join(_CONFIGS, "cifar10", "wideresnet",
                                   "cnsn-augmix.yaml"))
    kw = dict(depth=10, widen_factor=2, num_classes=10, pos=cfg.pos,
              cnsn_type=cfg.cnsn_type, crop=cfg.crop, beta=cfg.beta)
    images3, labels = _views(4, 16, 3)

    def feed(d, crop):
        sites = d.sites(crop)
        n = len(sites) // 2
        return {"masks": [np.array(m).tolist() for m in d.masks],
                "draws": (sites[:n], sites[n:])}

    _check(ranks, monkeypatch, "wrn", kw, None, "augmix_cn", images3,
           labels, cfg, (cfg.lr, 390),
           dict(active_num=cfg.active_num, consist_wt=cfg.consist_wt),
           feed, crop=cfg.crop)
