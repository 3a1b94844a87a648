"""Every non-AugMix CIFAR recipe of the four models (``sn``, ``cn``,
``cnsn`` and ``cnsn-consist`` on CIFAR-10 and CIFAR-100) builds the
port's Trainer at full width on the CPU and takes one step of the step
function its regime gates, at b=2 on the synthetic set: the config as
``load_config`` resolves it, the unported-knob check, the model the
registry builds, and one SGD update with a finite loss.  Parity with JAX
is held elsewhere at reduced depth (test_torch_consistency.py,
test_torch_cifar_models.py and the per-model files); this file shows that
each recipe file reaches those paths.
"""
import glob
import math
import os

import numpy as np
import pytest
import torch

from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.train.trainer import _GATED, Trainer

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs")
RECIPES = sorted(
    os.path.relpath(p, _CONFIGS)
    for p in glob.glob(os.path.join(_CONFIGS, "cifar*", "*", "*.yaml"))
    if "augmix" not in os.path.basename(p))
MODELS = {"wideresnet": "WideResNet", "allconv": "AllConvNet",
          "densenet": "DenseNet", "resnext": "CifarResNeXt"}


@pytest.fixture(autouse=True)
def one_thread():
    """Full-width steps on one intra-op thread: beside the other test
    workers, torch's default pool (one thread a core in each worker)
    oversubscribes the cores and runs these steps tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _GateOpen:
    """The Trainer's gate RNG, drawing 0.0: the gated step wherever the
    recipe has a cn_prob."""

    def rand(self, n):
        return np.zeros(n)


def test_the_recipes_are_the_four_models_on_both_datasets():
    assert len(RECIPES) == 32
    assert {r.split(os.sep)[1] for r in RECIPES} == set(MODELS)


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_trains_one_step(recipe, tmp_path):
    cfg = load_config(os.path.join(_CONFIGS, recipe), synthetic_data=True,
                      snapshot=False, batch_size=2, eval_batch_size=2,
                      prefetch_depth=0, exp_dir=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    cfg = trainer.cfg
    dataset, model, name = recipe.split(os.sep)
    assert cfg.dataset == dataset and cfg.model == model
    assert type(trainer.model).__name__ == MODELS[model]
    assert cfg.num_classes == (10 if dataset == "cifar10" else 100)
    if name == "cnsn-consist.yaml":
        assert cfg.regime == "cn_consistency" and cfg.consist_wt > 0
    else:
        assert cfg.regime == ("plain" if name == "sn.yaml" else "cn")
    want = _GATED[cfg.regime] if cfg.cn_prob is not None else None
    calls = []
    for step in {"plain", want} - {None}:
        fn = getattr(trainer.steps, step)

        def record(*a, _fn=fn, _step=step, **kw):
            calls.append(_step)
            return _fn(*a, **kw)
        setattr(trainer.steps, step, record)
    trainer._rng = _GateOpen()
    loader = trainer.train_loader
    trainer.train_loader = [next(iter(loader))]
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    loss = trainer.train_epoch()
    trainer.train_loader = loader
    trainer.close()
    assert calls == [want or "plain"]
    assert math.isfinite(loss) and int(trainer.state.step) == 1
    after = trainer.state.model.state_dict()
    moved = [k for k, v in before.items()
             if v.is_floating_point() and not torch.equal(v, after[k])]
    assert moved and all(torch.isfinite(v).all() for v in after.values()
                         if v.is_floating_point())
