"""Every classification recipe (the four CIFAR models' ``sn``, ``cn``,
``cnsn``, ``cnsn-consist`` and ``cnsn-augmix`` on CIFAR-10 and CIFAR-100,
and the five ImageNet recipes of ResNet-50 and ResNet-50-IBN-b) builds
the port's Trainer at full width on the CPU and takes one step of the
step function its regime gates, at b=2: CIFAR on the synthetic set,
ImageNet on a PIL-written image folder at 64²: the config as
``load_config`` resolves it, the unported-knob check, the model the
registry builds, the loader's mode, and one SGD update with a finite
loss.  Parity with JAX is held elsewhere at reduced depth
(test_torch_consistency.py, test_torch_augmix_steps.py,
test_torch_cifar_models.py and the per-model files); this file shows that
each recipe file reaches those paths.
"""
import glob
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.train.trainer import _GATED, Trainer

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs")
RECIPES = sorted(
    os.path.relpath(p, _CONFIGS)
    for p in glob.glob(os.path.join(_CONFIGS, "*", "*", "*.yaml"))
    if not p.startswith(os.path.join(_CONFIGS, "segmentation")))
MODELS = {"wideresnet": "WideResNet", "allconv": "AllConvNet",
          "densenet": "DenseNet", "resnext": "CifarResNeXt",
          "resnet50": "ResNet", "resnet50_ibn_b": "ResNetIBN"}
REGIMES = {"sn.yaml": "plain", "cn.yaml": "cn",
           "cnsn.yaml": "cn", "cnsn-consist.yaml": "cn_consistency",
           "cnsn-augmix.yaml": "cn_augmix"}
IMAGENET_REGIMES = {"sn.yaml": "plain", "cn.yaml": "cn_image",
                    "cnsn.yaml": "cn_image",
                    "cnsn-consist.yaml": "cn_image_consist",
                    "cnsn-augmix.yaml": "cn_image_augmix"}


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """train/ and validation/ of two classes, two JPEGs each."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.RandomState(0)
    for split in ("train", "validation"):
        for c in range(2):
            d = root / split / f"n{c:04d}"
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.randint(0, 256, (72, 88, 3), np.uint8)
                                ).save(d / f"{i}.jpeg", quality=90)
    return str(root)


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


def test_the_recipes_are_the_six_models_on_three_datasets():
    """The 45 classification recipes: 40 CIFAR (four models, five recipes,
    two datasets) and five ImageNet."""
    assert len(RECIPES) == 45
    assert {r.split(os.sep)[1] for r in RECIPES} == set(MODELS)
    assert sum(r.startswith("imagenet") for r in RECIPES) == 5


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_trains_one_step(recipe, tmp_path, image_folder):
    dataset, model, name = recipe.split(os.sep)
    over = (dict(data_dir=image_folder, image_size=64, workers=1)
            if dataset == "imagenet" else dict(synthetic_data=True))
    cfg = load_config(os.path.join(_CONFIGS, recipe), snapshot=False,
                      batch_size=2, eval_batch_size=2, prefetch_depth=0,
                      exp_dir=str(tmp_path), **over)
    trainer = Trainer(cfg, device="cpu")
    cfg = trainer.cfg
    assert cfg.dataset == dataset and cfg.model == model
    assert type(trainer.model).__name__ == MODELS[model]
    assert cfg.num_classes == {"cifar10": 10, "cifar100": 100,
                               "imagenet": 1000}[dataset]
    regimes = IMAGENET_REGIMES if dataset == "imagenet" else REGIMES
    assert cfg.regime == regimes[name]
    if "consist" in name:
        assert cfg.consist_wt > 0
    augmix = name == "cnsn-augmix.yaml"
    assert trainer.train_loader.mode == (
        "train_augmix" if augmix else "train")
    gated, ungated = _GATED[cfg.regime]
    want = gated if cfg.cn_prob is not None else ungated
    calls = []
    for step in {ungated, want}:
        fn = getattr(trainer.steps, step)

        def record(*a, _fn=fn, _step=step, **kw):
            # the Trainer's call, not one step calling another (cn_image
            # ends in plain)
            calls.append(_step)
            depth = len(calls)
            out = _fn(*a, **kw)
            del calls[depth:]
            return out
        setattr(trainer.steps, step, record)
    trainer._rng = _GateOpen()
    loader = trainer.train_loader
    trainer.train_loader = [next(iter(loader))]
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    loss = trainer.train_epoch()
    trainer.train_loader = loader
    trainer.close()
    assert calls == [want]
    assert math.isfinite(loss) and int(trainer.state.step) == 1
    after = trainer.state.model.state_dict()
    moved = [k for k, v in before.items()
             if v.is_floating_point() and not torch.equal(v, after[k])]
    assert moved and all(torch.isfinite(v).all() for v in after.values()
                         if v.is_floating_point())
