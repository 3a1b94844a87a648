"""The port's Trainer on ImageNet recipes against the JAX package's on the
CPU: a ResNet-50 at layers (1, 1, 1, 1) patched into both model
factories (in this file only), a PIL-written image folder at 64² (at 32²
the last stage's SelfNorm would see a 1×1 plane), JAX at
``num_devices=1`` and its loader on PIL (``use_native=False``: both
packages decode alike).  One plain epoch of sn.yaml in float64 from the
same weights (the loader's batches are held to JAX's in
test_torch_imagenet_data.py, the gate's dispatch in test_torch_trainer.py
and test_torch_consistency.py); ImageNet-C's 15 corruptions × 5 severities (2 images a
folder) and the mCE; and ``cli train``/``eval`` with ``corrupt_data_dir``.
"""
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.data.native as jax_native
import cnsn_tpu.train.trainer as jax_trainer_mod
import cnsn_tpu_torch.models as port_models
import cnsn_tpu_torch.train.trainer as trainer_mod
from cnsn_tpu.config import load_config as jax_load_config
from cnsn_tpu.models.resnet import ResNet as JaxResNet
from cnsn_tpu_torch import cli
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.evaluation.classify import CORRUPTIONS, compute_mce
from cnsn_tpu_torch.models.resnet import ResNet
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_imagenet_data import write_folder
from test_torch_wideresnet import _find_trace, _np64, _worst

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "imagenet")
SN, CNSN = (os.path.join(_CONFIGS, "resnet50", f)
            for f in ("sn.yaml", "cnsn.yaml"))
LAYERS = (1, 1, 1, 1)
TRAIN = (("n01", 4, 60, 80), ("n02", 4, 90, 70), ("n03", 4, 50, 64))
VAL = (("n01", 2, 70, 70), ("n02", 2, 64, 96), ("n03", 2, 80, 60))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, torch's default
    pool (a thread a core in each worker) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _F64ResNet(ResNet):
    """ResNet whose float64 parameters see float64 images (the loader's
    are float32; JAX promotes them against float64 parameters)."""

    def forward(self, images, **kw):
        return super().forward(images.to(self.fc.weight.dtype), **kw)


def _knobs(kw):
    return {k: v for k, v in kw.items()
            if v is not None and k not in ("remat", "generator", "dtype")}


@pytest.fixture
def small(monkeypatch):
    """Both Trainers build ResNet-50 at LAYERS (the IBN recipe too: the
    model is not what these tests hold)."""
    def jax_build(name, num_classes, **kw):
        return JaxResNet(layers=LAYERS, num_classes=num_classes,
                         stem="conv", **_knobs(kw))

    def port_build(name, num_classes, generator=None, **kw):
        return _F64ResNet(layers=LAYERS, num_classes=num_classes,
                          generator=generator, **_knobs(kw))

    monkeypatch.setattr(jax_trainer_mod, "build_model", jax_build)
    monkeypatch.setattr(trainer_mod, "build_model", port_build)
    monkeypatch.setattr(port_models, "build_model", port_build)
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet"))
    write_folder(os.path.join(root, "train"), 1, TRAIN)
    write_folder(os.path.join(root, "validation"), 2, VAL)
    return root


@pytest.fixture(scope="module")
def corrupt_dir(tmp_path_factory):
    """ImageNet-C's layout, 2 classes × 1 image a corruption and
    severity."""
    root = str(tmp_path_factory.mktemp("imagenet_c"))
    for k, c in enumerate(CORRUPTIONS):
        for s in range(1, 6):
            write_folder(os.path.join(root, c, str(s)), 100 * k + s,
                         (("n01", 1, 48, 48), ("n02", 1, 40, 56)))
    return root


def _configs(recipe, data_dir, tmp_path, **kw):
    over = {**dict(data_dir=data_dir, image_size=64, batch_size=4,
                   eval_batch_size=4, snapshot=False, workers=2), **kw}
    return (load_config(recipe, exp_dir=str(tmp_path / "port"), **over),
            jax_load_config(recipe, num_devices=1,
                            exp_dir=str(tmp_path / "jax"), **over))


def _double(jt):
    """JAX's Trainer state in float64 (inside enable_x64), and its
    initial float32 state."""
    params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 (jt.state.params, jt.state.batch_stats))
    init = jt.state
    jt.state = jt.dp.replicate(jt.state.replace(
        params=params, batch_stats=stats,
        opt_state=jt.state.tx.init(params)))
    return init


def _load(port, jax_state):
    port.state.model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, jax_state.params),
        jax.tree.map(np.asarray, jax_state.batch_stats)), strict=True)
    port.state.model.double()


def test_plain_epoch_and_evaluation_match_jax_in_float64(small, data_dir,
                                                        tmp_path):
    """sn.yaml's plain regime, 12 images at b=4 (3 steps) through each
    Trainer's train_epoch in float64 from JAX's initial weights: the
    epoch's mean loss, every parameter, running statistic and momentum
    buffer after it; then evaluate_clean on the validation folder."""
    cfg, jcfg = _configs(SN, data_dir, tmp_path)
    assert (cfg.regime, cfg.cn_prob) == ("plain", None)
    with jax.enable_x64(True):
        jt = jax_trainer_mod.Trainer(jcfg)
        init = _double(jt)
        want_avg = jt.train_epoch()
        want_eval = jt.evaluate_clean()
        want = state_dict_from_jax(_np64(jt.state.params),
                                   _np64(jt.state.batch_stats))
        want_m = state_dict_from_jax(_np64(_find_trace(jt.state.opt_state)),
                                     {})
        assert int(jt.state.step) == 3
    pt = trainer_mod.Trainer(cfg, device="cpu")
    _load(pt, init)
    got_avg = pt.train_epoch()
    got_eval = pt.evaluate_clean()
    assert pt.state.step == 3
    opt = pt.state.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in pt.state.model.named_parameters()}
    errs = (abs(got_avg - want_avg) / abs(want_avg),
            _worst(pt.state.model.state_dict(), want),
            _worst(momentum, want_m))
    assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs
    # the eval SelfNorm takes x·g in fp32 (ops/kernels/selfnorm.py)
    assert got_eval[1] == want_eval[1]
    np.testing.assert_allclose(got_eval[0], want_eval[0], rtol=1e-6)


def test_test_corruptions_imagenet_matches_jax(small, data_dir, corrupt_dir,
                                               tmp_path, capsys):
    """ImageNet-C through each Trainer in float32 from the same weights:
    the 75 accuracies (the loaders at their default 224², whatever
    image_size says, as JAX's), each corruption's printed error, the CEs
    and the mCE, equal to JAX's; and compute_mce of the accuracies."""
    cfg, jcfg = _configs(SN, data_dir, tmp_path,
                         corrupt_data_dir=corrupt_dir)
    seen = {"port": [], "jax": []}

    def spy(pkg, mod):
        evaluate = mod.evaluate

        def run(step, state, loader, **kw):
            seen[pkg].append(loader.image_size)
            out = evaluate(step, state, loader, **kw)
            seen[pkg].append(out[1])
            return out
        return run
    jt = jax_trainer_mod.Trainer(jcfg)
    jax_trainer_mod.evaluate, saved = spy("jax", jax_trainer_mod), \
        jax_trainer_mod.evaluate
    try:
        capsys.readouterr()
        want = jt.test_corruptions()
        want_out = capsys.readouterr().out
    finally:
        jax_trainer_mod.evaluate = saved
    pt = trainer_mod.Trainer(cfg, device="cpu")
    _load(pt, jt.state)
    pt.state.model.float()
    trainer_mod.evaluate, saved = spy("port", trainer_mod), \
        trainer_mod.evaluate
    try:
        got = pt.test_corruptions()
        got_out = capsys.readouterr().out
    finally:
        trainer_mod.evaluate = saved
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 150
    assert set(seen["port"][::2]) == {224}
    assert got == want and got_out == want_out
    accs = seen["port"][1::2]
    mce, _ = compute_mce({c: accs[5 * k:5 * k + 5]
                          for k, c in enumerate(CORRUPTIONS)})
    assert mce == got and f"mCE: {got:.2f}" in got_out


def test_cli_train_then_eval_with_imagenet_c(small, data_dir, corrupt_dir,
                                             tmp_path, capsys):
    """cli train of cnsn.yaml for one epoch on the folder, then eval
    resume=<last> with corrupt_data_dir: the Test Error of log.txt's row,
    and the mCE of the 75 printed accuracies' CEs."""
    common = ["--config", CNSN, "--device", "cpu", f"data_dir={data_dir}",
              "image_size=64", "batch_size=4", "eval_batch_size=4",
              "workers=2"]
    cli.main(["train", *common, "epochs=1", f"exp_dir={tmp_path}/exp"])
    [exp_dir] = glob.glob(f"{tmp_path}/exp/*/*")
    name = "_F64ResNet"  # the model class this file patches in
    assert {f"{name}_last_ckpt", f"{name}_ckpt_1",
            "log.txt"} <= set(os.listdir(exp_dir))
    row = open(os.path.join(exp_dir, "log.txt")).read().splitlines()[-1]
    capsys.readouterr()
    cli.main(["eval", *common, f"resume={exp_dir}/{name}_last_ckpt",
              f"corrupt_data_dir={corrupt_dir}"])
    out = capsys.readouterr().out
    assert re.search(r"Test Error (\S+)", out).group(1) == row.split("\t")[3]
    ces = [float(v) for v in re.findall(
        r"^\w+:\s+(-?[\d.]+)$", out.split("individual CEs:")[1], re.M)][:15]
    assert len(ces) == 15
    mce = float(re.search(r"^mCE: (\S+)$", out, re.M).group(1))
    assert abs(mce - sum(ces) / 15) < 0.01, out
