"""The port's SegTrainer and ``cli seg-train``/``seg-eval`` against the JAX
package's SegTrainer, on the CPU, at an FCN-CNSN of layers (1, 1, 1, 1)
(both model factories patched in this file only; the heads' dropout 0):

  * an epoch of 8 images at 33², classes 5, b=4 (as
    tests/test_segmentation.py:258-275), both in float64 from JAX's
    initial weights: the gate sequence, each step's losses, the epoch's
    mean loss and mIoU, and ``validate``'s loss and mIoU over a tail batch
    padded to the full batch.  Both trainers take the same batches (the
    JAX loader's; the loaders themselves are held in
    ``test_torch_seg_data.py``), and JAX's aug steps' draws (recorded:
    ``test_torch_cnsn_sites.JaxDraws``) are fed to the port's;
  * (``test_torch_seg_checkpoint.py``, with this file's helpers)
    checkpoints, port → port and port → JAX ``SegTrainer.resume``;
  * the CLI on the CPU: the mIoU ``seg-eval resume=`` prints is the last
    one ``seg-train`` logged; ``seg-export`` writes an artifact; and what
    raises;
  * arch psp, psa and psa_lite built by the SegTrainer at full depth, a
    step each.

The JAX trainer runs at ``num_devices=1`` (the conftest gives it 8 CPU
devices; with more its models take per-shard statistics).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.segmentation.fcn as jax_fcn
import cnsn_tpu.segmentation.trainer as jax_trainer
import cnsn_tpu_torch.segmentation.fcn as port_fcn
import cnsn_tpu_torch.segmentation.trainer as port_trainer
from cnsn_tpu.segmentation import FCNCNSN as JaxFCNCNSN
from cnsn_tpu.segmentation import SegResNet as JaxSegResNet
from cnsn_tpu.segmentation.data import SegLoader as JaxSegLoader
from cnsn_tpu.segmentation.data import synthetic_seg_dataset as jax_synthetic
from cnsn_tpu_torch import cli
from cnsn_tpu_torch.segmentation import (FCNCNSN, PSALite, PSANet, PSPNet,
                                         SegResNet)
from cnsn_tpu_torch.segmentation.data import synthetic_seg_dataset
from cnsn_tpu_torch.segmentation.trainer import SegConfig, SegTrainer
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_seg_ops import patch_jax_float64
from test_torch_wideresnet import _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)

LAYERS = (1, 1, 1, 1)
# the losses at 33²: CrossNorm's style box on layer4's 5² plane holds a
# few pixels, whose one-pass variance cancels and lifts float64 rounding
# (the two sum in other orders) to ~1e-9 of a loss (1.5e-9 measured);
# test_torch_seg_steps.py holds the same steps at 65² within 1e-10
LOSS_TOL = 1e-8
RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "segmentation",
    "gtav_fcn50_cnsn.yaml")
# seed 2: the gate RandomState(19) opens the aug step first, then plain
CFG = dict(arch="fcn_cnsn", classes=5, train_h=33, train_w=33, batch_size=4,
           batch_size_val=4, epochs=1, cnsn_type="cnsn", pos="residual",
           cn_pos="post", block_idxs="1_2_3_4", crop="style", mix_prob=0.5,
           print_freq=1, seed=2, snapshot=False)


class _F64FCN(FCNCNSN):
    """An FCN whose float64 parameters see float64 images (the loader's
    are float32; JAX promotes them against float64 parameters)."""

    def forward(self, images, *a, **kw):
        return super().forward(images.double(), *a, **kw)


def _model_kw(cfg):
    return dict(block_idxs=cfg.block_idxs, pos=cfg.pos, cn_pos=cfg.cn_pos,
                cnsn_type=cfg.cnsn_type, crop=cfg.crop, beta=cfg.beta,
                dropout=0.0)


@pytest.fixture
def small(monkeypatch):
    """Both trainers build an FCN-CNSN of layers (1, 1, 1, 1), dropout 0;
    the port's in float64 when ``small.f64`` is set."""
    monkeypatch.setattr(jax_fcn, "seg_resnet50",
                        lambda **kw: JaxSegResNet(layers=LAYERS, **kw))
    monkeypatch.setattr(port_fcn, "seg_resnet50",
                        lambda **kw: SegResNet(layers=LAYERS, **kw))
    monkeypatch.setattr(
        jax_trainer, "build_seg_model",
        lambda cfg, num_groups=1: JaxFCNCNSN(classes=cfg.classes,
                                             **_model_kw(cfg)))

    class Build:
        f64 = False

        def __call__(self, cfg, generator=None):
            cls = _F64FCN if self.f64 else FCNCNSN
            return cls(classes=cfg.classes, generator=generator,
                       **_model_kw(cfg))

    build = Build()
    monkeypatch.setattr(port_trainer, "build_seg_model", build)
    return build


def _configs(tmp_path, name, **kw):
    over = dict(CFG, **kw)
    return (SegConfig(save_path=str(tmp_path / name / "port"), **over),
            jax_trainer.SegConfig(save_path=str(tmp_path / name / "jax"),
                                  num_devices=1, **over))


class _Batches:
    """A loader that yields the same batches every epoch."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _sets():
    return (dict(n=8, hw=(41, 41), classes=5), dict(n=5, hw=(33, 33),
                                                   classes=5, seed=7))


def _datasets(port):
    make = synthetic_seg_dataset if port else jax_synthetic
    train, val = _sets()
    return make(**train), make(**val)


def _to64(jt):
    params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 (jt.state.params, jt.state.batch_stats))
    jt.state = jt.dp.replicate(jt.state.replace(
        params=params, batch_stats=stats,
        opt_state=jt.state.tx.init(params)))


def _jax_epoch(monkeypatch, jcfg, batches):
    """JAX's epoch and validation in float64, with its step kinds, losses
    and aug draws recorded."""
    draws = JaxDraws(monkeypatch)
    patch_jax_float64(monkeypatch)
    log = dict(kinds=[], losses=[], fed=[])
    with jax.enable_x64(True):
        jt = jax_trainer.SegTrainer(jcfg, *_datasets(False))
        init = (_np64(jt.state.params), _np64(jt.state.batch_stats))
        _to64(jt)
        jt.train_loader = _Batches(batches)
        plain, aug = jt.steps.plain, jt.steps._make_step(True)

        def record(kind, fn):
            def step(*args):
                state, m = fn(*args)
                log["kinds"].append(kind)
                log["losses"].append({k: float(m[k]) for k in (
                    "loss", "main_loss", "aux_loss")})
                if kind == "aug":
                    log["fed"].append(dict(mask=draws.mask(),
                                           draws=draws.sites("style")))
                return state, m
            return step

        jt.steps.plain = record("plain", plain)
        jt.steps.aug = record("aug", draws.jit(aug))
        epoch = jt.train_epoch(0)
        val = jt.validate()
        want = state_dict_from_jax(_np64(jt.state.params),
                                   _np64(jt.state.batch_stats), SEG_KEY_MAP)
    return jt, init, epoch, val, log, want


def _port_trainer(cfg, small, init, batches=None):
    small.f64 = True
    pt = SegTrainer(cfg, *_datasets(True), device="cpu")
    pt.state.model.load_state_dict(
        state_dict_from_jax(*init, SEG_KEY_MAP), strict=True)
    pt.state.model.double()
    if batches is not None:
        pt.train_loader = _Batches(batches)
    return pt


def _feed(pt, log):
    """The port's steps: JAX's aug draws fed in, kinds and losses logged."""
    got = dict(kinds=[], losses=[])
    fed = list(log["fed"])
    plain, aug = pt.steps.plain, pt.steps.aug

    def rec(kind, state, m):
        got["kinds"].append(kind)
        got["losses"].append({k: float(m[k]) for k in (
            "loss", "main_loss", "aux_loss")})
        return state, m

    pt.steps.plain = lambda *a: rec("plain", *plain(*a))
    pt.steps.aug = lambda s, im, lb, generator=None: rec(
        "aug", *aug(s, im, lb, **fed.pop(0)))
    return got


def test_epoch_and_validation_match_jax_in_float64(small, monkeypatch,
                                                   tmp_path):
    cfg, jcfg = _configs(tmp_path, "epoch")
    jl = JaxSegLoader(jax_synthetic(**_sets()[0]), cfg.batch_size,
                      jax_trainer.default_train_transform(jcfg),
                      seed=cfg.seed)
    batches = list(jl)
    jt, init, want_epoch, want_val, log, want = _jax_epoch(
        monkeypatch, jcfg, batches)
    assert log["kinds"] == ["aug", "plain"]

    pt = _port_trainer(cfg, small, init, batches)
    got = _feed(pt, log)
    got_epoch = pt.train_epoch(0)
    assert pt.gates == [True, False] and got["kinds"] == log["kinds"]
    for g, w in zip(got["losses"], log["losses"]):
        for k in w:
            assert abs(g[k] - w[k]) <= LOSS_TOL * abs(w[k]), (k, g[k], w[k])
    assert abs(got_epoch[0] - want_epoch[0]) <= LOSS_TOL * abs(want_epoch[0])
    assert got_epoch[1:] == pytest.approx(want_epoch[1:], abs=1e-12)
    assert _worst(pt.state.model.state_dict(), want) <= 1e-6
    val = pt.validate()
    assert abs(val["loss"] - want_val["loss"]) <= LOSS_TOL * want_val["loss"]
    for k in ("mIoU", "mAcc", "allAcc"):
        assert val[k] == pytest.approx(want_val[k], abs=1e-12), k
    np.testing.assert_allclose(val["iou_class"], want_val["iou_class"],
                               rtol=0, atol=1e-12)


def _val_lines(text):
    return re.findall(r"val result: mIoU/mAcc/allAcc (\S+)", text)


def test_cli_seg_train_then_seg_eval_on_the_cpu(small, tmp_path, capsys):
    """``cli seg-train`` of gtav_fcn50_cnsn.yaml (cut to 33², b=4, one
    synthetic epoch: 8 steps) then ``seg-eval resume=``: the mIoU line
    seg-eval prints is the last one training logged, and the tee log
    holds it."""
    save = tmp_path / "cli"
    common = ["--config", RECIPE, "--device", "cpu", "synthetic_data=true",
              "train_h=33", "train_w=33", "batch_size=4", "epochs=1",
              "print_freq=4", f"save_path={save}"]
    cli.main(["seg-train", *common])
    out = capsys.readouterr().out
    train_lines = _val_lines(out)
    assert len(train_lines) == 1 and "Train epoch [1]" in out
    assert sorted(f for f in os.listdir(save) if f.startswith("seg_")) == [
        "seg_ckpt_1", "seg_last_ckpt"]
    logs = [f for f in os.listdir(save) if f.startswith("train-")]
    assert logs and train_lines[0] in open(save / logs[0]).read()
    cli.main(["seg-eval", *common, f"resume={save / 'seg_ckpt_1'}"])
    assert _val_lines(capsys.readouterr().out) == train_lines


@pytest.mark.parametrize("arch,cls", [("psp", PSPNet), ("psa", PSANet),
                                       ("psa_lite", PSALite)])
def test_psp_archs_build_and_step(arch, cls, tmp_path):
    """arch psp, psa (the PSA knobs at their defaults: psa_type 2, the
    gathered map) and psa_lite, at full depth, build through the
    SegTrainer (33²: layer4 at 5², PSA's map shrunk to 3²) and take one
    step of an epoch on the CPU."""
    cfg = SegConfig(save_path=str(tmp_path), snapshot=False, arch=arch,
                    classes=5, train_h=33, train_w=33, batch_size=2,
                    print_freq=1, seed=2)
    trainer = SegTrainer(cfg, synthetic_seg_dataset(2, hw=(41, 41),
                                                    classes=5),
                         device="cpu")
    assert type(trainer.model) is cls and trainer.model.cn_num == 16
    before = trainer.model.cls[4].weight.detach().clone()
    loss, miou, _, _ = trainer.train_epoch(0)
    assert trainer.state.step == 1 and np.isfinite(loss) and 0 <= miou <= 1
    assert not torch.equal(trainer.model.cls[4].weight, before)


@pytest.mark.parametrize("over,match", [
    (dict(fsdp=True), "parallel"), (dict(num_devices=2), "parallel"),
    (dict(spatial=2), "parallel"), (dict(remat=True), None),
    (dict(ckpt_backend="orbax"), None)])
def test_unported_knobs_raise(over, match, tmp_path, monkeypatch):
    """fsdp, num_devices > 1 and spatial > 1 name ROADMAP's parallel
    item.  remat and the orbax backend, which raised before they were
    ported, build and take a step (an FCN-CNSN at layers (1, 1, 1, 1)):
    every backbone stage rematerialised; a step checkpoint under
    save_path/orbax."""
    kw = dict(save_path=str(tmp_path), snapshot=False, **over)
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            SegTrainer(SegConfig(**kw), synthetic_seg_dataset(
                4, hw=(41, 41)), device="cpu")
        return
    cfg = SegConfig(train_h=33, train_w=33, batch_size=2, classes=5,
                    print_freq=1, **kw)
    monkeypatch.setattr(port_fcn, "seg_resnet50", lambda **k: SegResNet(
        layers=(1, 1, 1, 1), **k))
    trainer = SegTrainer(cfg, synthetic_seg_dataset(2, hw=(41, 41),
                                                    classes=5), device="cpu")
    try:
        assert trainer.model.backbone.remat_stages == (
            {1, 2, 3, 4} if over.get("remat") else set())
        loss, _, _, _ = trainer.train_epoch(0)
        assert trainer.state.step == 1 and np.isfinite(loss)
        if over.get("ckpt_backend") == "orbax":
            trainer.save_checkpoint(1)
            trainer.ckpt.wait_until_finished()
            assert trainer.ckpt.all_steps() == [1]
            assert trainer.ckpt.directory == os.path.join(str(tmp_path),
                                                          "orbax")
    finally:
        trainer.close()


def test_trainer_defaults_to_cuda_and_cli_checks(tmp_path):
    cfg = SegConfig(save_path=str(tmp_path), snapshot=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SegTrainer(cfg, synthetic_seg_dataset(4, hw=(41, 41)))
    with pytest.raises(ValueError, match="unknown seg config keys"):
        cli.main(["seg-train", "--config", RECIPE, "--device", "cpu",
                  "synthetic_data=true", "not_a_key=1"])
    out = str(tmp_path / "seg.pt2")
    cli.main(["seg-export", "--config", RECIPE, "--device", "cpu", "--out",
              out, "train_h=33", "train_w=33"])
    assert os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="compute_dtype"):
        SegTrainer(SegConfig(save_path=str(tmp_path), snapshot=False,
                             compute_dtype="float16"),
                   synthetic_seg_dataset(4, hw=(41, 41)), device="cpu")
