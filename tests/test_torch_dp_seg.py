"""The port's SegTrainer at two data-parallel ranks (two gloo processes on
the CPU) against JAX's ``SegTrainer(num_devices=2)``, at the reduced
FCN-CNSN of ``tests/test_torch_seg_trainer.py`` (layers (1, 1, 1, 1),
33², 5 classes, b=4: 2 a rank; the factories patched in each rank and,
for JAX, with its ``num_groups``), in float64.

Two steps (the gate opens the aug step, then the plain one), JAX's aug
draws (the site mask, each site's global pairing, within each device's
half, and its style box) fed to both ranks: each step's global losses,
the epoch's mean loss and mIoU, the state after it on both ranks; then
``validate`` over 5 images at batch 4 (2 rows a rank in each batch, the
tail of 1 padded with ``ignore_label``, rank 1's share padding only): the
loss, mIoU, mAcc, allAcc and each class's IoU equal to JAX's.  Bounds:
those of ``test_torch_seg_trainer.py``.  The ranks' side:
``test_torch_dp_ranks.py``.
"""
import jax
import numpy as np
import pytest
import torch

import cnsn_tpu.segmentation.fcn as jax_fcn
import cnsn_tpu.segmentation.trainer as jax_trainer
from cnsn_tpu.segmentation import FCNCNSN as JaxFCNCNSN
from cnsn_tpu.segmentation import SegResNet as JaxSegResNet
from cnsn_tpu.segmentation.data import SegLoader as JaxSegLoader
from cnsn_tpu.segmentation.data import synthetic_seg_dataset as jax_synthetic
from cnsn_tpu_torch.parallel import RankPool
from test_torch_dp_ranks import W, _rank_seg
from test_torch_seg_trainer import (CFG, LAYERS, LOSS_TOL, _jax_epoch,
                                    _model_kw, _sets)
from test_torch_wideresnet import _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)


class _JaxFCN(JaxFCNCNSN):
    """JAX's FCN-CNSN with its init compiled (op by op it takes seconds
    on the CPU)."""

    def init(self, rngs, x, *args):
        return jax.jit(lambda r, xx: JaxFCNCNSN.init(self, r, xx, *args))(
            rngs, x)


@pytest.fixture
def jax_small(monkeypatch):
    """JAX's SegTrainer builds the reduced FCN-CNSN with its
    ``num_groups`` (its data-parallel width)."""
    monkeypatch.setattr(jax_fcn, "seg_resnet50",
                        lambda **kw: JaxSegResNet(layers=LAYERS, **kw))
    monkeypatch.setattr(
        jax_trainer, "build_seg_model",
        lambda cfg, num_groups=1: _JaxFCN(
            classes=cfg.classes, num_groups=num_groups, **_model_kw(cfg)))


def test_two_steps_and_validation_match_jax_data_parallel(
        jax_small, monkeypatch, tmp_path):
    over = dict(CFG)
    jcfg = jax_trainer.SegConfig(save_path=str(tmp_path / "jax"),
                                 num_devices=W, **over)
    jl = JaxSegLoader(jax_synthetic(**_sets()[0]), over["batch_size"],
                      jax_trainer.default_train_transform(jcfg),
                      seed=over["seed"])
    batches = list(jl)
    jt, init, want_epoch, want_val, log, want = _jax_epoch(
        monkeypatch, jcfg, batches)
    assert log["kinds"] == ["aug", "plain"]
    for fed in log["fed"]:  # the pairing stays within each device's half
        for site in fed["draws"]:
            perm = site["perm"].numpy()
            assert sorted(perm[:2]) == [0, 1] and sorted(perm[2:]) == [2, 3]
    with RankPool(W, str(tmp_path / "store"), device="cpu",
                  timeout=90) as pool:
        got = pool.run(_rank_seg, str(tmp_path / "port"), init, batches,
                       log["fed"])
    for g in got:
        assert g["gates"] == [True, False] and g["kinds"] == log["kinds"]
        for gl, wl in zip(g["losses"], log["losses"]):
            for k in wl:
                assert abs(gl[k] - wl[k]) <= LOSS_TOL * abs(wl[k]), (k, gl,
                                                                    wl)
        assert abs(g["epoch"][0] - want_epoch[0]) <= \
            LOSS_TOL * abs(want_epoch[0])
        assert g["epoch"][1:] == pytest.approx(want_epoch[1:], abs=1e-12)
        assert _worst(g["state"], want) <= 1e-6
        assert g["eval_rows"] == [2, 2]  # a rank's share, the tail padded
        val = g["val"]
        assert abs(val["loss"] - want_val["loss"]) <= \
            LOSS_TOL * want_val["loss"]
        for k in ("mIoU", "mAcc", "allAcc"):
            assert val[k] == pytest.approx(want_val[k], abs=1e-12), k
        np.testing.assert_allclose(val["iou_class"], want_val["iou_class"],
                                   rtol=0, atol=1e-12)
    for k, v in got[0]["state"].items():  # the ranks' states are one
        assert torch.equal(v, got[1]["state"][k]), k
