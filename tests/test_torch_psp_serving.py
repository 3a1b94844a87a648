"""PSPNet's checkpoints and artifacts, on the CPU, at the reduced depth of
``test_torch_psp_models.py`` (both packages' ``pspnet.seg_resnet50``
patched in this file only):

  * ``serving.export_segmenter``: the artifact of an eval forward against
    the eager forward at the symbolic batch's 1 and 3 (as JAX's
    tests/test_serving.py:63-83), its SelfNorm sites as K3's custom op;
  * a port ``SegTrainer`` of gtav_fcn50_cnsn.yaml with arch=psp (33², b=2,
    one epoch of two steps) writes ``seg_ckpt_1``; ``cli seg-export
    --device cpu resume=`` of it writes an artifact that serves the
    checkpoint's eager forward;
  * the same checkpoint, carried into JAX's trees by
    ``convert_state_dict`` with ``SEG_KEY_MAP``'s PSP entries (and the
    momentum into optax's trace), restores into JAX's ``SegTrainer`` of
    arch=psp (``test_torch_seg_checkpoint._port_ckpt_to_jax``), which
    validates on it.
"""
import os

import numpy as np
import pytest
import torch

import cnsn_tpu.segmentation.trainer as jax_trainer
from cnsn_tpu.segmentation.data import synthetic_seg_dataset as jax_synthetic
import cnsn_tpu_torch.segmentation.trainer as port_trainer
from cnsn_tpu_torch import cli
from cnsn_tpu_torch.segmentation import PSPNet
from cnsn_tpu_torch.segmentation.data import synthetic_seg_dataset
from cnsn_tpu_torch.serving import (export_segmenter, load_artifact,
                                    save_artifact)
from cnsn_tpu_torch.utils.checkpoint import load_checkpoint
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_psp_models import KW, reduce_depth
from test_torch_seg_checkpoint import _port_ckpt_to_jax
from test_torch_seg_trainer import RECIPE
from test_torch_wideresnet import _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)

SIZE = 33
CFG = dict(arch="psp", classes=5, train_h=SIZE, train_w=SIZE, batch_size=2,
           batch_size_val=2, epochs=1, print_freq=1, seed=2, snapshot=False)


def _k3_nodes(exported):
    return sum("selfnorm_infer" in str(node.target)
               for node in exported.graph.nodes)


def test_export_segmenter_serves_the_eager_forward(monkeypatch, tmp_path):
    reduce_depth(monkeypatch)
    model = PSPNet(generator=torch.Generator().manual_seed(0),
                   **dict(KW, cnsn_type="sn", cn_pos=None))
    exported = export_segmenter(model, (SIZE, SIZE))
    assert _k3_nodes(exported) == 4  # one a SelfNorm site
    path = str(tmp_path / "psp.pt2")
    save_artifact(exported, path)
    serve = load_artifact(path, device="cpu")
    for batch in (1, 3):
        x = torch.from_numpy(np.random.RandomState(batch).randn(
            batch, SIZE, SIZE, 3).astype(np.float32))
        with torch.no_grad():
            want = model.eval()(x)[0]
        got = serve(x)
        assert got.shape == want.shape == (batch, SIZE, SIZE, 5)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def psp_ckpt(monkeypatch, tmp_path):
    """A port SegTrainer of the recipe with arch=psp, one epoch (two
    steps: plain, then aug at seed 2's gate), its ``seg_ckpt_1``."""
    reduce_depth(monkeypatch)
    cfg = port_trainer.SegConfig(save_path=str(tmp_path / "port"), **CFG)
    trainer = port_trainer.SegTrainer(
        cfg, synthetic_seg_dataset(4, hw=(SIZE + 8, SIZE + 8), classes=5),
        synthetic_seg_dataset(2, hw=(SIZE, SIZE), classes=5, seed=7),
        device="cpu")
    assert isinstance(trainer.model, PSPNet)
    trainer.train_epoch(0)
    assert trainer.state.step == 2 and sorted(trainer.gates) == [False, True]
    trainer.save_checkpoint(1)
    return trainer, os.path.join(cfg.save_path, "seg_ckpt_1")


def test_cli_seg_export_of_a_psp_checkpoint(psp_ckpt, tmp_path, capsys):
    trainer, ckpt = psp_ckpt
    out = str(tmp_path / "seg.pt2")
    cli.main(["seg-export", "--config", RECIPE, "--device", "cpu", "--out",
              out, "arch=psp", "classes=5", f"train_h={SIZE}",
              f"train_w={SIZE}", f"resume={ckpt}", "data_root=/nowhere"])
    printed = capsys.readouterr().out
    assert "exported" in printed and "arch=psp" in printed
    serve = load_artifact(out, device="cpu")
    model = trainer.state.model.eval()
    model.load_state_dict(load_checkpoint(ckpt)["state_dict"])
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, SIZE, SIZE, 3).astype(np.float32))
    with torch.no_grad():
        want = model(x)[0]
    torch.testing.assert_close(serve(x), want, rtol=1e-4, atol=1e-4)


def test_psp_checkpoint_resumes_in_jax(psp_ckpt, tmp_path):
    trainer, ckpt = psp_ckpt
    jcfg = jax_trainer.SegConfig(save_path=str(tmp_path / "jax"),
                                 num_devices=1, **CFG)
    jt = jax_trainer.SegTrainer(
        jcfg, jax_synthetic(4, hw=(SIZE + 8, SIZE + 8), classes=5),
        jax_synthetic(2, hw=(SIZE, SIZE), classes=5, seed=7))
    assert type(jt.model).__name__ == "PSPNet"
    jpath = _port_ckpt_to_jax(ckpt, jt, str(tmp_path / "to_jax"))
    assert jt.resume(jpath) == 1 and int(jt.state.step) == 2
    got = state_dict_from_jax(_np64(jt.state.params),
                              _np64(jt.state.batch_stats), SEG_KEY_MAP)
    want = trainer.state.model.state_dict()
    assert set(got) == {k for k in want if "num_batches" not in k}
    assert _worst(got, {k: v.double() for k, v in want.items()}) == 0
    val = jt.validate()
    assert np.isfinite(val["loss"]) and 0.0 <= val["mIoU"] <= 1.0
