"""The port stands alone: it runs with neither JAX, the JAX package nor
OpenCV imported, and its entry points do not fall back to the CPU."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cnsn_tpu", "cv2")


def test_port_runs_without_jax_in_a_fresh_process(tmp_path):
    code = textwrap.dedent("""
        import math, os, sys, torch
        torch.set_num_threads(1)  # beside the other test workers
        os.environ["CNSN_CONV3X3"] = "pallas"
        import cnsn_tpu_torch
        from cnsn_tpu_torch.ops.crossnorm import cross_norm_2ins
        from cnsn_tpu_torch.serving import export_classifier
        from cnsn_tpu_torch.train.steps import StepFns, create_train_state
        m = cnsn_tpu_torch.build_classifier(
            "resnet50", 10, device="cpu", layers=(1, 1, 1, 1),
            pos="post", cnsn_type="sn")
        with torch.no_grad():
            y = m(torch.randn(2, 32, 32, 3))
        assert y.shape == (2, 10) and bool(torch.isfinite(y).all())
        state = create_train_state(m, lambda step: 0.01, device="cpu")
        state, metrics = StepFns().cn_image(
            state, torch.randn(2, 32, 32, 3), torch.tensor([1, 2]),
            perm=torch.tensor([1, 0]))
        assert bool(torch.isfinite(metrics["loss"])) and state.step == 1
        wrn = cnsn_tpu_torch.models.build_model("wideresnet", 10,
                                                pos="pre", cnsn_type="sn")
        state = create_train_state(wrn, lambda step: 0.01, device="cpu")
        state, metrics = StepFns().plain(state, torch.randn(2, 8, 8, 3),
                                         torch.tensor([1, 2]))
        assert bool(torch.isfinite(metrics["loss"])) and state.step == 1
        state, metrics = StepFns(consist_wt=10.0).cn_image_consist(
            state, torch.randn(2, 8, 8, 3), torch.tensor([1, 2]))
        assert bool(torch.isfinite(metrics["jsd"])) and state.step == 2
        for name, pos in (("allconv", "1"), ("densenet", "conv1_pre"),
                          ("resnext", "post")):
            net = cnsn_tpu_torch.models.build_model(name, 10, pos=pos,
                                                    cnsn_type="cnsn")
            state = create_train_state(net, lambda step: 0.01, device="cpu")
            state, metrics = StepFns(consist_wt=10.0).cn_consistency(
                state, torch.randn(2, 32, 32, 3), torch.tensor([1, 2]),
                generator=torch.Generator().manual_seed(0))
            assert bool(torch.isfinite(metrics["loss"])) and state.step == 1
        ibn = cnsn_tpu_torch.models.build_model(
            "resnet50_ibn_b", 10, layers=(1, 1, 1, 1), pos="residual",
            cnsn_type="sn")
        state = create_train_state(ibn, lambda step: 0.01, device="cpu")
        state, metrics = StepFns().cn_image_augmix(
            state, torch.randn(3, 2, 64, 64, 3), torch.tensor([1, 2]),
            generator=torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(metrics["jsd"])) and state.step == 1
        import numpy as np
        from PIL import Image
        from cnsn_tpu_torch.data import (ImageNetLoader, augmix,
                                         imagenet_normalize, normalize,
                                         scan_image_folder, workers)
        from cnsn_tpu_torch.nn import IBN, InstanceNorm
        for c in ("a", "b"):
            os.makedirs(os.path.join(sys.argv[1], "img", c))
            Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(
                os.path.join(sys.argv[1], "img", c, "0.jpeg"))
        views, labels = next(iter(ImageNetLoader(
            scan_image_folder(os.path.join(sys.argv[1], "img")), 2,
            mode="train_augmix", image_size=32, workers=1)))
        assert views.shape == (3, 2, 32, 32, 3)
        assert sorted(labels.tolist()) == [0, 1]
        import cnsn_tpu_torch.train.trainer as trainer_mod
        from cnsn_tpu_torch import cli, data, evaluation
        from cnsn_tpu_torch.config import load_config
        from cnsn_tpu_torch.models.wideresnet import WideResNet
        from cnsn_tpu_torch.utils import (checkpoint, meters, metrics_io,
                                          prefetch, provenance)
        trainer_mod.build_model = lambda name, classes, num_groups=1, **kw: (
            WideResNet(depth=10, widen_factor=1, num_classes=classes,
                       **{k: v for k, v in kw.items() if v is not None}))
        cfg = load_config("cnsn_tpu/configs/cifar10/wideresnet/cnsn.yaml",
                          synthetic_data=True, batch_size=16, snapshot=False,
                          exp_dir=sys.argv[1], print_freq=100)
        t = trainer_mod.Trainer(cfg, device="cpu")
        t.train_loader = data.CifarLoader(
            data.load_cifar("", synthetic=True, synthetic_size=32), 16)
        assert math.isfinite(t.train_epoch())
        assert t.state.step == 2
        from cnsn_tpu_torch.segmentation import SegResNet, SegStepFns
        from cnsn_tpu_torch.segmentation import data as seg_data
        from cnsn_tpu_torch.segmentation import fcn as seg_fcn
        from cnsn_tpu_torch.segmentation.train_seg import (
            create_seg_train_state)
        from cnsn_tpu_torch.segmentation.trainer import (
            SegConfig, default_train_transform)
        seg_fcn.seg_resnet50 = lambda **kw: SegResNet(layers=(1, 1, 1, 1),
                                                      **kw)
        seg = seg_fcn.fcn_cnsn(5)
        state = create_seg_train_state(seg, 0.01, 10, device="cpu")
        image, label = seg_data.synthetic_seg_dataset(
            1, hw=(49, 49), classes=5).load(0)
        image, label = default_train_transform(SegConfig(
            train_h=41, train_w=41))(np.random.RandomState(0), image, label)
        state, metrics = SegStepFns(seg, num_classes=5).aug(
            state, torch.from_numpy(image)[None].repeat(2, 1, 1, 1),
            torch.from_numpy(label)[None].repeat(2, 1, 1),
            generator=torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(metrics["loss"])) and state.step == 1
        from cnsn_tpu_torch.parallel import (DataParallel, RankPool,
                                             initialize, make_mesh)
        assert make_mesh().size == 1
        from cnsn_tpu_torch.segmentation import pspnet as seg_psp
        from cnsn_tpu_torch.segmentation import vis as seg_vis
        from cnsn_tpu_torch.serving import export_segmenter, load_artifact
        seg_psp.seg_resnet50 = seg_fcn.seg_resnet50
        for net in (seg_psp.PSPNet(5, cnsn_type="cnsn", block_idxs="1_2",
                                   pos="residual", cn_pos="post",
                                   crop="style"),
                    seg_psp.PSANet(5, image_hw=(41, 41), compact=True,
                                   shrink_factor=5),
                    seg_psp.PSALite(5, image_hw=(41, 41))):
            state = create_seg_train_state(net, 0.01, 10, device="cpu")
            state, metrics = SegStepFns(net, num_classes=5).aug(
                state, torch.from_numpy(image)[None].repeat(2, 1, 1, 1),
                torch.from_numpy(label)[None].repeat(2, 1, 1),
                generator=torch.Generator().manual_seed(0))
            assert bool(torch.isfinite(metrics["loss"]))
        assert seg_vis.colorize(label).shape == (41, 41, 3)
        out = os.path.join(sys.argv[1], "seg.pt2")
        cli.main(["seg-export", "--config",
                  "cnsn_tpu/configs/segmentation/gtav_fcn50_cnsn.yaml",
                  "--device", "cpu", "--out", out, "arch=psp",
                  "train_h=33", "train_w=33"])
        assert load_artifact(out, "cpu")(torch.zeros(1, 33, 33, 3)).shape \
            == (1, 33, 33, 19)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "optax", "cnsn_tpu", "cv2"))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(_ROOT, "cnsn_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_ROOT, "chip_smoke.py"))
    assert len(files) > 15
    assert any(os.sep + "segmentation" + os.sep in f for f in files)
    assert any(os.sep + "parallel" + os.sep in f for f in files)
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in _FORBIDDEN, (path, mod)


def test_build_classifier_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error")
    from cnsn_tpu_torch import build_classifier
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_classifier("resnet50", 10, layers=(1, 1, 1, 1))
