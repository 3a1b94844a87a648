"""Port serving (cnsn_tpu_torch.serving / cli / config) on the CPU.

export → save → load round trip with a symbolic batch dimension; the
loaded artifact's logits equal the eager module's.  The recipe YAMLs of
the JAX package load through the port's config loader.
"""
import glob
import os

import numpy as np
import pytest
import torch

from cnsn_tpu_torch import build_classifier
from cnsn_tpu_torch.cli import main as cli_main
from cnsn_tpu_torch.config import apply_overrides, load_config
from cnsn_tpu_torch.serving import (export_classifier, load_artifact,
                                    save_artifact)

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cnsn_tpu", "configs")


@pytest.fixture(scope="module")
def small_sn_model():
    return build_classifier("resnet50", 10, device="cpu", seed=3,
                            layers=(1, 1, 1, 1), pos="post", cnsn_type="sn")


def test_export_roundtrip_two_batch_sizes(small_sn_model, tmp_path):
    path = str(tmp_path / "rn_sn.pt2")
    save_artifact(export_classifier(small_sn_model, image_size=32), path)
    serve = load_artifact(path, device="cpu")
    for b in (1, 5):
        x = torch.from_numpy(np.random.RandomState(b).randn(b, 32, 32, 3)
                             .astype(np.float32))
        with torch.no_grad():
            want = small_sn_model(x)
        got = serve(x)
        assert got.shape == (b, 10)
        # the artifact runs the same aten ops and the same SelfNorm op
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_exported_graph_keeps_selfnorm_op(small_sn_model):
    ep = export_classifier(small_sn_model, image_size=32)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert sum("cnsn_tpu_torch.selfnorm_infer" in t for t in targets) == 4


def test_load_artifact_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(str(tmp_path / "missing.pt2"))


def test_every_recipe_yaml_loads():
    paths = glob.glob(os.path.join(_CONFIGS, "**", "*.yaml"), recursive=True)
    assert len(paths) > 40
    for p in paths:
        assert isinstance(load_config(p).num_classes, int)
    cfg = load_config(os.path.join(_CONFIGS, "imagenet", "resnet50",
                                   "sn.yaml"))
    assert (cfg.model, cfg.num_classes, cfg.cnsn_type, cfg.pos) == (
        "resnet50", 1000, "sn", "post")
    assert cfg.resolved_image_size == 224
    assert cfg.schedule == "imagenet_step"
    cfg = apply_overrides(cfg, ["compute_dtype=bf16", "image_size=64",
                                "dataset=cifar100", "lr=0.5"])
    assert (cfg.compute_dtype, cfg.image_size, cfg.num_classes,
            cfg.lr) == ("bf16", 64, 100, 0.5)


def test_cli_export(tmp_path, capsys):
    out = str(tmp_path / "m.pt2")
    cli_main(["export", "--config",
              os.path.join(_CONFIGS, "imagenet", "resnet50", "sn.yaml"),
              "--out", out, "--device", "cpu", "--seed", "1",
              "image_size=32", "dataset=cifar10"])
    assert "exported" in capsys.readouterr().out
    serve = load_artifact(out, device="cpu")
    want = build_classifier("resnet50", 10, device="cpu", seed=1,
                            pos="post", cnsn_type="sn")
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        torch.testing.assert_close(serve(x), want(x), rtol=1e-6, atol=1e-6)
