"""The port's ``cli train``/``eval``/``export`` on the CPU and the
Trainer's CIFAR-C evaluation, at the reduced WRN of
tests/test_torch_trainer.py (its fixture and helpers; split from it so
that the two files balance over the test workers)."""
import glob
import os
import re

import numpy as np
import torch

from cnsn_tpu_torch import cli
from cnsn_tpu_torch.data import cifar
from cnsn_tpu_torch.serving import load_artifact
from cnsn_tpu_torch.train.trainer import Trainer
from cnsn_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_trainer import CNSN, _configs, small  # noqa: F401 (fixture)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def test_cli_train_eval_export_on_the_cpu(small, tmp_path, capsys):
    """cli train (two epochs, b=64 on the synthetic set), then eval
    resume=<last> prints the last row's Test Error, and export resume=
    serves the checkpoint's eager logits."""
    common = ["--config", CNSN, "--device", "cpu", "synthetic_data=true",
              "batch_size=64", "eval_batch_size=200"]
    cli.main(["train", *common, "epochs=2", f"exp_dir={tmp_path}/exp"])
    [exp_dir] = glob.glob(f"{tmp_path}/exp/*/*")
    files = os.listdir(exp_dir)
    assert {"log.txt", "WideResNet_last_ckpt", "WideResNet_best_ckpt",
            "config.yaml"} <= set(files)
    assert any(f.startswith("code-") for f in files)
    [tee] = [f for f in files if f.startswith("train-")]
    assert "Train Loss" in open(os.path.join(exp_dir, tee)).read()
    rows = open(os.path.join(exp_dir, "log.txt")).read().splitlines()[6:]
    assert len(rows) == 2
    last = os.path.join(exp_dir, "WideResNet_last_ckpt")
    capsys.readouterr()
    cli.main(["eval", *common, f"resume={last}"])
    out = capsys.readouterr().out
    assert re.search(r"Test Error (\S+)", out).group(1) == \
        rows[-1].split("\t")[3]
    art = str(tmp_path / "m.pt2")
    cli.main(["export", *common, f"resume={last}", "--out", art])
    model = small("wideresnet", 10, pos="post", crop="both", beta=1,
                  cnsn_type="cnsn")
    model.load_state_dict(load_checkpoint(last)["state_dict"])
    x = torch.from_numpy(np.random.RandomState(3).randn(
        5, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        want = model.eval()(x)
    torch.testing.assert_close(load_artifact(art, device="cpu")(x), want,
                               rtol=1e-5, atol=1e-5)


def test_test_corruptions_over_cifar_c(small, tmp_path, capsys):
    """The Trainer's CIFAR-C evaluation: the 15 corruptions of fake .npy
    files, each printed with its error, and the mean corruption error."""
    rng = np.random.RandomState(11)
    np.save(tmp_path / "labels.npy", rng.randint(0, 10, 20))
    for c in cifar.CORRUPTIONS:
        np.save(tmp_path / f"{c}.npy",
                rng.randint(0, 256, (20, 32, 32, 3), np.uint8))
    cfg, _ = _configs(CNSN, tmp_path, corrupt_data_dir=str(tmp_path))
    t = Trainer(cfg, device="cpu")
    capsys.readouterr()
    acc = t.test_corruptions()
    out = capsys.readouterr().out
    assert 0.0 <= acc <= 1.0
    assert all(c in out for c in cifar.CORRUPTIONS)
    assert f"Mean Corruption Error: {100 - 100. * acc:.3f}" in out
