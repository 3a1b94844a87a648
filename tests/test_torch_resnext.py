"""The port's ResNeXt against the JAX package's on the CPU, in float64:
a train-mode forward with CrossNorm sites on and one ``cn`` SGD step of
its cnsn.yaml, JAX's draws fed to the port, at every CNSN position.
ResNeXt at depth 11 (a downsample in every block: 'identity' shows the
reference's quirk), at every position; the checks, sizes and bounds are
``tests/test_torch_cifar_models.py``'s (one compiled JAX program a
position, shared by the two tests).
"""
import pytest

from test_torch_cifar_models import check_sgd_step, check_train_forward
from test_torch_threads import one_thread  # noqa: F401 (autouse)

POSITIONS = ["residual", "identity", "pre", "post"]


@pytest.mark.parametrize("pos", POSITIONS)
def test_train_forward_with_crossnorm_on_matches_jax(pos, monkeypatch):
    check_train_forward("resnext", pos, monkeypatch)


@pytest.mark.parametrize("pos", POSITIONS)
def test_one_sgd_step_matches_jax(pos, monkeypatch):
    check_sgd_step("resnext", pos, monkeypatch)
