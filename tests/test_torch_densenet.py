"""The port's DenseNet against the JAX package's on the CPU, in float64:
a train-mode forward with CrossNorm sites on and one ``cn`` SGD step of
its cnsn.yaml, JAX's draws fed to the port, at every CNSN position.
DenseNet at depth 7 (C = 24, 36, 48: C ≡ 4 mod 8 at 36), at 'conv1_pre' and
'conv1_post'; the checks, sizes and bounds are
``tests/test_torch_cifar_models.py``'s (one compiled JAX program a
position, shared by the two tests).
"""
import pytest

from test_torch_cifar_models import check_sgd_step, check_train_forward
from test_torch_threads import one_thread  # noqa: F401 (autouse)

POSITIONS = ["conv1_pre", "conv1_post"]


@pytest.mark.parametrize("pos", POSITIONS)
def test_train_forward_with_crossnorm_on_matches_jax(pos, monkeypatch):
    check_train_forward("densenet", pos, monkeypatch)


@pytest.mark.parametrize("pos", POSITIONS)
def test_one_sgd_step_matches_jax(pos, monkeypatch):
    check_sgd_step("densenet", pos, monkeypatch)
