"""The port's AllConvNet against the JAX package's on the CPU, in float64:
a train-mode forward with CrossNorm sites on and one ``cn`` SGD step of
its cnsn.yaml, JAX's draws fed to the port, at every CNSN position.
AllConvNet at its full widths (32²), at pos 1, 2 and 3; the checks, sizes and bounds are
``tests/test_torch_cifar_models.py``'s (one compiled JAX program a
position, shared by the two tests).
"""
import pytest

from test_torch_cifar_models import check_sgd_step, check_train_forward
from test_torch_threads import one_thread  # noqa: F401 (autouse)

POSITIONS = [1, 2, 3]


@pytest.mark.parametrize("pos", POSITIONS)
def test_train_forward_with_crossnorm_on_matches_jax(pos, monkeypatch):
    check_train_forward("allconv", pos, monkeypatch)


@pytest.mark.parametrize("pos", POSITIONS)
def test_one_sgd_step_matches_jax(pos, monkeypatch):
    check_sgd_step("allconv", pos, monkeypatch)
