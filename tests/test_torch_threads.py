"""One intra-op thread for the port's CPU test files.

Beside the other test workers, torch's default pool (a thread a core in
each worker) oversubscribes the cores.  A test file takes the module-wide
autouse fixture ``one_thread`` by importing it; the count is put back
when the file is done, so that files which do not take it (the float32
trajectory of ``test_torch_train_steps.py``, whose rounding is held
against JAX's at the default count) run as they always have.  This file
imports no JAX: the card tests' JAX-free files take it as well."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_holds_for_the_module():
    assert torch.get_num_threads() == 1
