"""The port's PSANet with ``compact`` attention (the (h·w, h·w) map read
from the attention conv by a reshape) against the JAX package's, on the
CPU, in float64, at psa_type 0, 1 and 2: ``test_torch_psa_models.py``'s
check, in a file of its own to spread the XLA compiles."""
import pytest

from test_torch_psa_models import check_psanet
from test_torch_psp_models import small  # noqa: F401 (a fixture)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("psa_type", [0, 1, 2])
def test_compact_psanet_matches_jax(psa_type, small):
    check_psanet(psa_type, True, small)
