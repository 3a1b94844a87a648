"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a GPU and skips without one.  The file imports
neither JAX nor the JAX package, so on a GPU machine without JAX it runs
with the JAX-pinning conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from cnsn_tpu_torch.ops import selfnorm_infer_cuda, selfnorm_infer_reference
from cnsn_tpu_torch.ops.kernels import LAUNCHES

pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="CUDA kernel: needs a GPU")

# fp32: the kernel sums in another order than the plain version (~1e-6
# relative over a few thousand rows); bf16: both round the same fp32
# product once, so they differ by at most one bf16 ulp (2^-7 relative)
# where the fp32 gates differ in the last bits.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}


def _inputs(shape, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 1.5 + 0.3).astype(np.float32))
    w = torch.from_numpy((rng.randn(c, 2) * 0.3).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
    b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    return x.cuda().to(dtype), w.cuda(), a.cuda(), b.cuda()


@pytest.mark.parametrize("shape", [(4, 56, 56, 256), (4, 7, 7, 2048),
                                   (3, 5, 7, 96), (2, 1, 1, 3),
                                   (1, 9, 9, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selfnorm_kernel_matches_plain(shape, dtype):
    """Ragged channel tiles (C=96, 33, 3) and row counts (1, 35, 81)."""
    x, w, a, b = _inputs(shape, 7, dtype)
    got = selfnorm_infer_cuda(x, w, a, b)
    want = selfnorm_infer_reference(x, w, a, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_op_on_cuda_launches_the_kernel():
    x, w, a, b = _inputs((2, 6, 6, 64), 3)
    before = LAUNCHES["selfnorm_infer"]
    got = torch.ops.cnsn_tpu_torch.selfnorm_infer(x, w, a, b, 1e-12)
    assert LAUNCHES["selfnorm_infer"] == before + 1
    torch.testing.assert_close(got, selfnorm_infer_reference(x, w, a, b),
                               **TOL[torch.float32])


def test_model_layout_is_zero_copy():
    """A channels_last NCHW activation's NHWC view is what the kernel takes."""
    x, w, a, b = _inputs((2, 5, 5, 16), 4)
    nchw = x.permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    got = selfnorm_infer_cuda(nchw.permute(0, 2, 3, 1), w, a, b)
    torch.testing.assert_close(got, selfnorm_infer_reference(x, w, a, b),
                               **TOL[torch.float32])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, a, b = _inputs((2, 5, 5, 16), 5)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        selfnorm_infer_cuda(x.permute(0, 2, 1, 3), w, a, b)
    with pytest.raises(ValueError, match="float32"):
        selfnorm_infer_cuda(x, w.double(), a, b)
    with pytest.raises(ValueError, match="shape"):
        selfnorm_infer_cuda(x, w[:8], a, b)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        selfnorm_infer_cuda(x.half(), w, a, b)
    with pytest.raises(ValueError, match="is on cpu"):
        selfnorm_infer_cuda(x, w, a.cpu(), b)
