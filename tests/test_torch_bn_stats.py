"""K2's plain versions (cnsn_tpu_torch.ops.kernels.bn_stats) against the
JAX package's BatchNorm-sums kernel, on the CPU.

``bn_sums_pallas`` runs in interpret mode, as tests/test_pallas.py runs
it, and its backward is ``jax.vjp`` of ``bn_sums``.  Inputs are numpy
draws from a seed; the shift m0 is a warm, nonzero running mean.  The
sums are held to 1e-5 of Σ|x−m0| per channel (s1 may cancel to near 0,
so a relative bound on s1 itself would ask for more than fp32 sums in
two orders can give) and to 1e-5 of s2.  The CUDA kernels are held
against these plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.ops.pallas.bn_stats import bn_sums, bn_sums_pallas
from cnsn_tpu_torch.ops import (BnSums, bn_sums_bwd_cuda,
                                bn_sums_bwd_reference, bn_sums_cuda,
                                bn_sums_reference)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


# C=64 takes the JAX kernel's lane-fold branch; 105 and 63 rows are
# ragged against its chunks (and 63 does not fold); C=3 is the image
SHAPES = [(4, 9, 7, 64), (3, 5, 7, 128), (2, 56, 56, 64), (1, 7, 9, 64),
          (3, 5, 5, 256), (2, 6, 6, 3)]


def _inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 1.5).astype(np.float32)
    m0 = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx, m0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_bn_sums_pallas(shape, dtype):
    jx, tx, m0 = _inputs(shape, shape[1] * shape[3], dtype)
    j1, j2 = bn_sums_pallas(jx, jnp.asarray(m0), interpret=True)
    t1, t2 = bn_sums_reference(tx, torch.from_numpy(m0))
    assert t1.shape == (shape[-1],) and t1.dtype == torch.float32
    abs_sum = (tx.float() - torch.from_numpy(m0)).abs().sum(
        dim=(0, 1, 2)).numpy()
    assert np.all(np.abs(t1.numpy() - np.asarray(j1)) <= 1e-5 * abs_sum)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bnsums_autograd_matches_jax_vjp(shape, dtype):
    """BnSums on the CPU against jax.vjp of bn_sums (interpret mode): the
    same sums, and the same dx = g1 + 2(x−m0)·g2 for numpy cotangents.
    dx is one fp32 expression per element, rounded to x's type: 1e-6 of
    its scale in fp32, one bf16 ulp in bf16."""
    c = shape[-1]
    jx, tx, m0 = _inputs(shape, 7 + c, dtype)
    rng = np.random.RandomState(8)
    g1 = rng.randn(c).astype(np.float32)
    g2 = (rng.randn(c) * 0.1).astype(np.float32)
    (j1, j2), vjp = jax.vjp(lambda x: bn_sums(x, jnp.asarray(m0), True), jx)
    (jdx,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))

    tx.requires_grad_()
    t1, t2 = BnSums.apply(tx, torch.from_numpy(m0))
    np.testing.assert_allclose(t2.detach().numpy(), np.asarray(j2),
                               rtol=1e-5)
    (t1 * torch.from_numpy(g1) + t2 * torch.from_numpy(g2)).sum().backward()
    assert tx.grad.dtype == tx.dtype and tx.grad.shape == shape
    want = np.asarray(jdx.astype(jnp.float32))
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(tx.grad.float().numpy(), want, rtol=rtol,
                               atol=1e-6 * np.abs(want).max())


def test_backward_reference_is_the_vjp_of_the_plain_forward():
    """In float64, so the comparison sees the formula, not rounding."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(2, 3, 4, 5)).requires_grad_()
    m0 = torch.from_numpy(rng.randn(5))
    g1, g2 = torch.from_numpy(rng.randn(5)), torch.from_numpy(rng.randn(5))
    s1, s2 = bn_sums_reference(x, m0)
    (s1 * g1 + s2 * g2).sum().backward()
    got = bn_sums_bwd_reference(x.detach(), m0, g1, g2)
    torch.testing.assert_close(got, x.grad, rtol=1e-12, atol=1e-12)


def test_cuda_wrappers_reject_a_cpu_tensor():
    _, tx, m0 = _inputs((1, 3, 3, 8), 10, "float32")
    m = torch.from_numpy(m0)
    with pytest.raises(ValueError, match="CUDA"):
        bn_sums_cuda(tx, m)
    with pytest.raises(ValueError, match="CUDA"):
        bn_sums_bwd_cuda(tx, m, m, m)
