"""K1's plain versions (cnsn_tpu_torch.ops.kernels.ins_stats) against the
JAX package's instance-statistics kernels, on the CPU.

The Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them: ``ins_stats_v2`` (C a multiple of 128), ``ins_stats_pallas`` (v1,
any C, here the C=3 image planes) and the custom VJP of
``ins_stats_diff``.  Inputs are made with numpy from a seed and handed to
both.  Both sides accumulate in fp32 in other orders: 1e-5 relative.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.ops.pallas.ins_stats import (ins_stats_diff, ins_stats_pallas,
                                           ins_stats_v2)
from cnsn_tpu_torch.ops import (InsStats, ins_stats_bwd_reference,
                                ins_stats_reference, instance_mean_std)
from cnsn_tpu_torch.ops.kernels import LAUNCHES
from test_torch_threads import one_thread  # noqa: F401 (autouse)


TOL = dict(rtol=1e-5, atol=1e-6)
# (H, W): one row, a 7x7 plane, and an odd ragged 5x7
PLANES = [(1, 1), (7, 7), (5, 7)]


def _x(shape, seed, dtype):
    x = (np.random.RandomState(seed).randn(*shape) * 1.5 + 0.3).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("hw", PLANES)
@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_ins_stats_v2(hw, c, dtype):
    jx, tx = _x((3,) + hw + (c,), c + hw[1], dtype)
    jm, js = ins_stats_v2(jx, interpret=True)
    tm, ts = ins_stats_reference(tx)
    assert tm.shape == (3, c) and tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("hw", [(1, 1), (7, 7), (5, 7), (16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_ins_stats_pallas_c3(hw, dtype):
    """The image-CrossNorm statistics: C=3 planes, through the v1 kernel
    (its chunked HW grid and masked tail).  The one-pass variance
    E[x²]−mean² is known only to the rounding of E[x²]; at HW=1 it is that
    rounding alone (0 in the port, which rounds both squares; ±ulp(x²)
    where XLA fuses mean² into an FMA), so variances are held to 1e-5
    relative plus two fp32 roundings of the largest x²."""
    jx, tx = _x((4,) + hw + (3,), hw[0] * hw[1], dtype)
    jm, js = ins_stats_pallas(jx, interpret=True)
    tm, ts = ins_stats_reference(tx)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    x2 = float(tx.float().square().max())
    np.testing.assert_allclose(ts.numpy() ** 2, np.asarray(js) ** 2,
                               rtol=1e-5, atol=2 * 2.0 ** -24 * x2)


@pytest.mark.parametrize("hw", PLANES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_insstats_autograd_matches_jax_vjp(hw, dtype):
    """InsStats on the CPU (plain forward and backward) against
    jax.vjp of ins_stats_diff (the v2 kernel and its analytic VJP); the
    cotangents are numpy draws handed to both."""
    c = 128
    jx, tx = _x((2,) + hw + (c,), 40 + hw[1], dtype)
    rng = np.random.RandomState(41)
    gm = rng.randn(2, c).astype(np.float32)
    gs = rng.randn(2, c).astype(np.float32)
    (jm, js), vjp = jax.vjp(lambda x: ins_stats_diff(x, 1e-5, 1, True), jx)
    (jdx,) = vjp((jnp.asarray(gm), jnp.asarray(gs)))

    tx.requires_grad_()
    tm, ts = InsStats.apply(tx, 1e-5, 1)
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **TOL)
    (tm * torch.from_numpy(gm) + ts * torch.from_numpy(gs)).sum().backward()
    assert tx.grad.dtype == tx.dtype
    want = np.asarray(jdx.astype(jnp.float32))
    got = tx.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    else:
        # both round one fp32 value to bf16: equal, or one ulp apart where
        # the fp32 values differ in the last bits across a rounding edge
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=1e-6 * np.abs(want).max())


def test_backward_reference_is_the_analytic_vjp():
    """ins_stats_bwd_reference against autograd of the plain forward, in
    float64 so the comparison sees the formula and not rounding."""
    x = torch.from_numpy(np.random.RandomState(42).randn(2, 5, 3, 16))
    x.requires_grad_()
    gm, gs = torch.randn(2, 16, dtype=torch.float64), torch.randn(
        2, 16, dtype=torch.float64)
    mean, std = ins_stats_reference(x, eps=1e-5, ddof=1)
    (mean * gm + std * gs).sum().backward()
    got = ins_stats_bwd_reference(x.detach(), mean.detach(), std.detach(),
                                  gm, gs, ddof=1)
    torch.testing.assert_close(got, x.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_mean_std_on_cpu_takes_the_plain_version(dtype):
    """The (N, 1, 1, C) JAX contract, cast to x's type, and no kernel
    launch for a CPU tensor."""
    _, tx = _x((2, 4, 6, 8), 43, dtype)
    before = dict(LAUNCHES)
    mean, std = instance_mean_std(tx)
    assert dict(LAUNCHES) == before
    assert mean.shape == (2, 1, 1, 8) and mean.dtype == tx.dtype
    rm, rs = ins_stats_reference(tx)
    torch.testing.assert_close(mean, rm.reshape(2, 1, 1, 8).to(tx.dtype),
                               rtol=0, atol=0)
    torch.testing.assert_close(std, rs.reshape(2, 1, 1, 8).to(tx.dtype),
                               rtol=0, atol=0)


def test_cuda_wrappers_reject_a_cpu_tensor():
    from cnsn_tpu_torch.ops import ins_stats_bwd_cuda, ins_stats_cuda
    _, tx = _x((1, 3, 3, 8), 44, "float32")
    nc = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ins_stats_cuda(tx)
    with pytest.raises(ValueError, match="CUDA"):
        ins_stats_bwd_cuda(tx, nc, nc, nc, nc)
