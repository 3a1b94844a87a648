"""Port ops (cnsn_tpu_torch.ops) against the JAX package's ops.

Inputs are made with numpy from a seed and handed to both.  The Pallas
SelfNorm kernel runs in interpret mode on the CPU, as tests/test_pallas.py
runs it.  The CUDA kernel is compared with its plain version on the card
in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cnsn_tpu.ops.pallas.selfnorm import (selfnorm_infer_pallas,
                                          selfnorm_infer_reference as
                                          jax_selfnorm_reference)
from cnsn_tpu.ops.stats import instance_mean_std as jax_instance_mean_std
from cnsn_tpu_torch.ops import (instance_mean_std, selfnorm_infer,
                                selfnorm_infer_cuda,
                                selfnorm_infer_reference)
from cnsn_tpu_torch.ops.kernels import LAUNCHES
from test_torch_threads import one_thread  # noqa: F401 (autouse)


# fp32 ops: the two frameworks sum in other orders, ~1e-6 relative per
# reduction over a few hundred elements; 1e-5 leaves headroom.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# one bf16 ulp: 7 stored mantissa bits, so at most 2^-7 of the value
BF16_ULP = 2 ** -7


def _sn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    w = (rng.randn(c, 2) * 0.3).astype(np.float32)
    a = rng.uniform(0.5, 2.0, c).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, w, a, b


def _bf16_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("c", [3, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_mean_std_matches_jax(c, dtype):
    x = np.random.RandomState(c).randn(2, 7, 9, c).astype(np.float32) + 0.5
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # stats in fp32 for both: compare before any cast back to bf16
    jm, js = jax_instance_mean_std(jx, out_dtype=jnp.float32)
    tm, ts = instance_mean_std(tx, out_dtype=torch.float32)
    assert tm.shape == (2, 1, 1, c) and tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **F32_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32_TOL)
    # default out_dtype is the input's, as in JAX
    assert instance_mean_std(tx)[0].dtype == tx.dtype


@pytest.mark.parametrize("shape", [(3, 14, 14, 128), (2, 7, 7, 256)])
def test_selfnorm_reference_matches_pallas_f32(shape):
    x, w, a, b = _sn_inputs(shape, seed=shape[-1])
    got = selfnorm_infer_reference(*map(torch.from_numpy, (x, w, a, b)))
    jargs = tuple(map(jnp.asarray, (x, w, a, b)))
    kern = selfnorm_infer_pallas(*jargs, interpret=True)
    ref = jax_selfnorm_reference(*jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("shape", [(3, 14, 14, 128), (2, 7, 7, 256)])
def test_selfnorm_reference_matches_pallas_bf16(shape):
    """In bf16 the port rounds as the Pallas kernel does (x·g in fp32,
    then one cast): equal up to 1 bf16 ulp (at most 2^-7 relative) where
    the fp32 gates differ in the last bits and the product lands on a
    rounding boundary."""
    x, w, a, b = _sn_inputs(shape, seed=shape[-1] + 1)
    xb = torch.from_numpy(x).bfloat16()
    got = selfnorm_infer_reference(xb, *map(torch.from_numpy, (w, a, b)))
    assert got.dtype == torch.bfloat16
    kern = selfnorm_infer_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                 *map(jnp.asarray, (w, a, b)),
                                 interpret=True)
    np.testing.assert_allclose(_bf16_np(got),
                               np.asarray(kern.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-6)


def test_selfnorm_reference_c96_matches_jax():
    """C=96 is not a multiple of 128 (the Pallas lane tile): held to the
    JAX plain reference only."""
    x, w, a, b = _sn_inputs((2, 9, 11, 96), seed=96)
    got = selfnorm_infer_reference(*map(torch.from_numpy, (x, w, a, b)))
    ref = jax_selfnorm_reference(*map(jnp.asarray, (x, w, a, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_selfnorm_op_on_cpu_runs_plain_version():
    """The registered op takes the plain version for CPU tensors and
    launches (counts) nothing."""
    x, w, a, b = map(torch.from_numpy, _sn_inputs((2, 5, 5, 32), seed=5))
    before = LAUNCHES["selfnorm_infer"]
    got = torch.ops.cnsn_tpu_torch.selfnorm_infer(x, w, a, b, 1e-12)
    torch.testing.assert_close(got, selfnorm_infer_reference(x, w, a, b),
                               rtol=0, atol=0)
    assert LAUNCHES["selfnorm_infer"] == before
    torch.testing.assert_close(selfnorm_infer(x, w, a, b), got, rtol=0,
                               atol=0)


def test_selfnorm_cuda_wrapper_rejects_cpu_tensor():
    """A CPU tensor never reaches the CUDA wrapper's launch."""
    x, w, a, b = map(torch.from_numpy, _sn_inputs((1, 3, 3, 8), seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        selfnorm_infer_cuda(x, w, a, b)

