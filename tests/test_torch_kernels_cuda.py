"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither JAX nor the JAX package, so on a GPU machine without JAX
it runs with the JAX-pinning conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cnsn_tpu_torch.ops import (BnSums, InsStats, bn_sums_bwd_cuda,
                                bn_sums_bwd_reference, bn_sums_cuda,
                                bn_sums_reference, ins_stats_bwd_cuda,
                                ins_stats_bwd_reference, ins_stats_cuda,
                                ins_stats_reference, instance_mean_std,
                                selfnorm_infer_cuda, selfnorm_infer_reference,
                                selfnorm_path, wgrad3x3_cuda, wgrad3x3_path,
                                wgrad3x3_reference)
from cnsn_tpu_torch.ops.convdot import Conv2dCustomBwd
from cnsn_tpu_torch.ops.kernels import LAUNCHES
from cnsn_tpu_torch.ops.kernels import bn_stats, ins_stats
from cnsn_tpu_torch.ops.kernels.bn_stats import bn_sums_plan
from cnsn_tpu_torch.ops.kernels.conv_wgrad import PATHS, _kernels
from cnsn_tpu_torch.ops.kernels.selfnorm import PATHS as SN_PATHS
from cnsn_tpu_torch.ops.kernels.selfnorm import _launch as sn_launch
from cnsn_tpu_torch.ops.kernels.selfnorm import selfnorm_plan

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs a GPU")

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
    key = SN_PATHS[selfnorm_path(x)][1]
    before = LAUNCHES[key]
    got = torch.ops.cnsn_tpu_torch.selfnorm_infer(x, w, a, b, 1e-12)
    assert LAUNCHES[key] == before + 1
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


# K1 and K2 shapes: ragged channel tiles and vector widths (C=96, 33, 3),
# row counts of 1, odd and large, the C=3 image plane of 224², and the
# widest and narrowest ResNet-50 channel counts.
STAT_SHAPES = [(4, 56, 56, 256), (4, 7, 7, 2048), (3, 5, 7, 96),
               (2, 1, 1, 3), (1, 9, 9, 33), (2, 224, 224, 3),
               (8, 56, 56, 64)]


def _x(shape, seed, dtype=torch.float32, offset=0.3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5 + offset).astype(np.float32)
    return torch.from_numpy(x).cuda().to(dtype)


def _vec(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).cuda()


def _close_to_scale(got, want, rtol):
    """Within rtol of the largest magnitude: outputs that sum and cancel
    in another order differ in absolute, not relative, terms."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


@pytest.mark.parametrize("shape", STAT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_stats_kernel_matches_plain(shape, dtype):
    """Both sum in fp32 from the same inputs, in other orders: 1e-5."""
    x = _x(shape, 11, dtype)
    got = ins_stats_cuda(x)
    want = ins_stats_reference(x)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == shape[:1] + shape[3:]
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw_side", [1, 7])
def test_ins_stats_constant_plane_has_zero_variance(hw_side):
    """A constant plane whose sums are exact: var is exactly 0, so
    std = sqrt(eps) even at SelfNorm's eps 1e-12 (an FMA-contracted
    E[x²] − mean² would give a negative variance, and NaN)."""
    x = torch.full((2, hw_side, hw_side, 40), 1.25, device="cuda")
    x[1] = -3.5
    mean, std = ins_stats_cuda(x, eps=1e-12)
    torch.testing.assert_close(mean, x[:, 0, 0, :], rtol=0, atol=0)
    torch.testing.assert_close(std, torch.full_like(std, 1e-6), rtol=0,
                               atol=0)


@pytest.mark.parametrize("shape", STAT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_stats_bwd_kernel_matches_plain(shape, dtype):
    """fp32: the same operations in the same order per element, 1e-6 of
    the gradient's scale; bf16: one rounding of those, one bf16 ulp."""
    n, _, _, c = shape
    x = _x(shape, 12, dtype)
    mean, std = ins_stats_reference(x)
    gm, gs = _vec((n, c), 13), _vec((n, c), 14)
    got = ins_stats_bwd_cuda(x, mean, std, gm, gs)
    want = ins_stats_bwd_reference(x, mean, std, gm, gs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == shape and got.is_contiguous()
    _close_to_scale(got, want, 1e-6 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("shape", STAT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_kernel_matches_plain(shape, dtype):
    """Held to 1e-5 of Σ|x−m0| (s1) and of Σ(x−m0)² (s2): sums of up to
    ~1e5 fp32 terms in other orders, where s1 may cancel to near 0."""
    x = _x(shape, 15, dtype, offset=1.0)
    m0 = _vec(shape[-1:], 16, scale=0.5)  # a warm running mean
    s1, s2 = bn_sums_cuda(x, m0)
    w1, w2 = bn_sums_reference(x, m0)
    torch.cuda.synchronize()
    d = x.float() - m0
    assert (s1 - w1).abs().max() <= 1e-5 * d.abs().sum(dim=(0, 1, 2)).max()
    assert (s2 - w2).abs().max() <= 1e-5 * w2.max()


@pytest.mark.parametrize("shape", STAT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_bwd_kernel_matches_plain(shape, dtype):
    """The kernel rounds each product and sum as the plain version does."""
    c = shape[-1]
    x = _x(shape, 17, dtype)
    m0, g1, g2 = _vec((c,), 18, 0.5), _vec((c,), 19), _vec((c,), 20)
    got = bn_sums_bwd_cuda(x, m0, g1, g2)
    want = bn_sums_bwd_reference(x, m0, g1, g2)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == shape
    _close_to_scale(got, want, 1e-6 if dtype == torch.float32 else 2 ** -7)


def test_bn_sums_is_deterministic_and_takes_unaligned_rows():
    """The same inputs give the same bits; an x that starts off a
    16-byte boundary takes the one-element loads and agrees with the
    16-byte-load kernel."""
    base = _x((4 * 28 * 28 * 128 + 1,), 21)
    m0 = _vec((128,), 22)
    aligned = base[:-1].view(4, 28, 28, 128)
    shifted = base[1:].view(4, 28, 28, 128).clone()
    a1 = bn_sums_cuda(aligned, m0)
    a2 = bn_sums_cuda(aligned, m0)
    for u, v in zip(a1, a2):
        assert torch.equal(u, v)
    unaligned = base[1:].view(4, 28, 28, 128)
    assert unaligned.data_ptr() % 16 != 0
    for u, v in zip(bn_sums_cuda(unaligned, m0), bn_sums_cuda(shifted, m0)):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_stats_function_matches_autograd_of_plain(dtype):
    x = _x((3, 14, 14, 256), 23, dtype).requires_grad_()
    c1, c2 = _vec((3, 256), 24), _vec((3, 256), 25)
    mean, std = InsStats.apply(x, 1e-5, 1)
    (mean * c1 + std * c2).sum().backward()
    got = x.grad
    x.grad = None
    rm, rs = ins_stats_reference(x)
    (rm * c1 + rs * c2).sum().backward()
    _close_to_scale(got, x.grad, 1e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_function_matches_autograd_of_plain(dtype):
    x = _x((4, 14, 14, 64), 26, dtype).requires_grad_()
    m0, c1, c2 = _vec((64,), 27, 0.5), _vec((64,), 28), _vec((64,), 29)
    s1, s2 = BnSums.apply(x, m0)
    (s1 * c1 + 1e-2 * s2 * c2).sum().backward()
    got = x.grad
    x.grad = None
    r1, r2 = bn_sums_reference(x, m0)
    (r1 * c1 + 1e-2 * r2 * c2).sum().backward()
    _close_to_scale(got, x.grad, 1e-6 if dtype == torch.float32 else 2 ** -7)


def test_launch_counters_count_each_wrapper_call():
    x = _x((2, 6, 6, 64), 30).requires_grad_()
    m0 = _vec((64,), 31)
    before = dict(LAUNCHES)
    mean, std = instance_mean_std(x)
    s1, s2 = BnSums.apply(x, m0)
    (mean.sum() + std.sum() + s1.sum() + s2.sum()).backward()
    for name in ("ins_stats", "ins_stats_bwd", "bn_sums", "bn_sums_bwd"):
        assert LAUNCHES[name] == before.get(name, 0) + 1, name


def test_stats_wrappers_reject_what_the_kernels_do_not_take():
    x = _x((2, 5, 5, 16), 32)
    m0 = _vec((16,), 33)
    nc = _vec((2, 16), 34)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        ins_stats_cuda(x.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        bn_sums_cuda(x.permute(0, 2, 1, 3), m0)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        ins_stats_cuda(x.half())
    with pytest.raises(ValueError, match="float32/bfloat16"):
        bn_sums_cuda(x.double(), m0)
    with pytest.raises(ValueError, match="4-D"):
        ins_stats_cuda(x[0])
    with pytest.raises(ValueError, match="CUDA"):
        bn_sums_cuda(x.cpu(), m0.cpu())
    with pytest.raises(ValueError, match="m0 must be float32"):
        bn_sums_cuda(x, m0[:8])
    with pytest.raises(ValueError, match="is on cpu"):
        bn_sums_bwd_cuda(x, m0, m0.cpu(), m0)
    with pytest.raises(ValueError, match="gs must be float32"):
        ins_stats_bwd_cuda(x, nc, nc, nc, nc.double())
    with pytest.raises(ValueError, match="contiguous"):
        ins_stats_bwd_cuda(x, nc, nc, nc, _vec((16, 2), 35).t())


# K4 at the (H, Cin, Cout) of every stride-1 3x3 conv of WRN-40-2 (32x32
# input) and ResNet-50 (224x224), at a small batch.
K4_SHAPES = [(32, 3, 16), (32, 16, 32), (32, 32, 32), (16, 64, 64),
             (8, 128, 128), (56, 64, 64), (28, 128, 128), (14, 256, 256),
             (7, 512, 512)]


def _k4_close(got, x, dy):
    """Within 1e-5 of Σ|x|·|dy| per element: both sum exact (bf16) or
    singly rounded (fp32) products in fp32, in other orders; the rounding
    of such sums stays near 1e-7 of that scale, where a misplaced tap or
    channel is off by the whole gradient."""
    want = wgrad3x3_reference(x, dy)
    scale = wgrad3x3_reference(x.abs(), dy.abs())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= 1e-5 * scale).all()), err.max().item()


@pytest.mark.parametrize("h,cin,cout", K4_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad3x3_kernel_matches_plain(h, cin, cout, dtype):
    x = _x((4, h, h, cin), 40, dtype)
    dy = _x((4, h, h, cout), 41, dtype, offset=0.0)
    got = wgrad3x3_cuda(x, dy)
    torch.cuda.synchronize()
    _k4_close(got, x, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad3x3_odd_shapes_and_unaligned_x(dtype):
    """Cin=3 with an odd plane (one-element loads, ragged tiles at both
    channel edges), then an x that starts off a 16-byte boundary."""
    x = _x((3, 5, 7, 3), 42, dtype)
    dy = _x((3, 5, 7, 70), 43, dtype, offset=0.0)
    _k4_close(wgrad3x3_cuda(x, dy), x, dy)
    base = _x((2 * 9 * 9 * 16 + 1,), 44, dtype)
    x = base[1:].view(2, 9, 9, 16)
    assert x.data_ptr() % 16 != 0
    dy = _x((2, 9, 9, 24), 45, dtype, offset=0.0)
    _k4_close(wgrad3x3_cuda(x, dy), x, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad3x3_is_deterministic(dtype):
    """Split over row chunks, added in a fixed order: the same bits."""
    x = _x((8, 28, 28, 128), 46, dtype)
    dy = _x((8, 28, 28, 128), 47, dtype, offset=0.0)
    assert torch.equal(wgrad3x3_cuda(x, dy), wgrad3x3_cuda(x, dy))


def _conv_grads(x, k, fn, ct):
    x = x.detach().requires_grad_()
    k = k.detach().requires_grad_()
    y = fn(x, k)
    dx, dk = torch.autograd.grad((y.float() * ct).sum(), (x, k))
    return y, dx, dk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_function_matches_autograd_of_plain(dtype):
    """The Function under 'pallas' against autograd of F.conv2d: the
    same forward and dx (the library's gradient on both sides), and dW
    from K4 against the plain version's dW rounded to the weight's type
    (bf16: within one bf16 ulp of it)."""
    x = _x((4, 14, 14, 32), 48, dtype).permute(0, 3, 1, 2)
    k = _vec((48, 3, 3, 32), 49, 0.1).to(dtype).permute(0, 3, 1, 2)
    ct = _vec((4, 14, 14, 48), 50).permute(0, 3, 1, 2)
    before = LAUNCHES["conv_wgrad3x3"]
    y, dx, dk = _conv_grads(x, k, lambda a, b: Conv2dCustomBwd.apply(
        a, b, 1, 1, "pallas", "auto"), ct)
    assert LAUNCHES["conv_wgrad3x3"] == before + 1
    y0, dx0, _ = _conv_grads(x, k, lambda a, b: F.conv2d(a, b, None, 1, 1),
                             ct)
    assert torch.equal(y, y0) and torch.equal(dx, dx0)
    assert dk.dtype == dtype and dk.shape == k.shape
    assert dk.is_contiguous(memory_format=torch.channels_last)
    want = wgrad3x3_reference(x.permute(0, 2, 3, 1),
                              ct.to(dtype).permute(0, 2, 3, 1))
    _close_to_scale(dk, want.permute(3, 2, 0, 1),
                    1e-5 if dtype == torch.float32 else 2 ** -7)


def test_conv_function_routes_only_3x3_stride_1_to_k4():
    """Stride 2 and a 1x1 kernel take the library's gradient under
    'pallas', as JAX's _vjp_bwd routes them: no K4 launch."""
    x = _x((2, 8, 8, 16), 51).permute(0, 3, 1, 2)
    before = LAUNCHES["conv_wgrad3x3"]
    for kernel, stride in ((3, 2), (1, 1)):
        k = _vec((16, kernel, kernel, 16), 52, 0.1).permute(0, 3, 1, 2)
        ct = torch.ones_like(F.conv2d(x, k, None, stride, kernel // 2))
        _, _, dk = _conv_grads(x, k, lambda a, b: Conv2dCustomBwd.apply(
            a, b, stride, kernel // 2, "pallas", "auto"), ct)
        _, _, dk0 = _conv_grads(
            x, k, lambda a, b: F.conv2d(a, b, None, stride, kernel // 2), ct)
        assert torch.equal(dk, dk0)
    assert LAUNCHES["conv_wgrad3x3"] == before


def test_wgrad3x3_wrapper_rejects_what_the_kernel_does_not_take():
    x = _x((2, 8, 8, 16), 53)
    before = LAUNCHES["conv_wgrad3x3"]
    with pytest.raises(ValueError, match="stride-1"):  # dy of a stride-2 conv
        wgrad3x3_cuda(x, _x((2, 4, 4, 16), 54))
    with pytest.raises(ValueError, match="stride-1"):  # a 1x1 conv, padding 1
        wgrad3x3_cuda(x, _x((2, 10, 10, 16), 55))
    with pytest.raises(ValueError, match="float32/bfloat16"):
        wgrad3x3_cuda(x.half(), x.half())
    with pytest.raises(ValueError, match="CUDA"):
        wgrad3x3_cuda(x.cpu(), x.cpu())
    with pytest.raises(ValueError, match="dy is"):
        wgrad3x3_cuda(x, x.bfloat16())
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        wgrad3x3_cuda(x, x.permute(0, 2, 1, 3))
    assert LAUNCHES["conv_wgrad3x3"] == before
    wgrad3x3_cuda(x, x)
    assert LAUNCHES["conv_wgrad3x3"] == before + 1


# The shapes of K4_SHAPES that the wgmma kernel takes in bf16.
K4_WIDE = [s for s in K4_SHAPES if s[1] % 64 == 0 and s[2] % 64 == 0]
WMMA, WGMMA = PATHS["wmma"][1], PATHS["wgmma"][1]


def _k4_counts():
    return LAUNCHES[WMMA], LAUNCHES[WGMMA]


def _chunks(x, cout, path="wgmma"):
    b, h, w, cin = x.shape
    return _kernels()[0](PATHS[path][0], b, h, w, cin, cout)


@pytest.mark.parametrize("h,cin,cout", K4_WIDE)
def test_wgrad3x3_wgmma_matches_plain(h, cin, cout):
    x = _x((4, h, h, cin), 60, torch.bfloat16)
    dy = _x((4, h, h, cout), 61, torch.bfloat16, offset=0.0)
    assert wgrad3x3_path(x, dy) == "wgmma"
    before = _k4_counts()
    got = wgrad3x3_cuda(x, dy)
    torch.cuda.synchronize()
    assert _k4_counts() == (before[0], before[1] + 1)
    _k4_close(got, x, dy)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 1, 1, 64, 64),      # 1x1: every tap but the centre reads zeros
    (3, 5, 9, 64, 128),     # W padded in the box, ragged H boxes
    (1, 7, 7, 128, 192),    # batch 1; a ragged 128-wide Cout tile
    (32, 28, 28, 128, 64),  # split over row chunks; Cout = 64 tiles
])
def test_wgrad3x3_wgmma_edges(b, h, w, cin, cout):
    x = _x((b, h, w, cin), 62, torch.bfloat16)
    dy = _x((b, h, w, cout), 63, torch.bfloat16, offset=0.0)
    if b == 32:
        assert _chunks(x, cout) > 1
    got = wgrad3x3_cuda(x, dy)
    torch.cuda.synchronize()
    _k4_close(got, x, dy)


def test_wgrad3x3_wgmma_is_deterministic():
    x = _x((16, 14, 14, 256), 64, torch.bfloat16)
    dy = _x((16, 14, 14, 256), 65, torch.bfloat16, offset=0.0)
    assert _chunks(x, 256) > 1
    assert torch.equal(wgrad3x3_cuda(x, dy), wgrad3x3_cuda(x, dy))


@pytest.mark.parametrize("b,h,cin,cout", [(8, 14, 256, 256),
                                          (4, 56, 64, 64)])
def test_wgrad3x3_wgmma_agrees_with_wmma(b, h, cin, cout):
    """The two kernels at the same shape, the old one through the forced
    path: each within the bound of the plain version, and of each other."""
    x = _x((b, h, h, cin), 66, torch.bfloat16)
    dy = _x((b, h, h, cout), 67, torch.bfloat16, offset=0.0)
    before = _k4_counts()
    new = wgrad3x3_cuda(x, dy)
    old = wgrad3x3_cuda(x, dy, path="wmma")
    torch.cuda.synchronize()
    assert _k4_counts() == (before[0] + 1, before[1] + 1)
    _k4_close(new, x, dy)
    _k4_close(old, x, dy)
    scale = wgrad3x3_reference(x.abs(), dy.abs())
    assert bool(((new - old).abs() <= 1e-5 * scale).all())


def test_wgrad3x3_counts_launches_by_path():
    base = _x((2 * 6 * 6 * 64 + 8,), 68, torch.bfloat16)
    cases = [(_x((2, 6, 6, 64), 69, torch.bfloat16), 64),
             (_x((2, 6, 6, 64), 69), 64),
             (_x((2, 6, 6, 32), 70, torch.bfloat16), 64),
             (_x((2, 6, 6, 64), 71, torch.bfloat16), 96),
             (base[1:1 + 2 * 6 * 6 * 64].view(2, 6, 6, 64), 64)]
    seen = []
    for x, cout in cases:
        dy = _x((2, 6, 6, cout), 72, x.dtype, offset=0.0)
        before = _k4_counts()
        _k4_close(wgrad3x3_cuda(x, dy), x, dy)
        after = _k4_counts()
        seen.append(wgrad3x3_path(x, dy))
        want = (1, 0) if seen[-1] == "wmma" else (0, 1)
        assert (after[0] - before[0], after[1] - before[1]) == want
    assert seen == ["wgmma", "wmma", "wmma", "wmma", "wmma"]


def test_wgrad3x3_refuses_a_forced_wgmma_path_the_rule_excludes():
    """fp32, Cin 32, Cout 96, and an x off a 16-byte boundary: the C
    function refuses the wgmma kernel, and nothing is launched or
    counted."""
    base = _x((2 * 6 * 6 * 64 + 8,), 73, torch.bfloat16)
    cases = [(_x((2, 6, 6, 64), 74), 64),
             (_x((2, 6, 6, 32), 75, torch.bfloat16), 64),
             (_x((2, 6, 6, 64), 76, torch.bfloat16), 96),
             (base[1:1 + 2 * 6 * 6 * 64].view(2, 6, 6, 64), 64)]
    before = _k4_counts()
    for x, cout in cases:
        dy = _x((2, 6, 6, cout), 77, x.dtype, offset=0.0)
        assert wgrad3x3_path(x, dy) == "wmma"
        with pytest.raises(RuntimeError, match="conv_wgrad3x3_wgmma"):
            wgrad3x3_cuda(x, dy, path="wgmma")
    torch.cuda.synchronize()
    assert _k4_counts() == before


# The narrow kernel: WRN-40-2's three narrow shapes (bf16, Cin, Cout <= 32).
K4_NARROW = [s for s in K4_SHAPES if s[1] <= 32 and s[2] <= 32]
NARROW = PATHS["narrow"][1]


def _narrow_count():
    return LAUNCHES[NARROW]


@pytest.mark.parametrize("h,cin,cout", K4_NARROW)
def test_wgrad3x3_narrow_matches_plain(h, cin, cout):
    x = _x((4, h, h, cin), 80, torch.bfloat16)
    dy = _x((4, h, h, cout), 81, torch.bfloat16, offset=0.0)
    assert wgrad3x3_path(x, dy) == "narrow"
    before = (*_k4_counts(), _narrow_count())
    got = wgrad3x3_cuda(x, dy)
    torch.cuda.synchronize()
    assert (*_k4_counts(), _narrow_count()) == (*before[:2], before[2] + 1)
    _k4_close(got, x, dy)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (1, 32, 32, 32, 32),   # one image: one block per band
    (2, 1, 1, 16, 16),     # 1x1: every tap but the centre reads zeros
    (3, 9, 13, 16, 32),    # W not a multiple of 8; pixels past the band
    (2, 45, 12, 8, 8),     # H that the band height (22) does not divide
    (2, 5, 7, 1, 16),      # Cin 1, 3, 5, 7: x spread from raw rows whose
    (2, 5, 7, 3, 16),      # starts lie off 16-byte boundaries
    (2, 5, 7, 5, 16),
    (2, 5, 7, 7, 16),
    (2, 6, 10, 16, 1),     # Cout 1: dy spread; Cout 24: an odd n8 tile
    (2, 6, 10, 8, 24),
    (3, 3, 5, 32, 32),     # fewer pixels than one k-step of 16
    (5, 17, 19, 3, 7),     # both spread, odd everything
    (1, 3, 128, 32, 32),   # W = 128, the widest: bands of 2 rows, 3 stages
    (1, 2, 128, 31, 31),   # the same with both operands spread
])
def test_wgrad3x3_narrow_edges(b, h, w, cin, cout):
    x = _x((b, h, w, cin), 82, torch.bfloat16)
    dy = _x((b, h, w, cout), 83, torch.bfloat16, offset=0.0)
    assert wgrad3x3_path(x, dy) == "narrow"
    got = wgrad3x3_cuda(x, dy)
    torch.cuda.synchronize()
    _k4_close(got, x, dy)


def test_wgrad3x3_narrow_is_deterministic():
    x = _x((16, 32, 32, 32), 84, torch.bfloat16)
    dy = _x((16, 32, 32, 32), 85, torch.bfloat16, offset=0.0)
    assert _chunks(x, 32, "narrow") > 1
    assert torch.equal(wgrad3x3_cuda(x, dy), wgrad3x3_cuda(x, dy))


@pytest.mark.parametrize("h,cin,cout", K4_NARROW)
def test_wgrad3x3_narrow_agrees_with_wmma(h, cin, cout):
    """The narrow kernel and the forced wmma kernel at the same shape:
    each within the bound of the plain version, and of each other."""
    x = _x((8, h, h, cin), 86, torch.bfloat16)
    dy = _x((8, h, h, cout), 87, torch.bfloat16, offset=0.0)
    before = (LAUNCHES[WMMA], _narrow_count())
    new = wgrad3x3_cuda(x, dy)
    old = wgrad3x3_cuda(x, dy, path="wmma")
    torch.cuda.synchronize()
    assert (LAUNCHES[WMMA], _narrow_count()) == (before[0] + 1,
                                                 before[1] + 1)
    _k4_close(new, x, dy)
    _k4_close(old, x, dy)
    scale = wgrad3x3_reference(x.abs(), dy.abs())
    assert bool(((new - old).abs() <= 1e-5 * scale).all())


def test_wgrad3x3_narrow_counts_launches_by_path():
    base = _x((2 * 6 * 6 * 32 + 8,), 88, torch.bfloat16)
    cases = [(_x((2, 6, 6, 32), 89, torch.bfloat16), 32, "narrow"),
             (_x((2, 6, 6, 3), 89, torch.bfloat16), 16, "narrow"),
             (_x((2, 6, 6, 32), 89), 32, "wmma"),
             (_x((2, 6, 6, 33), 90, torch.bfloat16), 32, "wmma"),
             (_x((2, 6, 6, 64), 91, torch.bfloat16), 64, "wgmma"),
             (base[1:1 + 2 * 6 * 6 * 32].view(2, 6, 6, 32), 32, "wmma")]
    keys = (WMMA, WGMMA, NARROW)
    for x, cout, path in cases:
        dy = _x((2, 6, 6, cout), 92, x.dtype, offset=0.0)
        assert wgrad3x3_path(x, dy) == path
        before = [LAUNCHES[k] for k in keys]
        _k4_close(wgrad3x3_cuda(x, dy), x, dy)
        after = [LAUNCHES[k] for k in keys]
        assert [a - b for a, b in zip(after, before)] == [
            int(PATHS[path][1] == k) for k in keys]


def test_wgrad3x3_refuses_a_forced_narrow_path_the_rule_excludes():
    """fp32, Cin 33, Cout 33, W 129 and an x off a 16-byte boundary: the
    narrow kernel is refused before any launch, and nothing is counted."""
    base = _x((2 * 6 * 6 * 32 + 8,), 93, torch.bfloat16)
    cases = [(_x((2, 6, 6, 32), 94), 32),
             (_x((2, 6, 6, 33), 95, torch.bfloat16), 32),
             (_x((2, 6, 6, 32), 96, torch.bfloat16), 33),
             (_x((1, 2, 129, 8), 97, torch.bfloat16), 8),
             (base[1:1 + 2 * 6 * 6 * 32].view(2, 6, 6, 32), 32)]
    before = (*_k4_counts(), _narrow_count())
    for x, cout in cases:
        dy = _x((*x.shape[:3], cout), 98, x.dtype, offset=0.0)
        assert wgrad3x3_path(x, dy) == "wmma"
        with pytest.raises(RuntimeError, match=NARROW):
            wgrad3x3_cuda(x, dy, path="narrow")
    torch.cuda.synchronize()
    assert (*_k4_counts(), _narrow_count()) == before


# K2's one-launch forward: the widest and narrowest channel counts (C = 16
# and 2048 take 16-byte loads, C = 3 one-element loads and one-float
# partials), fewer rows than one block step (15 rows; a step is 32 rows at
# C = 64), and a single row.
BN_EDGES = [(2, 5, 7, 16), (2, 7, 7, 2048), (1, 7, 7, 3), (1, 3, 5, 64),
            (1, 1, 1, 256), (1, 1, 1, 3)]


def _bn_close(s, x, m0):
    s1, s2 = s
    w1, w2 = bn_sums_reference(x, m0)
    torch.cuda.synchronize()
    d = x.float() - m0
    assert (s1 - w1).abs().max() <= 1e-5 * d.abs().sum(
        dim=tuple(range(x.dim() - 1))).max()
    assert (s2 - w2).abs().max() <= 1e-5 * w2.max()


@pytest.mark.parametrize("shape", BN_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_one_launch_edges(shape, dtype):
    x = _x(shape, 110, dtype, offset=1.0)
    m0 = _vec(shape[-1:], 111, scale=0.5)
    _bn_close(bn_sums_cuda(x, m0), x, m0)


@pytest.mark.parametrize("chunks", [1, 3, 255, 256, 1000])
@pytest.mark.parametrize("c,dtype", [(128, torch.bfloat16),
                                     (128, torch.float32),
                                     (3, torch.bfloat16)])
def test_bn_sums_forced_chunk_counts(chunks, c, dtype):
    """Any chunk count gives the same bits as the plan and as the sums
    rounded once from float64, the same bits twice: the last
    block's groups of partials and the ticket hold from one chunk to more
    partials than threads, with clusters of 8 (256 and 1000 chunks, 125
    clusters: more than one wave, some chunks without rows) and without
    (255), for 16-byte loads and for C = 3's one-element loads."""
    x = _x((4, 28, 28, c), 112, dtype, offset=1.0)
    m0 = _vec((c,), 113, scale=0.5)
    plan = bn_sums_plan(x, chunks)
    assert plan["cluster"] == (8 if chunks in (256, 1000) else 1)
    got = bn_stats._launch(x, m0, chunks=chunks)
    _bn_close(got, x, m0)
    for u, v in zip(got, bn_stats._launch(x, m0, chunks=chunks)):
        assert torch.equal(u, v)
    # fp64 sums rounded once: the planned launch's bits, and the float64
    # sums of the same fp32 differences and rounded squares
    d = (x.float() - m0).reshape(-1, c)
    want = (d.double().sum(0).float(), (d * d).double().sum(0).float())
    for u, v, e in zip(got, bn_sums_cuda(x, m0), want):
        assert torch.equal(u, v) and torch.equal(u, e)


def test_bn_sums_plan_fills_one_wave():
    """At ResNet-50's stem (b=128: one channel tile) the chunks fill the
    card's resident blocks once, in clusters of 8; at 7x7x512 (8 tiles of
    64 channels, 196 row steps of 32 rows) they hold 8 row steps each, 25
    chunks, no cluster."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = bn_sums_plan(torch.empty((128, 112, 112, 64), device="cuda",
                                   dtype=torch.bfloat16))
    assert big["ctiles"] == 1 and big["tile"] == 64 and big["cluster"] == 8
    wave = big["blocks_per_sm"] * sms
    assert big["chunks"] % 8 == 0 and wave // 2 <= big["chunks"] <= wave
    small = bn_sums_plan(torch.empty((128, 7, 7, 512), device="cuda",
                                     dtype=torch.bfloat16))
    assert (small["ctiles"], small["tile"], small["chunks"],
            small["cluster"]) == (8, 64, 25, 1)


def test_bn_sums_back_to_back_and_on_two_streams():
    """The ticket counters go back to 0: calls queued back to back on one
    stream, at shapes with other tile counts, each give their own sums;
    calls on two streams at once use two counter buffers and both give
    theirs."""
    shapes = [(8, 28, 28, 256), (4, 7, 7, 2048), (16, 14, 14, 64),
              (8, 28, 28, 256)]
    xs = [_x(s, 116 + i, torch.bfloat16, offset=1.0)
          for i, s in enumerate(shapes)]
    ms = [_vec(s[-1:], 120 + i, 0.5) for i, s in enumerate(shapes)]
    got = [bn_sums_cuda(x, m) for x, m in zip(xs, ms)]
    for s, x, m in zip(got, xs, ms):
        _bn_close(s, x, m)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(3):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(bn_sums_cuda(xs[i], ms[i]))
    torch.cuda.synchronize()
    for i, st in enumerate(streams):
        for s in outs[i]:
            _bn_close(s, xs[i], ms[i])
            for u, v in zip(s, outs[i][0]):
                assert torch.equal(u, v)
    bufs = {bn_stats._TICKETS[(0, st.cuda_stream)].data_ptr()
            for st in streams}
    assert len(bufs) == 2


def test_bn_sums_is_one_launch_per_call():
    """The profiler sees one K2 forward kernel per call, clusters and
    all."""
    from torch.profiler import ProfilerActivity, profile
    x = _x((128, 56, 56, 64), 124, torch.bfloat16)
    m0 = _vec((64,), 125)
    bn_sums_cuda(x, m0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            bn_sums_cuda(x, m0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k2 = [n for n in names if "bn_sums" in n]
    assert len(k2) == 3 and all("bn_sums_persistent_kernel" in n
                                for n in k2), names
    assert bn_sums_plan(x)["cluster"] == 8


# K3's staged kernel: ResNet-50's layer1 and layer4 planes, WRN-40-2's
# 32x32x32, a plane one row over what one block holds at C = 16 (86x86:
# a cluster of 2), one that needs a cluster of 8 (180x180), H*W = 1, and
# C = 8 and 24, where a bf16 row segment is one 16-byte lane.
SN_STAGED = [(56, 56, 256), (7, 7, 2048), (32, 32, 32), (86, 86, 16),
             (180, 180, 16), (1, 1, 64), (5, 5, 8), (9, 9, 24)]
# (H = W, C) of the SelfNorm sites: ResNet-50 at 224² (serving) and
# WRN-40-2 at 32² (eval)
SN_R50 = ((56, 256), (28, 512), (14, 1024), (7, 2048))
SN_WRN = ((32, 16), (32, 32), (16, 64), (8, 128))


def _plan_of(shape, dtype):
    return selfnorm_plan(torch.empty(shape, device="cuda", dtype=dtype))


@pytest.mark.parametrize("hwc", [(s, s, c) for s, c in SN_R50 + SN_WRN])
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selfnorm_plan_fits_and_covers_every_row_once(hwc, n, dtype):
    """At every SelfNorm shape of both models, at b=1 and b=64, the plan
    fits a block's shared memory on this card, its cluster is 1, 2, 4 or
    8, its lanes of 16 bytes span a tile that divides C, and the cluster's
    row ranges [rank·rows, min(hw, (rank+1)·rows)) cover every row exactly
    once, none of them empty."""
    h, w, c = hwc
    hw, item = h * w, torch.tensor([], dtype=dtype).element_size()
    p = _plan_of((n, h, w, c), dtype)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert p is not None and p["smem_bytes"] <= optin
    assert p["smem_bytes"] >= p["rows"] * p["tile"] * item
    assert p["cluster"] in (1, 2, 4, 8)
    assert p["lanes"] in (2, 4, 8, 16, 32)  # row segments of 32 B or more
    assert p["tile"] == p["lanes"] * 16 // item and c % p["tile"] == 0
    covered = []
    for rank in range(p["cluster"]):
        rows = range(rank * p["rows"], min(hw, (rank + 1) * p["rows"]))
        assert len(rows) > 0
        covered.extend(rows)
    assert covered == list(range(hw))
    assert p["blocks"] == n * (c // p["tile"]) * p["cluster"]


@pytest.mark.parametrize("hwc", [(s, s, c) for s, c in SN_R50 + SN_WRN])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selfnorm_plan_fills_the_card(hwc, dtype):
    """At the paths' batches (ResNet-50 serving at b=64, WRN-40-2's eval
    at b=128) every SM gets a block where x holds 32 KB a block, each
    within half an SM's shared memory (two resident); at b=1 a ResNet-50
    sample spreads over at least 32 blocks (the v1 kernel: C/32 blocks, 8
    at layer1)."""
    h, w, c = hwc
    props = torch.cuda.get_device_properties(0)
    item = torch.tensor([], dtype=dtype).element_size()
    n = 128 if (h, c) in SN_WRN else 64
    full = _plan_of((n, h, w, c), dtype)
    assert full["blocks"] >= min(props.multi_processor_count,
                                 n * h * w * c * item // 32768)
    assert full["smem_bytes"] <= props.shared_memory_per_block_optin // 2
    if (h, c) in SN_R50:
        assert _plan_of((1, h, w, c), dtype)["blocks"] >= 32


def test_selfnorm_plan_takes_a_cluster_where_a_block_cannot_hold_the_plane():
    """bf16 C = 16 (one 32-byte row segment a row): one block holds 85²
    rows and not 86² (a forced single-block launch is taken, then refused),
    so the plan splits 86² over a cluster; 180² need a cluster of 8, 400²
    fit no cluster."""
    bf16 = torch.bfloat16
    x, w, a, b = _inputs((1, 85, 85, 16), 140, bf16)
    got = sn_launch(x, w, a, b, 1e-12, "staged", 2, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), selfnorm_infer_reference(x, w, a, b).float(),
        **TOL[bf16])
    x = _inputs((1, 86, 86, 16), 141, bf16)[0]
    with pytest.raises(RuntimeError, match="cudaError"):
        sn_launch(x, w, a, b, 1e-12, "staged", 2, 1)
    assert _plan_of((1024, 86, 86, 16), bf16)["cluster"] >= 2
    assert _plan_of((1, 180, 180, 16), bf16)["cluster"] == 8
    assert _plan_of((1, 400, 400, 16), bf16) is None


@pytest.mark.parametrize("hwc", SN_STAGED)
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selfnorm_staged_matches_plain(hwc, n, dtype):
    x, w, a, b = _inputs((n, *hwc), 130, dtype)
    assert selfnorm_path(x) == "staged"
    key = SN_PATHS["staged"][1]
    before = LAUNCHES[key]
    got = selfnorm_infer_cuda(x, w, a, b)
    want = selfnorm_infer_reference(x, w, a, b)
    torch.cuda.synchronize()
    assert LAUNCHES[key] == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("hwc", [(56, 56, 256), (86, 86, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selfnorm_staged_is_deterministic_and_agrees_with_v1(hwc, dtype):
    x, w, a, b = _inputs((2, *hwc), 131, dtype)
    got = selfnorm_infer_cuda(x, w, a, b)
    assert torch.equal(got, selfnorm_infer_cuda(x, w, a, b))
    old = selfnorm_infer_cuda(x, w, a, b, path="v1")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), old.float(), **TOL[dtype])


def test_selfnorm_refuses_a_forced_staged_path_the_rule_excludes():
    """bf16 C = 12, fp32 C = 6, an x off a 16-byte boundary and a plane
    too large for a cluster of 8: the rule picks v1, a forced staged call
    is refused before any launch and nothing is counted, and v1 takes
    each call."""
    base = _x((2 * 5 * 5 * 16 + 8,), 132)
    cases = [_inputs((2, 5, 5, 12), 133, torch.bfloat16),
             _inputs((2, 5, 5, 6), 134),
             (base[1:1 + 2 * 5 * 5 * 16].view(2, 5, 5, 16),
              *_inputs((2, 5, 5, 16), 135)[1:]),
             _inputs((1, 400, 400, 16), 136, torch.bfloat16)]
    keys = [SN_PATHS[p][1] for p in ("v1", "staged")]
    for x, w, a, b in cases:
        assert selfnorm_path(x) == "v1"
        before = [LAUNCHES[k] for k in keys]
        with pytest.raises(RuntimeError, match=keys[1]):
            selfnorm_infer_cuda(x, w, a, b, path="staged")
        torch.cuda.synchronize()
        assert [LAUNCHES[k] for k in keys] == before
        got = selfnorm_infer_cuda(x, w, a, b)
        assert [LAUNCHES[k] for k in keys] == [before[0] + 1, before[1]]
        torch.testing.assert_close(
            got.float(), selfnorm_infer_reference(x, w, a, b).float(),
            **TOL[x.dtype])


# The CrossNorm sites of WRN-40-2 at pos 'post' (cn.yaml, cnsn.yaml), b=128:
# (H = W, C) of each group's block outputs
CN_WRN = [(32, 32), (16, 64), (8, 128)]


@pytest.mark.parametrize("hw,c", CN_WRN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selfnorm_at_the_trainers_eval_batch_matches_plain(hw, c, dtype):
    """K3 where the Trainer's evaluation of cnsn.yaml runs it: its 18
    SelfNorm sites at pos 'post' at eval_batch_size 1000, and at the
    synthetic test set's one short batch of 512; the staged kernel (one
    launch each), run to run bit for bit."""
    for n in (1000, 512):
        x, w, a, b = _inputs((n, hw, hw, c), 150 + c, dtype)
        assert selfnorm_path(x) == "staged"
        key = SN_PATHS["staged"][1]
        before = LAUNCHES[key]
        got = selfnorm_infer_cuda(x, w, a, b)
        again = selfnorm_infer_cuda(x, w, a, b)
        want = selfnorm_infer_reference(x, w, a, b)
        torch.cuda.synchronize()
        assert LAUNCHES[key] == before + 2
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("hw,c", CN_WRN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_stats_at_crossnorm_sites_matches_plain(hw, c, dtype):
    """K1 forward and backward at CrossNorm's eps 1e-5: the forward to
    1e-5 (fp32 sums in other orders), the backward to 1e-6 of its scale
    (fp32) or one bf16 ulp."""
    x = _x((128, hw, hw, c), 140 + c, dtype)
    got = ins_stats_cuda(x, eps=1e-5)
    want = ins_stats_reference(x, eps=1e-5)
    gm, gs = _vec((128, c), 141), _vec((128, c), 142)
    dx = ins_stats_bwd_cuda(x, want[0], want[1], gm, gs)
    want_dx = ins_stats_bwd_reference(x, want[0], want[1], gm, gs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    _close_to_scale(dx, want_dx,
                    1e-6 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("crop", ["neither", "style", "content"])
@pytest.mark.parametrize("hw,c", CN_WRN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_crossnorm_on_the_card_launches_k1_for_its_unmasked_statistics(
        crop, hw, c, dtype):
    """An active CrossNorm site (cross_norm_fma) on a CUDA tensor at crop
    'neither', 'style' or 'content': K1 runs once forward and once
    backward, for the one set of unmasked statistics (the masked ones are
    plain torch); output and input gradient equal the same op on the CPU,
    where K1's plain version runs, fed the same draws.  fp32: 1e-5 of the
    scale (statistics summed in other orders); bf16: 2^-6 of the scale
    (a statistic rounded to bf16 may differ by one ulp on each side of
    the scale σ_s/σ_c, then the output is rounded once)."""
    from cnsn_tpu_torch.ops.bbox import sample_bbox
    from cnsn_tpu_torch.ops.crossnorm import cross_norm_fma
    gen = torch.Generator().manual_seed(c)
    draws = {"perm": torch.randperm(128, generator=gen),
             "style_box": sample_bbox(hw, hw, generator=gen),
             "content_box": sample_bbox(hw, hw, generator=gen)}
    x = _x((128, hw, hw, c), 143 + c, dtype)
    ct = _x((128, hw, hw, c), 144 + c)
    runs = []
    for dev in ("cuda", "cpu"):
        xr = x.detach().to(dev).requires_grad_()
        before = dict(LAUNCHES)
        out = cross_norm_fma(xr, True, crop=crop, **draws)
        (out.float() * ct.to(dev)).sum().backward()
        torch.cuda.synchronize()
        runs.append((out.detach().cpu(), xr.grad.cpu(),
                     {k: LAUNCHES[k] - before.get(k, 0)
                      for k in ("ins_stats", "ins_stats_bwd")}))
    (out, dx, launches), (want, want_dx, cpu_launches) = runs
    assert launches == {"ins_stats": 1, "ins_stats_bwd": 1}
    assert cpu_launches == {"ins_stats": 0, "ins_stats_bwd": 0}
    assert out.dtype == dtype
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -6
    _close_to_scale(out, want, rtol)
    _close_to_scale(dx, want_dx, rtol)


@pytest.mark.parametrize("per_call", [1, 3])
def test_device_time_breakdown_counts_each_call_once(per_call):
    """The profile counts the kernels of its ``iters`` calls and no other:
    K2's forward (one kernel per call) ``per_call`` times per call, none
    of the untimed call's before the window marker, and the busy time
    inside the wall time."""
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    x = _x((128, 32, 32, 64), 126, torch.bfloat16)
    m0 = _vec((64,), 127)

    def fn():
        for _ in range(per_call):
            bn_sums_cuda(x, m0)

    prof = device_time_breakdown(fn, iters=4, warmup=1)
    assert prof["launches_by_family"] == {"bn_stats": per_call}, prof
    assert prof["kernels_per_call"] == per_call
    assert 0 < prof["device_busy_ms"] <= prof["wall_ms"]


def test_device_time_breakdown_raises_without_its_window_marker(
        monkeypatch):
    from cnsn_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_MARK", "no_kernel_has_this_name")
    x = _x((8, 8, 8, 64), 128, torch.bfloat16)
    m0 = _vec((64,), 129)
    with pytest.raises(RuntimeError, match="window marker"):
        profiling.device_time_breakdown(lambda: bn_sums_cuda(x, m0),
                                        iters=2, warmup=0)


# K1's one-launch forward: C = 3 fp32 at 224² (b=2: a cluster of 8 a
# plane), WRN-40-2's C = 16 at 32², C = 8 and 24 (one and three 16-byte
# lanes, rounded up to four), H·W = 1, a 7x7x2048 plane (8 tiles of 256),
# and ResNet-50's 56x56x256 at b=4 (a cluster of 8 a plane).
K1_EDGES = [(2, 224, 224, 3), (8, 32, 32, 16), (2, 5, 5, 8), (2, 9, 9, 24),
            (3, 1, 1, 64), (2, 7, 7, 2048), (4, 56, 56, 256)]


def _k1_close(got, x, eps=1e-5):
    want = ins_stats_reference(x, eps)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", K1_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_stats_one_launch_edges(shape, dtype):
    """Against the plain version to 1e-5, one count per call, the same
    bits run to run."""
    x = _x(shape, 160, dtype)
    before = LAUNCHES["ins_stats"]
    got = ins_stats_cuda(x)
    again = ins_stats_cuda(x)
    assert LAUNCHES["ins_stats"] == before + 2
    _k1_close(got, x)
    for u, v in zip(got, again):
        assert torch.equal(u, v)


def test_ins_stats_takes_a_full_cluster_where_planes_are_few():
    """Two 224² images: each plane over one cluster of 8 blocks."""
    x = _x((2, 224, 224, 3), 161)
    plan = ins_stats.ins_stats_plan_of(x)
    assert plan["split"] == ins_stats.MAX_CLUSTER
    _k1_close(ins_stats_cuda(x), x)


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16, 40, 200])
@pytest.mark.parametrize("c,dtype", [(16, torch.bfloat16),
                                     (64, torch.float32),
                                     (3, torch.float32)])
def test_ins_stats_forced_splits(split, c, dtype):
    """Every plan the kernel takes agrees with the plain version and with
    itself run to run: one block a plane, clusters of 2 to 8 (16, 40 and
    200 round to 8)."""
    x = _x((3, 40, 40, c), 162, dtype)
    got = ins_stats._launch(x, split=split)
    _k1_close(got, x)
    for u, v in zip(got, ins_stats._launch(x, split=split)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("lanes", [8, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_stats_forced_lanes(lanes, dtype):
    """Tiles of 8 to 256 lanes (several tiles a sample, one slot of
    several warps a row group, one row a step) agree with the plain
    version and with themselves run to run."""
    x = _x((3, 9, 9, 1024), 170, dtype)
    got = ins_stats._launch(x, lanes=lanes)
    _k1_close(got, x)
    for u, v in zip(got, ins_stats._launch(x, lanes=lanes)):
        assert torch.equal(u, v)


def test_ins_stats_takes_unaligned_views():
    """An x off a 16-byte boundary takes one-element loads and agrees with
    the 16-byte-load kernel on a copy."""
    base = _x((4 * 32 * 32 * 32 + 1,), 163, torch.bfloat16)
    unaligned = base[1:].view(4, 32, 32, 32)
    assert unaligned.data_ptr() % 16 != 0
    got = ins_stats_cuda(unaligned)
    _k1_close(got, unaligned)
    for u, v in zip(got, ins_stats_cuda(unaligned.clone())):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 1, 1, 40), (1, 300, 300, 8)])
def test_ins_stats_constant_plane_through_every_path(shape):
    """A constant plane, one block (H·W = 1) or a cluster of 8: exact
    sums, mean exact, std exactly sqrt(eps) at eps 1e-12."""
    x = torch.full(shape, 1.25, device="cuda")
    x[0, ..., 1:] = -3.5
    mean, std = ins_stats_cuda(x, eps=1e-12)
    torch.testing.assert_close(mean, x[:, 0, 0, :], rtol=0, atol=0)
    torch.testing.assert_close(std, torch.full_like(std, 1e-6), rtol=0,
                               atol=0)


def test_ins_stats_back_to_back_and_on_two_streams():
    """Clustered calls queued back to back on one stream, at shapes with
    other plane counts, each give their own statistics; calls on two
    streams at once both give theirs, the same bits each time."""
    shapes = [(2, 224, 224, 3), (1, 300, 300, 8), (3, 150, 150, 16),
              (2, 224, 224, 3)]
    xs = [_x(s, 164 + i) for i, s in enumerate(shapes)]
    assert all(ins_stats.ins_stats_plan_of(x)["split"] > 1 for x in xs)
    for x, got in zip(xs, [ins_stats_cuda(x) for x in xs]):
        _k1_close(got, x)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(3):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(ins_stats_cuda(xs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            _k1_close(got, xs[i])
            for u, v in zip(got, outs[i][0]):
                assert torch.equal(u, v)


@pytest.mark.parametrize("shape,dtype", [((128, 56, 56, 256), torch.bfloat16),
                                         ((128, 32, 32, 32), torch.bfloat16),
                                         ((128, 224, 224, 3), torch.float32)])
def test_ins_stats_is_one_launch_per_call(shape, dtype):
    """The profile's window sees one K1 forward kernel per call, clusters
    and all."""
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    x = _x(shape, 168, dtype)
    prof = device_time_breakdown(lambda: ins_stats_cuda(x), iters=3,
                                 warmup=1)
    assert prof["launches_by_family"] == {"ins_stats": 1}, prof
    assert all("ins_stats_cluster_kernel" in k["name"]
               for k in prof["top_kernels_ms"]), prof


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 2048),
                                     (torch.float32, 512),
                                     (torch.float32, 3)])
def test_ins_stats_plan_residency_holds_on_the_card(dtype, c):
    """The plan's blocks per SM and cluster limit are what the card
    holds for the kernel, and its SM count is the card's."""
    x = torch.empty((128, 7, 7, c), device="cuda", dtype=dtype)
    plan = ins_stats.ins_stats_plan_of(x)
    occ = ins_stats.ins_stats_occupancy(x)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert occ["blocks_per_sm"] >= plan["blocks_per_sm"] >= 1
    assert occ["clusters"] >= 1
    assert plan["wave"] == sms * plan["blocks_per_sm"]


def test_ins_stats_refuses_a_plan_it_does_not_take():
    """lanes not a power of two, a cluster that is not a power of two or
    larger than 8, rows not covered: refused before any launch
    (cudaErrorInvalidValue)."""
    fwd = ins_stats._kernels()[1]
    x = _x((2, 8, 8, 16), 169, torch.bfloat16)
    mean = torch.empty((2, 16), device="cuda")
    std = torch.empty_like(mean)
    s = torch.cuda.current_stream().cuda_stream
    good = dict(lanes=2, split=4, chunk_rows=16)
    for bad in (dict(lanes=3), dict(split=6), dict(split=16, chunk_rows=4),
                dict(chunk_rows=8)):
        p = {**good, **bad}
        err = fwd(1, 8, x.data_ptr(), mean.data_ptr(), std.data_ptr(), 2, 64,
                  16, p["lanes"], p["split"], p["chunk_rows"], 1e-5, 1, s)
        assert err == 1, bad
    assert fwd(1, 8, x.data_ptr(), mean.data_ptr(), std.data_ptr(), 2, 64,
               16, good["lanes"], good["split"], good["chunk_rows"], 1e-5, 1,
               s) == 0
    _k1_close((mean, std), x)


# K2's backward at every BatchNorm2d input shape of ResNet-50 (224²) and
# WRN-40-2 (32²), at b=2 (b=128 runs in chip_smoke.py and stats_sweep)
BN_R50_HWC = [(112, 64), (56, 64), (56, 128), (56, 256), (28, 128),
              (28, 256), (28, 512), (14, 256), (14, 512), (14, 1024),
              (7, 512), (7, 2048)]
BN_WRN_HWC = [(32, 16), (32, 32), (16, 64), (8, 128)]


@pytest.mark.parametrize("hw,c", BN_R50_HWC + BN_WRN_HWC)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_bwd_matches_plain_at_every_model_shape(hw, c, dtype):
    """Bit for bit: the kernel and the plain version round every product
    and sum alike; one count per call."""
    x = _x((2, hw, hw, c), 170, dtype, offset=1.0)
    m0, g1, g2 = _vec((c,), 171, 0.5), _vec((c,), 172), _vec((c,), 173)
    before = LAUNCHES["bn_sums_bwd"]
    got = bn_sums_bwd_cuda(x, m0, g1, g2)
    assert LAUNCHES["bn_sums_bwd"] == before + 1
    want = bn_sums_bwd_reference(x, m0, g1, g2)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 3, 5, 64), (1, 1, 1, 2048),
                                   (1, 7, 7, 3), (2, 5, 7, 96),
                                   (1, 9, 9, 33), (1, 2, 3, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_bwd_edges(shape, dtype):
    """Fewer rows than a block step (15 rows, 32 a step), one row of 2048
    (a step is a row), one-element lanes (C = 3, 33), 24 lanes of a
    block's 256 (C = 96 fp32), two tiles (C = 4096)."""
    c = shape[-1]
    x = _x(shape, 174, dtype)
    m0, g1, g2 = _vec((c,), 175, 0.5), _vec((c,), 176), _vec((c,), 177)
    got = bn_sums_bwd_cuda(x, m0, g1, g2)
    torch.cuda.synchronize()
    assert torch.equal(got, bn_sums_bwd_reference(x, m0, g1, g2))


def test_bn_sums_bwd_takes_unaligned_views():
    base = _x((4 * 14 * 14 * 64 + 1,), 178, torch.bfloat16)
    x = base[1:].view(4, 14, 14, 64)
    assert x.data_ptr() % 16 != 0
    m0, g1, g2 = _vec((64,), 179, 0.5), _vec((64,), 180), _vec((64,), 181)
    got = bn_sums_bwd_cuda(x, m0, g1, g2)
    torch.cuda.synchronize()
    assert torch.equal(got, bn_sums_bwd_reference(x, m0, g1, g2))


@pytest.mark.parametrize("chunks", [1, 2, 3, 100, 5000])
def test_bn_sums_bwd_forced_plans_give_the_same_bits(chunks):
    x = _x((8, 28, 28, 128), 182, torch.bfloat16)
    m0, g1, g2 = _vec((128,), 183, 0.5), _vec((128,), 184), _vec((128,), 185)
    got = bn_stats._launch_bwd(x, m0, g1, g2, chunks=chunks)
    torch.cuda.synchronize()
    assert torch.equal(got, bn_sums_bwd_cuda(x, m0, g1, g2))


def test_bn_sums_bwd_plan_residency_holds_on_the_card():
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.empty((128, 7, 7, 512), device="cuda", dtype=dtype)
        assert (bn_stats.bn_bwd_occupancy(x)
                >= bn_stats.BWD_BLOCKS_PER_SM)


def test_bn_sums_bwd_is_one_launch_per_call():
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    x = _x((128, 56, 56, 64), 186, torch.bfloat16)
    m0, g1, g2 = _vec((64,), 187), _vec((64,), 188), _vec((64,), 189)
    prof = device_time_breakdown(lambda: bn_sums_bwd_cuda(x, m0, g1, g2),
                                 iters=3, warmup=1)
    assert prof["launches_by_family"] == {"bn_stats_bwd": 1}, prof
    assert all("bn_bwd_stream_kernel" in k["name"]
               for k in prof["top_kernels_ms"]), prof


@pytest.mark.parametrize("hw,c", [(32, 16), (32, 32), (8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_stats_function_at_wrn_shapes_matches_autograd_of_plain(
        hw, c, dtype):
    """InsStats at WRN-40-2's shapes (b=16; 32x32 splits over a cluster):
    the gradient into x against autograd of the plain version."""
    x = _x((16, hw, hw, c), 190, dtype).requires_grad_()
    c1, c2 = _vec((16, c), 191), _vec((16, c), 192)
    mean, std = InsStats.apply(x, 1e-5, 1)
    (mean * c1 + std * c2).sum().backward()
    got = x.grad
    x.grad = None
    rm, rs = ins_stats_reference(x)
    (rm * c1 + rs * c2).sum().backward()
    _close_to_scale(got, x.grad, 1e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("hw,c", [(32, 16), (32, 32), (8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_function_at_wrn_shapes_matches_autograd_of_plain(
        hw, c, dtype):
    """BnSums at WRN-40-2's shapes (b=16), through the streaming
    backward, against autograd of the plain version."""
    x = _x((16, hw, hw, c), 193, dtype).requires_grad_()
    m0, c1, c2 = _vec((c,), 194, 0.5), _vec((c,), 195), _vec((c,), 196)
    s1, s2 = BnSums.apply(x, m0)
    (s1 * c1 + 1e-2 * s2 * c2).sum().backward()
    got = x.grad
    x.grad = None
    r1, r2 = bn_sums_reference(x, m0)
    (r1 * c1 + 1e-2 * r2 * c2).sum().backward()
    _close_to_scale(got, x.grad, 1e-6 if dtype == torch.float32 else 2 ** -7)


# K1's backward (the one-wave streaming kernel) at every K1-backward shape
# of ResNet-50 (224²) and WRN-40-2 (32²; pos 'post' takes 3 of its 4), at
# b=2 (b=128 runs in chip_smoke.py and stats_sweep)
K1_BWD_HWC = [(56, 256), (28, 512), (14, 1024), (7, 2048), (32, 16),
              (32, 32), (16, 64), (8, 128)]


def _ins_bwd_rounded(x, mean, std, gm, gs, ddof=1):
    """The kernel's arithmetic in PyTorch, each operation rounded once in
    fp32, then one cast to x's type: ``ins_stats_bwd_reference``'s
    operations in its order, but gm / HW a true division (the card divides
    a tensor by a Python number by multiplying with its rounded
    reciprocal, which is exact only where HW is a power of two)."""
    n, h, w, c = x.shape
    shape = (n, 1, 1, c)
    a = gm / torch.full_like(gm, h * w)
    den = std * max(h * w - ddof, 1)
    q = gs.reshape(shape) * (x.float() - mean.reshape(shape))
    return (a.reshape(shape) + q / den.reshape(shape)).to(x.dtype)


def _k1_bwd_held(got, x, mean, std, gm, gs):
    """The same bits as the kernel's arithmetic at every shape; the same
    bits as the plain version where HW is a power of two, else within the
    first port's tolerance of it (1e-6 of the gradient's scale in fp32,
    one bf16 ulp)."""
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.is_contiguous()
    assert torch.equal(got, _ins_bwd_rounded(x, mean, std, gm, gs))
    want = ins_stats_bwd_reference(x, mean, std, gm, gs)
    hw = x.shape[1] * x.shape[2]
    if hw & (hw - 1) == 0:
        assert torch.equal(got, want)
    else:
        _close_to_scale(got, want,
                        1e-6 if x.dtype == torch.float32 else 2 ** -7)


def _k1_bwd_inputs(shape, seed, dtype):
    n, c = shape[0], shape[-1]
    x = _x(shape, seed, dtype)
    mean, std = ins_stats_reference(x)
    return x, mean, std, _vec((n, c), seed + 1), _vec((n, c), seed + 2)


@pytest.mark.parametrize("hw,c", K1_BWD_HWC)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_bwd_stream_matches_plain_at_every_model_shape(hw, c, dtype):
    """Bit for bit, one count per call."""
    args = _k1_bwd_inputs((2, hw, hw, c), 200, dtype)
    before = LAUNCHES["ins_stats_bwd"]
    got = ins_stats_bwd_cuda(*args)
    assert LAUNCHES["ins_stats_bwd"] == before + 1
    torch.cuda.synchronize()
    _k1_bwd_held(got, *args)


@pytest.mark.parametrize("shape", [(1, 7, 7, 12), (2, 5, 7, 3),
                                   (1, 1, 1, 2048), (3, 1, 1, 40),
                                   (1, 9, 9, 33), (2, 3, 5, 4096),
                                   (1, 56, 56, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_bwd_stream_edges(shape, dtype):
    """One-element loads (C = 12 bf16, C = 3, 33), H·W = 1, N = 1, two
    channel tiles (C = 4096), a row of one 16-byte lane (C = 8 bf16)."""
    args = _k1_bwd_inputs(shape, 203, dtype)
    got = ins_stats_bwd_cuda(*args)
    torch.cuda.synchronize()
    _k1_bwd_held(got, *args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ins_bwd_stream_takes_unaligned_views(dtype):
    """x off a 16-byte boundary takes the one-element path: the same bits
    as the 16-byte path on an aligned copy."""
    base = _x((4 * 14 * 14 * 64 + 1,), 206, dtype)
    x = base[1:].view(4, 14, 14, 64)
    assert x.data_ptr() % 16 != 0
    mean, std = ins_stats_reference(x)
    gm, gs = _vec((4, 64), 207), _vec((4, 64), 208)
    got = ins_stats_bwd_cuda(x, mean, std, gm, gs)
    aligned = ins_stats_bwd_cuda(x.clone(), mean, std, gm, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    _k1_bwd_held(got, x, mean, std, gm, gs)


@pytest.mark.parametrize("chunks", [1, 2, 3, 7, 100, 5000])
@pytest.mark.parametrize("c,dtype", [(128, torch.bfloat16),
                                     (3, torch.float32)])
def test_ins_bwd_stream_forced_chunks_give_the_same_bits(chunks, c, dtype):
    args = _k1_bwd_inputs((8, 28, 28, c), 209, dtype)
    got = ins_stats._launch_bwd(*args, chunks=chunks)
    torch.cuda.synchronize()
    assert torch.equal(got, ins_stats_bwd_cuda(*args))
    _k1_bwd_held(got, *args)


def test_ins_bwd_plan_residency_holds_on_the_card():
    """The plan's wave is what the card holds for the kernel."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, c in ((torch.bfloat16, 2048), (torch.bfloat16, 12),
                     (torch.float32, 512), (torch.float32, 3)):
        x = torch.empty((128, 7, 7, c), device="cuda", dtype=dtype)
        assert (ins_stats.ins_bwd_occupancy(x)
                >= ins_stats.BWD_BLOCKS_PER_SM)
        assert ins_stats.ins_bwd_plan_of(x)["wave"] == (
            sms * ins_stats.BWD_BLOCKS_PER_SM)


@pytest.mark.parametrize("shape", [(128, 56, 56, 256), (128, 8, 8, 128)])
def test_ins_stats_bwd_is_one_launch_per_call(shape):
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    args = _k1_bwd_inputs(shape, 212, torch.bfloat16)
    prof = device_time_breakdown(lambda: ins_stats_bwd_cuda(*args), iters=3,
                                 warmup=1)
    assert prof["launches_by_family"] == {"ins_stats_bwd": 1}, prof
    assert all("ins_bwd_stream_kernel" in k["name"]
               for k in prof["top_kernels_ms"]), prof


def test_ins_stats_bwd_refuses_a_plan_it_does_not_take():
    """lanes not a power of two or above a block, no chunk, rows not
    covered: refused before any launch (cudaErrorInvalidValue)."""
    bwd = ins_stats._kernels()[2]
    x, mean, std, gm, gs = _k1_bwd_inputs((2, 8, 8, 16), 215, torch.bfloat16)
    dx = torch.empty_like(x)
    s = torch.cuda.current_stream().cuda_stream
    good = dict(lanes=2, chunks=4, chunk_rows=16)

    def launch(p):
        return bwd(1, 8, x.data_ptr(), mean.data_ptr(), std.data_ptr(),
                   gm.data_ptr(), gs.data_ptr(), dx.data_ptr(), 2, 64, 16, 1,
                   p["lanes"], p["chunks"], p["chunk_rows"], s)

    for bad in (dict(lanes=3), dict(lanes=512), dict(chunks=0),
                dict(chunk_rows=0), dict(chunk_rows=15)):
        assert launch({**good, **bad}) == 1, bad
    assert launch(good) == 0
    torch.cuda.synchronize()
    _k1_bwd_held(dx, x, mean, std, gm, gs)
