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
                                wgrad3x3_cuda, wgrad3x3_path,
                                wgrad3x3_reference)
from cnsn_tpu_torch.ops.convdot import Conv2dCustomBwd
from cnsn_tpu_torch.ops.kernels import LAUNCHES
from cnsn_tpu_torch.ops.kernels.conv_wgrad import PATHS, _kernels

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
