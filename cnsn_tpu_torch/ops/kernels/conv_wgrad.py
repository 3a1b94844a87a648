"""K4: the weight gradient of a 3×3 / stride-1 / same-padding convolution.

Port of ``cnsn_tpu/ops/pallas/conv_wgrad.py``.  Its two TPU entry points,
``wgrad3x3_pallas`` (one image per grid step, fp32 operands) and
``wgrad3x3_tiled`` (batch-tiled, native-dtype operands, fp32 sums),
compute the same dW and become three hand-written CUDA kernels in
``cnsn_tpu_torch/csrc/conv_wgrad.cu`` (its header states the designs and
the bounds): a ``wgmma`` kernel fed by TMA for bf16 with Cin and Cout
multiples of 64, a ``narrow`` kernel on ``mma.sync`` for bf16 with Cin
and Cout of at most 32, which stages each band of image rows once and
reads all nine taps from shared memory, and a ``wmma`` kernel for every
other call.  ``wgrad3x3_path`` is the rule between them;
``wgrad3x3_reference`` is their plain PyTorch version.  The
TPU's VMEM plans (``wgrad3x3_fits``, ``wgrad3x3_tile_plan``) have no
counterpart here; the measured shape gate of ``wgrad3x3_tiled_wins`` is
copied in ``ops/convdot.py``.

Layouts are the JAX package's: x (B, H, W, Cin) and dy (B, H, W, Cout)
NHWC, dW (3, 3, Cin, Cout) fp32, with
dW[kh, kw, ci, co] = Σ_{b,h,w} xpad[b, h+kh, w+kw, ci]·dy[b, h, w, co].
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import LAUNCHES, watch
from ._launch import (DTYPE_CODE, INT, PTR, bind, check_activation,
                      check_launch, stream, vector_width)

__all__ = ["wgrad3x3_cuda", "wgrad3x3_narrow_plan", "wgrad3x3_path",
           "wgrad3x3_reference", "wgrad3x3_wgmma_plan"]

# the C interface's path codes, and the LAUNCHES key of each path's kernel
PATHS = {"wmma": (0, "conv_wgrad3x3"), "wgmma": (1, "conv_wgrad3x3_wgmma"),
         "narrow": (2, "conv_wgrad3x3_narrow")}
# the narrow kernel's domain (csrc/conv_wgrad.cu, kNaMaxC and kNaMaxW)
NARROW_MAX_C = 32
NARROW_MAX_W = 128


def _check_shapes(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 4 or dy.dim() != 4 or dy.shape[:3] != x.shape[:3]:
        raise ValueError(
            f"x (B, H, W, Cin) and dy (B, H, W, Cout) of a 3x3 stride-1 "
            f"same-padding conv, got {tuple(x.shape)} and {tuple(dy.shape)}")


def wgrad3x3_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version: nine shifted-slice products of the zero-padded x
    with dy, each contracting (B, H, W) in fp32 → (3, 3, Cin, Cout) fp32.
    A float64 input is cast to fp32, as the Pallas kernel casts
    (``conv_wgrad.py:76-77``)."""
    _check_shapes(x, dy)
    b, h, w, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    d = dy.float().reshape(-1, dy.shape[-1])
    taps = [xp[:, kh:kh + h, kw:kw + w, :].reshape(-1, cin).T @ d
            for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, dy.shape[-1])


def wgrad3x3_path(x: torch.Tensor, dy: torch.Tensor) -> str:
    """Which kernel takes the call, in this order:

    * ``"wgmma"``: bf16, Cin and Cout multiples of 64, x and dy 16-byte
      aligned (the TMA loads' 64-channel boxes and aligned bases);
    * ``"narrow"``: bf16, 1 ≤ Cin ≤ 32, 1 ≤ Cout ≤ 32, W ≤ 128, x and dy
      16-byte aligned (its 16-byte copies start at the tensors' bases; a
      band of 3 stages fits in shared memory up to that width);
    * ``"wmma"``: every other call (fp32, unaligned views, the rest)."""
    if not (x.dtype == dy.dtype == torch.bfloat16
            and x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0):
        return "wmma"
    cin, cout = x.shape[-1], dy.shape[-1]
    if cin % 64 == 0 and cout % 64 == 0:
        return "wgmma"
    if (1 <= cin <= NARROW_MAX_C and 1 <= cout <= NARROW_MAX_C
            and x.shape[2] <= NARROW_MAX_W):
        return "narrow"
    return "wmma"


@functools.cache
def _kernels():
    return (bind("conv_wgrad", "cnsn_wgrad3x3_chunks", INT, INT, INT, INT,
                 INT, INT),
            bind("conv_wgrad", "cnsn_wgrad3x3", INT, INT, INT, PTR, PTR, PTR,
                 PTR, INT, INT, INT, INT, INT, INT, PTR))


_PLAN_KEYS = ("box_w", "box_h", "box_b", "rows_per_step", "steps", "stages",
              "chunks", "cout_tile", "tiles", "smem_fill_bytes")


def wgrad3x3_wgmma_plan(b: int, h: int, w: int, cin: int,
                        cout: int) -> dict:
    """The wgmma kernel's plan for a shape on the current device, for
    reports: its step box (columns, image rows, images), steps, ring
    stages, row chunks, block tiles, and the bytes that its TMA loads
    move from the L2 into shared memory in one call."""
    fn = bind("conv_wgrad", "cnsn_wgrad3x3_wgmma_plan", INT, INT, INT, INT,
              INT, ctypes.POINTER(ctypes.c_longlong))
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    if fn(b, h, w, cin, cout, out) != 0:
        raise RuntimeError(f"conv_wgrad3x3_wgmma: no plan for "
                           f"{(b, h, w, cin)} -> {cout}")
    return dict(zip(_PLAN_KEYS, out))


_NARROW_KEYS = ("rows", "bands", "stages", "blocks", "smem_bytes",
                "spread_x", "spread_dy", "smem_fill_bytes", "partial_bytes",
                "blocks_per_sm")


def wgrad3x3_narrow_plan(b: int, h: int, w: int, cin: int, cout: int,
                         rows: int = 0, blocks: int = 0) -> dict:
    """The narrow kernel's plan for a shape on the current device, for
    reports: image rows per band, bands, ring stages, blocks, a block's
    shared memory, whether x and dy are spread from raw rows, the bytes
    its loads bring into shared memory in one call, the bytes of the
    blocks' fp32 partials, and blocks per SM.  ``rows`` and ``blocks``
    above 0 replace the planned ones (as ``k4_sweep`` runs them)."""
    fn = bind("conv_wgrad", "cnsn_wgrad3x3_narrow_plan", INT, INT, INT, INT,
              INT, INT, INT, ctypes.POINTER(ctypes.c_longlong))
    out = (ctypes.c_longlong * len(_NARROW_KEYS))()
    if fn(b, h, w, cin, cout, rows, blocks, out) != 0:
        raise RuntimeError(f"conv_wgrad3x3_narrow: no plan for "
                           f"{(b, h, w, cin)} -> {cout} at rows={rows}, "
                           f"blocks={blocks}")
    return dict(zip(_NARROW_KEYS, out))


def wgrad3x3_cuda(x: torch.Tensor, dy: torch.Tensor,
                  path: str | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream; raise on a refused
    launch.  x and dy: NHWC-contiguous CUDA tensors of one type (float32
    or bfloat16) with the same (B, H, W); arguments and result as for
    ``wgrad3x3_reference``.  ``path`` forces a kernel (to time or check one
    against the other at the same shape); by default ``wgrad3x3_path``
    chooses, and a forced path the shape does not allow raises."""
    _check_shapes(x, dy)
    check_activation(x, 4)
    check_activation(dy, 4)
    if dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy is {dy.dtype} on {dy.device}, x {x.dtype} on "
                         f"{x.device}")
    code, name = PATHS[path or wgrad3x3_path(x, dy)]
    b, h, w, cin = x.shape
    cout = dy.shape[-1]
    vec = min(vector_width(x), vector_width(dy))
    chunks_of, launch = _kernels()
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        chunks = chunks_of(code, b, h, w, cin, cout)
        if chunks < 1:
            raise RuntimeError(f"{name}: cannot query the device or plan "
                               f"{tuple(x.shape)} -> {cout}")
        part = (torch.empty((chunks, 9, cin, cout), dtype=torch.float32,
                            device=x.device) if chunks > 1 else out)
        err = launch(code, DTYPE_CODE[x.dtype], vec, x.data_ptr(),
                     dy.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, w,
                     cin, cout, chunks, stream(x))
    check_launch(err, name)
    LAUNCHES[name] += 1
    watch(name, out)
    return out

