"""On-device AugMix: port of ``cnsn_tpu/data/augmix_jax.py``.

The JAX package builds the three views (clean, AugMix, AugMix) of a uint8
batch on the accelerator, its random draws threaded through one key tree
under ``vmap``.  Here, as for CrossNorm (``ops/crossnorm.py``), the draws
and the arithmetic are split:

* ``draw_augmix`` takes every random number on the host from an explicit
  CPU ``torch.Generator``: the Dirichlet branch weights and the Beta(1, 1)
  skip weight ``m`` (``augmix_jax.py:297-299``), each branch's depth
  (``:304-305``) and, for each of its three applications, the op
  (``:279``), the level U(0.1, severity) (``:156-157``) and the sign
  (``:160-161``).  The numbers differ from JAX's; the distributions are
  the same.
* ``apply_augmix`` computes what ``augmix_single`` computes (``:284-313``)
  with those draws as inputs, on the images' device: a float32 chain on
  the 0–255 scale, no uint8 re-quantisation between ops, each op as at
  ``:165-270`` with JAX's float32 level arithmetic, rotation as JAX's
  three shears (``:216-232``), PIL's resampling conventions (pixel-centre
  bounds, zero fill, edge tap clamped: ``:42-118``).

JAX's ``vmap`` over ``lax.switch`` runs all nine ops on every image at
each application; here the host, which holds the draws, groups the
branch images of both views (one batch of width·2B) by op and applies
each op to its subset (``index_select`` / ``index_copy_``), at most nine
groups an application, and skips the applications past a branch's depth
(JAX's ``where(d < depth, ...)`` gives the same result).  The resampling
is the two-tap gather form (``_shear_rows_gather``, ``:99-118``), whose weights
are the interpolation matrix's entries (``:79-96``): JAX's (H, W, W)
matrix exists for the TPU's slow gathers and would be 45 MB per shear per
image at 224².  Equalize takes per-image, per-channel histograms with
``scatter_add_`` and PIL's LUT rule (``:181-188``) in integers.

The knobs ``CNSN_AUGMIX_SHEAR`` ('matmul', 'gather': one function here;
'bf16': the weights and the image rounded to bf16, the sums in fp32, as
``:142-145``) and ``CNSN_AUGMIX_EQ`` ('onehot', 'scatter': one function)
are read at each call, as JAX reads them (``:341-353``); another value
raises.  They exist for parity with JAX's environment: no value is faster
here, since the gather form has no matmul for bf16 to speed up, and
'bf16' only costs precision.  On the card nothing here waits for the device: the draws and
the grouping stay on the host, and what the device needs of them goes
over in two non-blocking copies.

The chain has JAX's nine default ops only: like JAX's Trainer, nothing
passes ``all_ops`` to it.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["NUM_OPS", "OPS", "apply_augmix", "augmix_batch", "draw_augmix"]

# the op indices of ``augmix_jax.py:273-274``
OPS = ("autocontrast", "equalize", "posterize", "rotate", "solarize",
       "shear_x", "shear_y", "translate_x", "translate_y")
NUM_OPS = len(OPS)
_F32 = np.float32


def _bf16_shear() -> bool:
    """The knobs, read now: True where the resampling rounds to bf16."""
    shear = os.environ.get("CNSN_AUGMIX_SHEAR", "matmul")
    eq = os.environ.get("CNSN_AUGMIX_EQ", "onehot")
    if shear not in ("matmul", "gather", "bf16"):
        raise ValueError(f"CNSN_AUGMIX_SHEAR={shear!r}: one of 'matmul', "
                         "'gather', 'bf16'")
    if eq not in ("onehot", "scatter"):
        raise ValueError(f"CNSN_AUGMIX_EQ={eq!r}: one of 'onehot', "
                         "'scatter'")
    return shear == "bf16"


def draw_augmix(generator: torch.Generator, n: int, severity: float = 3.0,
                mixture_width: int = 3,
                mixture_depth: int = -1) -> Dict[str, torch.Tensor]:
    """The random draws of the two AugMix views of ``n`` images, from the
    CPU ``generator``: CPU tensors with leading dims (2, n), view first.

    ``ws`` (2, n, width) float32 Dirichlet(1, ..., 1) branch weights;
    ``m`` (2, n) float32 U(0, 1) skip weight; ``depth`` (2, n, width)
    int64, U{1, 2, 3} or ``mixture_depth`` where it is > 0; ``op``,
    ``level``, ``sign`` (2, n, width, 3): each application's op index,
    its level U(0.1, severity) (float32) and whether its magnitude is
    negated (the geometric ops')."""
    shape = (2, n, mixture_width)
    e = torch.empty(shape).exponential_(generator=generator)
    ws = e / e.sum(-1, keepdim=True)
    m = torch.rand((2, n), generator=generator)
    if mixture_depth > 0:
        depth = torch.full(shape, mixture_depth, dtype=torch.int64)
    else:
        depth = torch.randint(1, 4, shape, generator=generator)
    op = torch.randint(0, NUM_OPS, shape + (3,), generator=generator)
    level = (torch.rand(shape + (3,), generator=generator)
             * (severity - 0.1) + 0.1)
    sign = torch.rand(shape + (3,), generator=generator) > 0.5
    return {"ws": ws, "m": m, "depth": depth, "op": op, "level": level,
            "sign": sign}


def _op_params(op: np.ndarray, level: np.ndarray, sign: np.ndarray,
               h: int) -> np.ndarray:
    """Each application's scalars, (k, 2) float32, from its op, level and
    sign, in JAX's float32 arithmetic (``augmix_jax.py:208-270``):
    posterize its shift 8 − bits, solarize its threshold, rotate
    (−tan(θ/2), sin θ), the shears their factor v, the translations their
    whole-pixel offset (from the image's height, as JAX's ``size``)."""
    lv = level.astype(_F32)

    def signed(v):
        return np.where(sign, -v, v).astype(_F32)

    def trunc(v):  # float32 → int32 → float32, as ``.astype(jnp.int32)``
        return v.astype(np.int32).astype(_F32)

    out = np.zeros(op.shape + (2,), _F32)
    out[..., 0] = np.select(
        [op == 2, op == 4, (op == 5) | (op == 6), (op == 7) | (op == 8)],
        [_F32(4) + trunc(lv * _F32(4) / _F32(10)),
         _F32(256) - trunc(lv * _F32(256) / _F32(10)),
         signed(lv * _F32(0.3) / _F32(10)),
         signed(trunc(lv * _F32(h / 3) / _F32(10)))], _F32(0))
    rad = signed(trunc(lv * _F32(30) / _F32(10))) * _F32(math.pi) \
        / _F32(180.0)
    rot = op == 3
    out[rot, 0] = -np.tan(rad[rot] / _F32(2.0))
    out[rot, 1] = np.sin(rad[rot])
    return out


def _to(device: torch.device, a: np.ndarray) -> torch.Tensor:
    """A host array on ``device``: on the card a non-blocking copy from
    pinned memory (the host does not wait for it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _shear(img: torch.Tensor, offsets: torch.Tensor, dim: int,
           bf16: bool) -> torch.Tensor:
    """Resample each row (``dim`` 2: out[y, x] = in[y, x + offsets[y]]) or
    each column (``dim`` 1: out[y, x] = in[y + offsets[x], x]) of
    img (k, H, W, 3), bilinear with PIL's bounds (``augmix_jax.py:79-118``):
    a source outside [−0.5, n − 0.5) gives 0, inside it the taps are
    clamped to the edge; the two taps' weights are the matrix entries
    max(0, 1 − |s − src|)."""
    k, h, w, _ = img.shape
    n = img.shape[dim]
    pos = torch.arange(n, dtype=torch.float32, device=img.device)
    src = (pos.view(1, 1, n) + offsets[:, :, None] if dim == 2
           else pos.view(1, n, 1) + offsets[:, None, :])
    valid = (src >= -0.5) & (src < n - 0.5)
    src = src.clamp(0.0, n - 1.0)
    x0 = torch.floor(src)
    w0 = (1.0 - (x0 - src).abs()).clamp(min=0.0)
    w1 = (1.0 - (x0 + 1.0 - src).abs()).clamp(min=0.0)
    i0 = x0.long()
    i1 = (i0 + 1).clamp(max=n - 1)
    v0 = img.gather(dim, i0[..., None].expand(k, h, w, 3))
    v1 = img.gather(dim, i1[..., None].expand(k, h, w, 3))
    if bf16:
        w0, w1, v0, v1 = (t.bfloat16().float() for t in (w0, w1, v0, v1))
    out = v0 * w0[..., None] + v1 * w1[..., None]
    return torch.where(valid[..., None], out, 0.0)


def _autocontrast(img, p, bf16):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    d = (hi - lo).clamp(min=1e-6)
    scale = torch.full_like(d, 255.0) / d
    return torch.where(hi > lo, (img - lo) * scale, img)


def _equalize(img, p, bf16):
    """PIL's equalize per image and channel (``augmix_jax.py:173-205``):
    the histogram of the truncated values, step = (pixels − the last
    non-empty bin's count) // 255, lut = (cum + step // 2) // step; a
    channel whose step is 0 is left as it is."""
    k, h, w, _ = img.shape
    dev = img.device
    ci = img.clamp(0, 255).to(torch.int64)
    plane = (torch.arange(k, device=dev)[:, None] * 3
             + torch.arange(3, device=dev)[None, :]) * 256        # (k, 3)
    flat = (ci + plane[:, None, None, :]).reshape(-1)
    hist = torch.zeros(k * 3 * 256, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, flat, torch.ones_like(flat))
    hist = hist.view(k, 3, 256)
    bins = torch.arange(256, device=dev)
    last = torch.where(hist > 0, bins, 0).amax(-1, keepdim=True)
    step = (h * w - hist.gather(-1, last)) // 255                 # (k, 3, 1)
    cum = hist.cumsum(-1) - hist
    lut = ((cum + step // 2) // step.clamp(min=1)).clamp(0, 255)
    mapped = lut.reshape(-1).index_select(0, flat).view(k, h, w, 3)
    return torch.where(step.view(k, 1, 1, 3) > 0, mapped.float(), img)


def _posterize(img, p, bf16):
    shift = p[:, 0].to(torch.int32).view(-1, 1, 1, 1)
    vals = img.clamp(0, 255).to(torch.int32)
    return ((vals >> shift) << shift).float()


def _solarize(img, p, bf16):
    thresh = p[:, 0].view(-1, 1, 1, 1)
    return torch.where(img >= thresh, 255.0 - img, img)


def _axis(n: int, shift: float, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) + shift


def _rotate(img, p, bf16):
    _, h, w, _ = img.shape
    ys = _axis(h, -(h - 1) / 2.0, img.device)
    xs = _axis(w, -(w - 1) / 2.0, img.device)
    alpha, beta = p[:, :1], p[:, 1:]
    out = _shear(img, alpha * ys, 2, bf16)
    out = _shear(out, beta * xs, 1, bf16)
    return _shear(out, alpha * ys, 2, bf16)


def _shear_x(img, p, bf16):
    return _shear(img, p[:, :1] * _axis(img.shape[1], 0.5, img.device), 2,
                  bf16)


def _shear_y(img, p, bf16):
    return _shear(img, p[:, :1] * _axis(img.shape[2], 0.5, img.device), 1,
                  bf16)


def _translate_x(img, p, bf16):
    return _shear(img, p[:, :1].expand(-1, img.shape[1]), 2, bf16)


def _translate_y(img, p, bf16):
    return _shear(img, p[:, :1].expand(-1, img.shape[2]), 1, bf16)


_FNS = (_autocontrast, _equalize, _posterize, _rotate, _solarize, _shear_x,
        _shear_y, _translate_x, _translate_y)


def apply_op(img: torch.Tensor, op: int, level: torch.Tensor,
             sign: torch.Tensor) -> torch.Tensor:
    """One op, ``OPS[op]``, on img (k, H, W, 3) float32 on the 0–255
    scale, each image at its level and sign (CPU tensors of k): JAX's
    ``_OPS[op]`` with those draws."""
    p = _op_params(np.full(len(level), op), level.numpy(), sign.numpy(),
                   img.shape[1])
    return _FNS[op](img, _to(img.device, p), _bf16_shear())


def apply_augmix(images_u8: torch.Tensor, params: Dict[str, torch.Tensor],
                 mean: Sequence[float] = (0.5, 0.5, 0.5),
                 std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    """(B, H, W, 3) uint8 on any device → (3, B, H, W, 3) float32 (clean,
    aug1, aug2) on that device (``augmix_jax.py:316-338``), normalized
    (z − 255·mean) / (255·std); ``params`` are ``draw_augmix``'s for n = B,
    on the host."""
    bf16 = _bf16_shear()
    dev = images_u8.device
    b, h = images_u8.shape[:2]
    width = params["ws"].shape[-1]
    # the view-images of every branch as one batch, branch-major:
    # n = i·2B + v·B + b for branch i, view v, image b
    depth = params["depth"].numpy().reshape(2 * b, width).T.reshape(-1)
    op = params["op"].numpy().reshape(2 * b, width, 3).transpose(1, 0, 2) \
        .reshape(-1, 3)
    prm = _op_params(
        op, params["level"].numpy().reshape(2 * b, width, 3)
        .transpose(1, 0, 2).reshape(-1, 3),
        params["sign"].numpy().reshape(2 * b, width, 3).transpose(1, 0, 2)
        .reshape(-1, 3), h)
    # the host's plan: per (application, op) the view-images that take
    # it, packed for one copy each way
    plan, idx, sub = [], [], []
    start = 0
    for d in range(3):
        for j in range(NUM_OPS):
            sel = np.flatnonzero((depth > d) & (op[:, d] == j))
            if sel.size:
                plan.append((j, start, sel.size))
                idx.append(sel)
                sub.append(prm[sel, d])
                start += sel.size
    floats = np.concatenate(
        [params["ws"].numpy().reshape(-1), params["m"].numpy().reshape(-1),
         np.asarray(mean, _F32) * _F32(255.0),
         np.asarray(std, _F32) * _F32(255.0)]
        + [s.reshape(-1) for s in sub]).astype(_F32)
    floats = _to(dev, floats)
    index = _to(dev, np.concatenate(idx).astype(np.int64)) if idx else None
    ws = floats[:2 * b * width].view(2 * b, width)
    m = floats[2 * b * width:2 * b * (width + 1)].view(-1, 1, 1, 1)
    at = 2 * b * (width + 1)
    mean_a, std_a = floats[at:at + 3], floats[at + 3:at + 6]
    prm_dev = floats[at + 6:].view(-1, 2)

    img = images_u8.float()
    clean = (img - mean_a) / std_a
    branches = img.repeat(2 * width, 1, 1, 1)
    for j, s, c in plan:
        sel = index[s:s + c]
        out = _FNS[j](branches.index_select(0, sel), prm_dev[s:s + c], bf16)
        branches.index_copy_(0, sel, out)
    branches = branches.view(width, 2 * b, *img.shape[1:])
    mix = torch.zeros_like(branches[0])
    for i in range(width):
        mix = mix + ws[:, i].view(-1, 1, 1, 1) * (
            (branches[i] - mean_a) / std_a)
    aug = (1 - m) * clean.repeat(2, 1, 1, 1) + m * mix
    return torch.stack([clean, aug[:b], aug[b:]])


def augmix_batch(generator: torch.Generator, images_u8: torch.Tensor,
                 severity: float = 3.0, mixture_width: int = 3,
                 mixture_depth: int = -1,
                 mean: Sequence[float] = (0.5, 0.5, 0.5),
                 std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (3, B, H, W, 3) float32 (clean, aug1, aug2)
    on the images' device, the draws from the CPU ``generator``
    (``augmix_jax.py:341-353``)."""
    params = draw_augmix(generator, images_u8.shape[0], severity,
                         mixture_width, mixture_depth)
    return apply_augmix(images_u8, params, mean, std)
