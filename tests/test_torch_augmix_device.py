"""On-device AugMix (cnsn_tpu_torch/data/augmix_device.py) against the JAX
package's chain (cnsn_tpu/data/augmix_jax.py) on the CPU.

``jax_draws`` replays JAX's key tree (``augmix_jax.py:277-313``) into the
draws the port takes, so that ``apply_augmix`` and JAX's ``augmix_batch``
see the same numbers: each op alone, then the whole chain.  The chain
is held within 1e-3 of JAX's on the pixel scale (the normalized value
times 255·std), except where a float32 rounding in an earlier op lands an
input on the other side of a posterize, solarize or equalize step: those
pixels are counted, printed, and held to 0.1% of the pixels.  The draws
themselves are held to JAX's in distribution, and the views to the port's
host AugMix (``data/augmix.py``) in distribution, as
tests/test_augmix_jax.py::TestDistributionFidelity holds JAX's.

JAX's chain is compiled as ``jax_batch``: ``augmix_single`` under one
``vmap`` over both views, half the program of ``augmix_batch``'s two
``vmap``s and so half the XLA compile (5–20 s each on the CPU; it is held
equal to ``augmix_batch`` at a small size).  This file compiles the 32²
chain, and under the knobs at a mixture width of 1 (every branch three
ops deep); test_torch_augmix_device_imagenet.py the 64² one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.data.augmix_jax as aj
from cnsn_tpu_torch.data.augmix import augmix as host_augmix
from cnsn_tpu_torch.data import augmix_device as ad
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CIFAR = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
PIXEL_TOL = 1e-3
FLIP_SHARE = 1e-3
GEOMETRIC = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")
KNOBS = [("gather", "scatter"), ("bf16", "onehot")]


def _one_image_draws(key, severity, width, depth):
    """``augmix_single``'s draws from its key, in its order of splits."""
    k_w, k_m, key = jax.random.split(key, 3)
    ws = jax.random.dirichlet(k_w, jnp.ones(width))
    m = jax.random.uniform(k_m)
    depths, ops, levels, signs = [], [], [], []
    for _ in range(width):
        key, k_depth, _ = jax.random.split(key, 3)
        depths.append(jnp.asarray(depth) if depth > 0
                      else jax.random.randint(k_depth, (), 1, 4))
        for _ in range(3):
            key, k_op = jax.random.split(key)
            op, level, sign = _op_draws(k_op, severity)
            ops.append(op)
            levels.append(level)
            signs.append(sign)
    shape = (width, 3)
    return (ws, m, jnp.stack(depths), jnp.stack(ops).reshape(shape),
            jnp.stack(levels).reshape(shape), jnp.stack(signs).reshape(shape))


def _op_draws(k_op, severity):
    """``_apply_random_op``'s op index, and the level and sign its op
    draws from its own key (posterize and solarize: the level from the key
    itself; the geometric ops: the level and the sign from its split)."""
    k_pick, key = jax.random.split(k_op)
    op = jax.random.randint(k_pick, (), 0, aj.NUM_OPS)
    level, sign = _level_sign(key, op, severity)
    return op, level, sign


def _level_sign(key, op, severity):
    k1, k2 = jax.random.split(key)
    direct = (op == 2) | (op == 4)
    level = jnp.where(direct, aj._sample_level(key, severity),
                      aj._sample_level(k1, severity))
    return level, jax.random.uniform(k2) > 0.5


@functools.lru_cache(maxsize=None)
def _replay(severity, width, depth):
    return jax.jit(jax.vmap(functools.partial(
        _one_image_draws, severity=severity, width=width, depth=depth)))


def jax_draws(key, n, severity=3.0, width=3, depth=-1):
    """The draws of JAX's ``augmix_batch(key, ...)`` on n images, laid out
    as ``draw_augmix`` returns them: (2, n, ...) CPU tensors."""
    keys = jax.random.split(key, 2 * n)   # augmix_jax.py:329
    names = ("ws", "m", "depth", "op", "level", "sign")
    out = {}
    for name, a in zip(names, _replay(float(severity), width, depth)(keys)):
        a = np.array(a).reshape((2, n) + a.shape[1:])
        out[name] = torch.from_numpy(
            a.astype(np.int64) if name in ("depth", "op") else a)
    return out


@functools.lru_cache(maxsize=None)
def _jax_views(knobs, severity, width, depth, mean, std):
    """JAX's ``augmix_single`` under one ``vmap`` over both views' keys:
    ``augmix_batch``'s two views (``augmix_jax.py:326-338``) in one
    program half the size of its two ``vmap``s, so half the compile.  The
    knobs, which ``augmix_single`` reads when traced, key the cache."""
    return jax.jit(jax.vmap(functools.partial(
        aj.augmix_single, severity=severity, mixture_width=width,
        mixture_depth=depth, mean=mean, std=std)))


def jax_batch(key, imgs, knobs, severity=3.0, mixture_width=3,
              mixture_depth=-1, mean=(0.5,) * 3, std=(0.5,) * 3):
    """What ``augmix_batch(key, imgs, ...)`` computes: its keys split as it
    splits them (``:329``), the clean view as it normalizes it."""
    b = len(imgs)
    keys = jax.random.split(key, 2 * b)
    views = np.asarray(_jax_views(knobs, severity, mixture_width,
                                  mixture_depth, mean, std)(
        keys, jnp.asarray(np.concatenate([imgs, imgs]))))
    clean = ((imgs.astype(np.float32) - np.asarray(mean, np.float32)
              * np.float32(255)) / (np.asarray(std, np.float32)
                                    * np.float32(255)))
    return np.concatenate([clean[None], views.reshape((2,) + imgs.shape)])


def chain_case(hw, b, norm, seeds, knobs=("matmul", "onehot"),
               monkeypatch=None, **kw):
    """``apply_augmix`` on JAX's replayed draws against JAX's chain
    (``jax_batch``) for each seed: the worst pixel-scale difference of
    the pixels within PIXEL_TOL, and the pixels beyond it (step flips),
    counted, printed and held to FLIP_SHARE."""
    monkeypatch.setenv("CNSN_AUGMIX_SHEAR", knobs[0])
    monkeypatch.setenv("CNSN_AUGMIX_EQ", knobs[1])
    rng = np.random.RandomState(hw + b)
    scale = np.asarray(norm["std"], np.float32) * 255
    flips = total = 0
    worst = 0.0
    for seed in seeds:
        imgs = rng.randint(0, 256, (b, hw, hw, 3)).astype(np.uint8)
        key = jax.random.key(seed)
        want = jax_batch(key, imgs, knobs, **kw, **norm)
        got = ad.apply_augmix(torch.from_numpy(imgs),
                              jax_draws(key, b, kw.get("severity", 3.0),
                                        kw.get("mixture_width", 3),
                                        kw.get("mixture_depth", -1)),
                              **norm)
        assert got.shape == want.shape == (3, b, hw, hw, 3)
        assert got.dtype == torch.float32
        diff = np.abs(got.numpy() - want) * scale
        flips += int((diff > PIXEL_TOL).sum())
        total += diff.size
        worst = max(worst, float(diff[diff <= PIXEL_TOL].max()))
    print(f"{hw}² b={b} {knobs}: {flips} of {total} pixels past "
          f"{PIXEL_TOL} (step flips), the others within {worst:.2e}")
    assert flips <= FLIP_SHARE * total, (flips, total)
    return flips


# ---- each op alone ---------------------------------------------------------

def _float_image(seed, hw=32):
    """A float image on the 0–255 scale: non-integer values, a few exact
    integers and the two ends."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(hw, hw, 3) * 255).astype(np.float32)
    img[::5, ::3] = np.round(img[::5, ::3])
    img[0, 0], img[-1, -1] = 0.0, 255.0
    return img


def _op_alone(op, keys, img, severity=3.0):
    """JAX's ``_OPS[op]`` on img with each key; the port's ``apply_op`` on
    a batch of img, each row at the level and sign that key draws."""
    want = np.stack([np.asarray(aj._OPS[op](k, jnp.asarray(img), severity))
                     for k in keys])
    drawn = [_level_sign(k, jnp.asarray(op), severity) for k in keys]
    level = torch.tensor([float(lv) for lv, _ in drawn])
    sign = torch.tensor([bool(s) for _, s in drawn])
    batch = torch.from_numpy(np.stack([img] * len(keys)))
    return ad.apply_op(batch, op, level, sign).numpy(), want


KEYS = [jax.random.key(s) for s in (0, 1, 7, 42, 1234)]


@pytest.mark.parametrize("op,knobs", [
    *[(name, (shear, "onehot")) for name in GEOMETRIC
      for shear in ("matmul", "gather", "bf16")],
    *[("equalize", ("matmul", eq)) for eq in ("onehot", "scatter")],
    *[(name, ("matmul", "onehot"))
      for name in ("autocontrast", "posterize", "solarize")]])
def test_op_alone_matches_jax(op, knobs, monkeypatch):
    """Geometric ops within 1e-3 on the 0–255 scale, autocontrast within
    1e-4, posterize, solarize and equalize equal, at each knob value."""
    monkeypatch.setenv("CNSN_AUGMIX_SHEAR", knobs[0])
    monkeypatch.setenv("CNSN_AUGMIX_EQ", knobs[1])
    i = ad.OPS.index(op)
    got, want = _op_alone(i, KEYS, _float_image(i))
    if op in GEOMETRIC:
        assert np.abs(got - want).max() <= PIXEL_TOL
    elif op == "autocontrast":
        assert np.abs(got - want).max() <= 1e-4
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["rotate", "equalize"])
def test_op_alone_at_64(op):
    i = ad.OPS.index(op)
    got, want = _op_alone(i, KEYS[:3], _float_image(i, 64), severity=1.0)
    if op == "rotate":
        assert np.abs(got - want).max() <= PIXEL_TOL
    else:
        np.testing.assert_array_equal(got, want)


def test_op_level_arithmetic_matches_jax(monkeypatch):
    """The float32 level arithmetic at levels where it rounds: posterize's
    bits, solarize's threshold, the whole degrees and pixels, the signs:
    JAX's op with its level and sign draws replaced by these values."""
    img = _float_image(3)
    for op in ("posterize", "solarize", "rotate", "translate_x"):
        i = ad.OPS.index(op)
        for level in (0.1, 2.5, 2.5000002, 2.9999998, 3.0):
            for sign in (False, True):
                got = ad.apply_op(torch.from_numpy(img[None]), i,
                                  torch.tensor([level]),
                                  torch.tensor([sign]))[0].numpy()
                monkeypatch.setattr(aj, "_sample_level",
                                    lambda key, n: jnp.float32(level))
                monkeypatch.setattr(aj, "_signed",
                                    lambda key, v: -v if sign else v)
                want = np.asarray(aj._OPS[i](jax.random.key(0),
                                             jnp.asarray(img), 3.0))
                assert np.abs(got - want).max() <= PIXEL_TOL, (op, level)


# ---- the whole chain -------------------------------------------------------

def test_jax_batch_is_augmix_batch(monkeypatch):
    """The oracle the chain is held to is JAX's ``augmix_batch``: at 16²,
    B=2, one branch two ops deep, equal within float32 rounding."""
    monkeypatch.delenv("CNSN_AUGMIX_SHEAR", raising=False)
    monkeypatch.delenv("CNSN_AUGMIX_EQ", raising=False)
    imgs = np.random.RandomState(5).randint(0, 256, (2, 16, 16, 3)).astype(
        np.uint8)
    kw = dict(severity=3.0, mixture_width=1, mixture_depth=2, **CIFAR)
    for seed in (0, 1):
        key = jax.random.key(seed)
        want = np.asarray(aj.augmix_batch(key, jnp.asarray(imgs), **kw))
        got = jax_batch(key, imgs, ("matmul", "onehot"), **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_chain_matches_jax_32(monkeypatch):
    """B=4 at 32² with the CIFAR statistics, the recipes' severity 3."""
    chain_case(32, 4, CIFAR, (0, 1, 2), monkeypatch=monkeypatch)


@pytest.mark.parametrize("knobs", KNOBS)
def test_chain_matches_jax_32_knobs(knobs, monkeypatch):
    """The other knob values, at a mixture width of 1 and every branch
    three ops deep."""
    chain_case(32, 4, CIFAR, (3, 4), knobs, monkeypatch=monkeypatch,
               mixture_width=1, mixture_depth=3)


def test_knobs_read_at_call_time(monkeypatch):
    """'matmul' and 'gather' are one function, as are 'onehot' and
    'scatter'; 'bf16' rounds the taps, a mean difference of less than a
    uint8 step from fp32 (where it moves a pixel across a step of a later
    op, that pixel moves further); another value raises."""
    imgs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (3, 32, 32, 3)).astype(np.uint8))
    params = ad.draw_augmix(torch.Generator().manual_seed(0), 3)
    monkeypatch.delenv("CNSN_AUGMIX_SHEAR", raising=False)
    monkeypatch.delenv("CNSN_AUGMIX_EQ", raising=False)
    base = ad.apply_augmix(imgs, params)
    for knob, value in (("CNSN_AUGMIX_SHEAR", "gather"),
                        ("CNSN_AUGMIX_EQ", "scatter")):
        monkeypatch.setenv(knob, value)
        assert torch.equal(ad.apply_augmix(imgs, params), base)
    monkeypatch.setenv("CNSN_AUGMIX_SHEAR", "bf16")
    bf16 = ad.apply_augmix(imgs, params)
    assert not torch.equal(bf16, base)
    assert float((bf16 - base).abs().mean()) * 127.5 <= 1.0
    for knob in ("CNSN_AUGMIX_SHEAR", "CNSN_AUGMIX_EQ"):
        monkeypatch.setenv(knob, "fast")
        with pytest.raises(ValueError, match=knob):
            ad.apply_augmix(imgs, params)
        monkeypatch.delenv(knob)


def test_views_and_draws_layout():
    """(3, B, H, W, 3) float32: the clean view normalized exactly, the
    views inside the normalized range; the draws (2, B, ...) on the host,
    a fixed depth where mixture_depth > 0; one generator, one result."""
    imgs = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (5, 16, 16, 3)).astype(np.uint8))
    p = ad.draw_augmix(torch.Generator().manual_seed(2), 5, 1.0, 2, 3)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "ws": (2, 5, 2), "m": (2, 5), "depth": (2, 5, 2),
        "op": (2, 5, 2, 3), "level": (2, 5, 2, 3), "sign": (2, 5, 2, 3)}
    assert (p["depth"] == 3).all()
    assert float(p["level"].min()) >= 0.1 and float(p["level"].max()) < 1.0
    torch.testing.assert_close(p["ws"].sum(-1), torch.ones(2, 5))
    views = ad.augmix_batch(torch.Generator().manual_seed(2), imgs, 1.0, 2,
                            3)
    assert torch.equal(views, ad.apply_augmix(imgs, p))
    assert views.shape == (3, 5, 16, 16, 3) and views.dtype == torch.float32
    np.testing.assert_array_equal(
        views[0].numpy(), (imgs.numpy().astype(np.float32) - 127.5) / 127.5)
    assert float(views.abs().max()) <= 1.0 + 1e-5
    assert not torch.equal(views[1], views[2])


# ---- the draws and the views in distribution --------------------------------

def _ks_uniform(x, lo, hi):
    x = np.sort((np.asarray(x, np.float64).ravel() - lo) / (hi - lo))
    n = len(x)
    return float(max((np.arange(1, n + 1) / n - x).max(),
                     (x - np.arange(n) / n).max()))


def test_draws_match_jax_in_distribution():
    """3,000 views' draws of each side against the laws they sample, each
    bound ~6 standard errors (the KS bounds: the 0.1% critical value
    1.95/sqrt(n)): op frequencies 1/9 ± 0.012 (27,000 applications),
    depths 1/3 ± 0.025 (9,000 branches), the Dirichlet(1, 1, 1) weights'
    mean 1/3 ± 0.02 and variance 1/18 ± 0.008, m and the levels uniform
    (KS ≤ 0.04 / 0.015), the signs 1/2 ± 0.02."""
    n = 1500
    sides = {"jax": jax_draws(jax.random.key(9), n),
             "port": ad.draw_augmix(torch.Generator().manual_seed(9), n)}
    for name, d in sides.items():
        ops = np.bincount(d["op"].numpy().ravel(), minlength=9) / d["op"].numel()
        assert np.abs(ops - 1 / 9).max() <= 0.012, (name, ops)
        depths = np.bincount(d["depth"].numpy().ravel(), minlength=4)[1:]
        assert np.abs(depths / d["depth"].numel() - 1 / 3).max() <= 0.025
        ws = d["ws"].numpy().reshape(-1, 3)
        assert np.abs(ws.mean(0) - 1 / 3).max() <= 0.02, (name, ws.mean(0))
        assert np.abs(ws.var(0) - 1 / 18).max() <= 0.008, (name, ws.var(0))
        assert _ks_uniform(d["m"].numpy(), 0, 1) <= 0.04, name
        assert _ks_uniform(d["level"].numpy(), 0.1, 3.0) <= 0.015, name
        assert abs(float(d["sign"].float().mean()) - 0.5) <= 0.02, name


def _rand_img(seed, hw=32):
    return np.random.RandomState(seed).randint(0, 256, (hw, hw, 3)).astype(
        np.uint8)


def _smooth_img(seed, hw=32):
    from PIL import Image
    rng = np.random.RandomState(seed)
    base = rng.randn(8, 8, 3)
    u8 = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    return np.asarray(Image.fromarray(u8).resize((hw, hw), Image.BILINEAR))


def test_views_match_host_augmix_in_distribution():
    """96 device views against the port's host AugMix (PIL) of the same
    images: 16-bin histograms within max(2.5 × the host-vs-host distance,
    0.05), the mean and std within 3 × the host-vs-host gap plus 0.01 and
    0.02 (tests/test_augmix_jax.py::TestDistributionFidelity's bounds)."""
    imgs = [_rand_img(i) for i in range(4)] + [_smooth_img(i)
                                               for i in range(4)]
    n = 96

    def host(seed):
        rng = np.random.RandomState(seed)
        pre = lambda z: (z.astype(np.float32) / 255.0 - 0.5) / 0.5  # noqa: E731
        return np.stack([host_augmix(rng, imgs[k % len(imgs)], pre,
                                            32) for k in range(n)])

    host_a, host_b = host(0), host(1)
    batch = torch.from_numpy(np.stack([imgs[k % len(imgs)]
                                       for k in range(n // 2)]))
    views = ad.augmix_batch(torch.Generator().manual_seed(0), batch)
    dev = views[1:].reshape(-1, 32, 32, 3).numpy()
    bins = np.linspace(-1, 1, 17)

    def hist(x):
        h, _ = np.histogram(x, bins=bins, density=True)
        return h / h.sum()

    null = np.abs(hist(host_a) - hist(host_b)).sum()
    gap = np.abs(hist(dev) - hist(host_a)).sum()
    assert gap <= max(2.5 * null, 0.05), (gap, null)
    assert abs(dev.mean() - host_a.mean()) <= 3 * abs(
        host_b.mean() - host_a.mean()) + 0.01
    assert abs(dev.std() - host_a.std()) <= 3 * abs(
        host_b.std() - host_a.std()) + 0.02
