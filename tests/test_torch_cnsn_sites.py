"""The port's CNSN sites (cnsn_tpu_torch.nn: CrossNorm, CNSN) in train
mode against the JAX modules, on the CPU, in float64.

JAX's sites draw from the 'crossnorm' RNG stream: the partner
permutation (``ops.crossnorm.grouped_permutation``) and the boxes
(``ops.crossnorm.sample_bbox``, and ``ops.bbox.sample_bbox`` on the fused
path).  Each test wraps those names to record what they return, and
feeds the recorded draws to the port.  Both sides start from the same
random SelfNorm parameters and running statistics, and are compared in
their output, the input gradient of <out, ct>, every parameter's
gradient and the updated BatchNorm1d running statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.nn import cnsn as jax_cnsn
from cnsn_tpu.nn.cnsn import CNSN as JaxCNSN
from cnsn_tpu.nn.cnsn import CrossNorm as JaxCrossNorm
from cnsn_tpu.ops import bbox as jax_bbox
from cnsn_tpu.ops import crossnorm as jax_cn
from cnsn_tpu.train import steps as jax_steps
from cnsn_tpu_torch.nn import CNSN, CrossNorm
from cnsn_tpu_torch.ops.crossnorm import CROP_MODES
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_threads import one_thread  # noqa: F401 (autouse)


SHAPE = (4, 7, 6, 16)  # N, H, W, C
TOL = 1e-10  # float64, the same operations: of each tensor's max-abs
_JAX_BBOX = jax.jit(jax_bbox.sample_bbox,
                    static_argnames=("h", "w", "beta", "bbx_thres"))


def _bbox(key, h, w, beta=1.0, bbx_thres=0.1):
    """JAX's sampler, compiled once per plane.  Under a trace it runs on
    the host through a callback, with the trace's x64 setting: the same
    function of the same key, without compiling its while_loop into
    every program that draws a box."""
    args = dict(h=h, w=w, beta=beta, bbx_thres=bbx_thres)
    if not isinstance(key, jax.core.Tracer):
        return _JAX_BBOX(key, **args)
    x64 = jax.config.jax_enable_x64
    shapes = jax.eval_shape(lambda k: _JAX_BBOX(k, **args), key)

    def host(data):  # on a thread of its own: int32 crosses either way
        with jax.enable_x64(x64):
            box = _JAX_BBOX(jax.random.wrap_key_data(data), **args)
        return tuple(np.asarray(v, np.int32) for v in box)

    box = jax.pure_callback(
        host, tuple(jax.ShapeDtypeStruct((), jnp.int32) for _ in shapes),
        jax.random.key_data(key))
    return tuple(v.astype(s.dtype) for v, s in zip(box, shapes))


class JaxDraws:
    """Wraps JAX's samplers, recording each draw in call order: a site
    draws its permutation first, then its style box, then its content
    box (``ops/crossnorm.py:86-118``, ``nn/cnsn.py:187-197``); and the
    site mask of a ``cn`` step (``train.steps.sample_cn_mask``).  Shared
    with the model and step tests.

    Run as it is, JAX hands the wrappers concrete values.  ``jit(fn)``
    compiles fn and returns what the wrappers saw as further outputs.
    The 'cond' site traces ``cross_norm_2ins`` inside ``lax.cond``, whose
    values cannot leave it; there the key it is handed (concrete: the
    site takes it before the cond) is recorded instead, and the same
    draws are taken from it as ``cross_norm_2ins`` takes them."""

    def __init__(self, monkeypatch):
        self.kinds, self.values, self.masks = [], [], []
        self._in_cond = False
        perm, two_ins = jax_cn.grouped_permutation, jax_cn.cross_norm_2ins
        cn_mask = jax_steps.sample_cn_mask

        def record(kind, out):
            if not self._in_cond:
                self.kinds.append(kind)
                self.values.append(out)
            return out

        def grouped_permutation(*a, **k):
            return record("perm", perm(*a, **k))

        def sample_bbox(*a, **k):
            return record("box", _bbox(*a, **k))

        def sample_cn_mask(*a, **k):
            out = cn_mask(*a, **k)
            self.masks.append(out)
            return out

        def cross_norm_2ins(x, key, crop="neither", **k):
            if isinstance(x, jax.core.Tracer) and not isinstance(
                    key, jax.core.Tracer):
                n, h, w, _ = x.shape
                with jax.ensure_compile_time_eval():
                    k_perm, k_style, k_content, _ = jax.random.split(key, 4)
                    grouped_permutation(k_perm, n, 1)
                    if crop in ("style", "both"):
                        sample_bbox(k_style, h, w)
                    if crop in ("content", "both"):
                        sample_bbox(k_content, h, w)
                self._in_cond = True
            try:
                return two_ins(x, key, crop=crop, **k)
            finally:
                self._in_cond = False

        monkeypatch.setattr(jax_cn, "grouped_permutation",
                            grouped_permutation)
        monkeypatch.setattr(jax_cn, "sample_bbox", sample_bbox)
        monkeypatch.setattr(jax_bbox, "sample_bbox", sample_bbox)
        monkeypatch.setattr(jax_cnsn, "cross_norm_2ins", cross_norm_2ins)
        monkeypatch.setattr(jax_steps, "sample_cn_mask", sample_cn_mask)

    def clear(self):
        self.kinds, self.values, self.masks = [], [], []

    def jit(self, fn):
        """fn compiled, called once: its output, its draws recorded."""
        def run(*args):
            self.clear()
            return fn(*args), (self.values, self.masks)

        def call(*args):
            out, (self.values, self.masks) = jax.jit(run)(*args)
            return out
        return call

    def mask(self):
        (mask,) = self.masks
        return np.array(mask).tolist()

    def sites(self, crop):
        """The draws of each site, as the port's keyword arguments."""
        roles = [r for r, on in (("style_box", crop in ("style", "both")),
                                 ("content_box", crop in ("content", "both")))
                 if on]
        out = []
        for kind, value in zip(self.kinds, self.values):
            if kind == "perm":
                out.append({"perm": torch.from_numpy(np.array(value))})
                todo = list(roles)
            else:  # the fused path draws its style box only
                out[-1][todo.pop(0)] = tuple(int(v) for v in value)
        return out


def _random_tree(tree, rng, stats):
    """Random values in place of a JAX tree's, fp32 numbers in float64
    arrays (``state_dict_from_jax`` carries fp32 into the port)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _random_tree(dict(v), rng, stats)
            continue
        if stats and k == "var":
            a = rng.uniform(0.5, 2.0, np.shape(v))
        elif stats:
            a = rng.randn(*np.shape(v)) * 0.3
        elif k == "scale":
            a = rng.uniform(0.5, 1.5, np.shape(v))
        else:
            a = rng.randn(*np.shape(v)) * 0.5
        out[k] = a.astype(np.float32).astype(np.float64)
    return out


def _compare(jax_module, port_module, active, recorder, crop, seed,
             extra=()):
    """Run both sites on the same float64 input from the same variables;
    assert every output, gradient and running statistic agrees."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*SHAPE) * 1.5 + 0.3
    ct = rng.randn(*SHAPE)
    key = jax.random.key(seed)
    with jax.enable_x64(True):
        v = jax_module.init({"params": key, "crossnorm": key},
                            jnp.asarray(x), None, *extra)
        params = _random_tree(dict(v.get("params", {})), rng, False)
        stats = _random_tree(dict(v.get("batch_stats", {})), rng, True)

        def f(xx, pp):
            out, mut = jax_module.apply(
                {"params": pp, "batch_stats": stats}, xx,
                None if active is None else jnp.asarray(active), *extra,
                rngs={"crossnorm": jax.random.key(seed + 1)},
                mutable=["batch_stats"])
            return out, mut.get("batch_stats", {})

        recorder.clear()
        out, vjp, new_stats = jax.vjp(f, jnp.asarray(x), params,
                                      has_aux=True)
        dx, dparams = vjp(jnp.asarray(ct))
        want = {"out": np.asarray(out), "dx": np.asarray(dx)}
        new_stats = jax.tree.map(np.asarray, new_stats)
        dparams = jax.tree.map(np.asarray, dparams)
    draws = recorder.sites(crop)
    port_module.load_state_dict(state_dict_from_jax(params, stats),
                                strict=True)
    port_module.double().train()
    tx = (torch.from_numpy(x).permute(0, 3, 1, 2)
          .requires_grad_())  # NCHW view of NHWC data: channels_last
    got = port_module(tx, active, draws[0] if draws else None)
    (got * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    pairs = [(got.permute(0, 2, 3, 1), want["out"]),
             (tx.grad.permute(0, 2, 3, 1), want["dx"])]
    grads = {k: p.grad for k, p in port_module.named_parameters()}
    state = port_module.state_dict()
    # JAX's gradients and new statistics in float64, under the port's
    # names (state_dict_from_jax names them, but rounds them to fp32)
    names = list(state_dict_from_jax(dparams, new_stats))
    assert set(grads) <= set(names)
    for k, want_a in zip(names, list(_leaves(dparams))
                         + list(_leaves(new_stats))):
        got_t = grads[k] if k in grads else state[k]
        pairs.append((got_t, want_a.reshape(got_t.shape)))
    for got_t, want_a in pairs:
        err = np.abs(got_t.detach().double().numpy() - want_a).max()
        assert err <= TOL * max(np.abs(want_a).max(), 1e-30), err
    return got, tx


def _leaves(tree):
    """A tree's leaves in ``state_dict_from_jax``'s order."""
    for v in tree.values():
        if hasattr(v, "items"):
            yield from _leaves(v)
        else:
            yield np.asarray(v, np.float64)


@pytest.mark.parametrize("active", [True, False, None])
@pytest.mark.parametrize("crop", CROP_MODES)
@pytest.mark.parametrize("impl", ["fma", "cond"])
def test_crossnorm_site_matches_jax(impl, crop, active, monkeypatch):
    """CrossNorm alone, 'fma' (JAX's default) and 'cond', read from
    CNSN_CN_IMPL as JAX reads it; an idle or absent gate gives x back."""
    recorder = JaxDraws(monkeypatch)
    monkeypatch.setenv("CNSN_CN_IMPL", impl)
    port = CrossNorm(crop)
    assert port.impl == impl
    got, tx = _compare(JaxCrossNorm(crop=crop, impl=impl), port, active,
                       recorder, crop, seed=1)
    if not active:
        assert got is tx


# (crop, fuse): the fused path ('neither', 'style'), the same crops with
# CNSN_FUSE=0, and the crops that never fuse ('content', 'both')
SITES = [("neither", True), ("style", True), ("content", True),
         ("both", True), ("neither", False), ("style", False)]


@pytest.mark.parametrize("active", [True, False, None])
@pytest.mark.parametrize("crop,fuse", SITES)
def test_cnsn_site_matches_jax(crop, fuse, active, monkeypatch):
    """CNSN 'cnsn' in train mode: fused whenever a CrossNorm forward
    reaches a 'neither'/'style' site (active True or False), the
    reference-shaped composition otherwise (active None: SelfNorm alone)."""
    recorder = JaxDraws(monkeypatch)
    monkeypatch.setenv("CNSN_FUSE", "1" if fuse else "0")
    port = CNSN(SHAPE[-1], "cnsn", crop=crop)
    assert port.fused == (fuse and crop in ("neither", "style"))
    _compare(JaxCNSN(SHAPE[-1], "cnsn", crop=crop, fuse=fuse), port, active,
             recorder, crop, seed=2, extra=(False,))


@pytest.mark.parametrize("cnsn_type", ["cn", "sn"])
@pytest.mark.parametrize("active", [True, False, None])
def test_cn_and_sn_sites_match_jax(cnsn_type, active, monkeypatch):
    """'cn' (CrossNorm alone, crop 'both') and 'sn' (SelfNorm alone, the
    gate ignored) CNSN sites."""
    recorder = JaxDraws(monkeypatch)
    port = CNSN(SHAPE[-1], cnsn_type, crop="both")
    assert not port.fused
    _compare(JaxCNSN(SHAPE[-1], cnsn_type, crop="both"), port, active,
             recorder, "both", seed=3, extra=(False,))


def test_crossnorm_rejects_an_unknown_impl(monkeypatch):
    monkeypatch.setenv("CNSN_CN_IMPL", "skip")
    with pytest.raises(ValueError, match="impl"):
        CrossNorm()


def test_site_gates_are_host_bools_one_per_site():
    from cnsn_tpu_torch.models.common import site_gates
    assert site_gates(None, 3) == [None, None, None]
    assert site_gates(torch.tensor([True, False, True]), 3) == [True, False,
                                                               True]
    assert site_gates([1, 0], 2) == [True, False]
    with pytest.raises(ValueError, match="3 site gates for 2 sites"):
        site_gates([True, False, True], 2)
