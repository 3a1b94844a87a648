"""The port's plain FCN-ResNet50 (``fcn_baseline``: no CNSN module, the
gtav_fcn50.yaml model) against the JAX package's, full depth, on the CPU,
in float64: eval and train-mode logits (at stride 8 and upsampled) and
the running statistics after the train forward, from JAX's weights
carried both ways (the helpers of ``test_torch_seg_models.py``).  The
JAX model is compiled once in this file."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.segmentation import fcn_baseline as jax_fcn_baseline
from cnsn_tpu_torch.segmentation import fcn_baseline
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_seg_models import TOL, _init, _port, _round_trip, _worst
from test_torch_seg_ops import patch_jax_float64
from test_torch_threads import one_thread  # noqa: F401 (autouse)

SIZE = 57


@pytest.fixture(scope="module")
def baseline():
    rng = np.random.RandomState(5)
    x = rng.randn(2, SIZE, SIZE, 3)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        patch_jax_float64(mp)
        jm = jax_fcn_baseline(7, dropout=0.0)
        params, stats = _init(jm, x.shape, rng)

        @jax.jit
        def run(p, s, xx):
            v = {"params": p, "batch_stats": s}
            tr, mut = jm.apply(v, xx, True, None, None, upsample=False,
                               mutable=["batch_stats"])
            return (jm.apply(v, xx, False, None, None),
                    jm.apply(v, xx, True, None, None,
                             mutable=["batch_stats"])[0],
                    tr, mut["batch_stats"])

        out = jax.tree.map(np.asarray, run(params, stats, jnp.asarray(x)))
    assert jm.cn_num == 0 and not jm.has_img_cn
    return dict(x=x, params=params, stats=stats, out=out)


def test_baseline_eval_and_train_logits_match_jax(baseline):
    model = _port(fcn_baseline(7, dropout=0.0), baseline["params"],
                  baseline["stats"])
    assert model.cn_num == 0 and not model.has_img_cn
    assert not any("cnsn" in k for k in model.state_dict())
    x = torch.from_numpy(baseline["x"])
    with torch.no_grad():
        ev = model.eval()(x)
        tr = model.train()(x)
    for got, want in ((ev, baseline["out"][0]), (tr, baseline["out"][1])):
        for g, w in zip(got, want):
            assert g.shape == (2, SIZE, SIZE, 7)
            assert _worst(g.numpy(), w) <= TOL


def test_baseline_lowres_train_logits_and_statistics_match_jax(baseline):
    model = _port(fcn_baseline(7, dropout=0.0), baseline["params"],
                  baseline["stats"])
    _round_trip(model, baseline["params"], baseline["stats"])
    with torch.no_grad():
        got = model.train()(torch.from_numpy(baseline["x"]), upsample=False)
    for g, w in zip(got, baseline["out"][2]):
        assert g.shape == (2, 8, 8, 7)
        assert _worst(g.numpy(), w) <= TOL
    want = state_dict_from_jax({}, baseline["out"][3], SEG_KEY_MAP)
    assert len(want) == 2 * (53 + 2)
    sd = model.state_dict()
    for k, w in want.items():
        assert _worst(sd[k].numpy(), w.numpy()) <= 1e-6, k  # fp32 carry
