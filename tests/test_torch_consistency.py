"""The consistency regimes of the port (``StepFns.cn_consistency``,
``StepFns.cn_image_consist``) against JAX's ``StepFns`` on the CPU, in
float64, and the Trainer's gate between each and ``plain``.

Each step runs a clean and two CrossNorm forwards in one graph and
updates the BatchNorm running statistics three times: JAX threads them
s1 → s2 → s3, the port updates them in place, so forward k's shift m0 is
the running mean forward k−1 left.  JAX's draws (the two site masks,
each site's permutation and boxes, or the two image draws) are recorded
and fed to the port.  The bounds are ``tests/test_torch_wideresnet.py``'s
for its SGD steps: the loss, ce and jsd within 1e-10 relative, every
parameter, running statistic and momentum buffer within 1e-6 of its
tensor's max-abs (JAX's trees come across in float32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.train.trainer as jax_trainer_mod
import cnsn_tpu_torch.nn.norm as port_norm
from cnsn_tpu.models.resnet import ResNet as JaxResNet
from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import TrainState as JaxTrainState
from cnsn_tpu.train.steps import make_sgd, sample_cn_mask
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
from cnsn_tpu_torch.train.trainer import Trainer
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_cnsn_sites import JaxDraws
from test_torch_trainer import _configs, small  # noqa: F401 (fixture)
from test_torch_wideresnet import _find_trace, _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)


_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs")
WRN_CONSIST = os.path.join(_CONFIGS, "cifar10", "wideresnet",
                           "cnsn-consist.yaml")
WRN_CNSN = os.path.join(_CONFIGS, "cifar10", "wideresnet", "cnsn.yaml")
R50_CONSIST = os.path.join(_CONFIGS, "imagenet", "resnet50",
                           "cnsn-consist.yaml")
STEPS_PER_EPOCH = 390
BOUNDS = (1e-10, 1e-6, 1e-6)


def _jax_state(model, port, shape, tx):
    """JAX's train state in float64 from the port model ``port``'s initial
    variables, carried into JAX's tree (its shapes from ``jax.eval_shape``:
    JAX's own init, compiled or op by op, costs seconds on the CPU), and those
    variables."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "crossnorm": jax.random.key(1)},
        jnp.zeros(shape), False, None))
    params, stats, missing = convert_state_dict(
        port.state_dict(), *jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32),
            (dict(shapes["params"]), dict(shapes["batch_stats"]))),
        strict=True)
    assert missing == []
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=tx)
    init = (_np64(state.params), _np64(state.batch_stats))
    params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 (state.params, state.batch_stats))
    return state.replace(params=params, batch_stats=stats,
                         opt_state=tx.init(params)), init


def _errors(got, want_metrics, state, want):
    """(worst relative error of loss, ce and jsd; worst state error; worst
    momentum error)."""
    params, stats, trace = want
    opt = state.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in state.model.named_parameters()}
    metric_err = max(abs(float(got[k]) - want_metrics[k])
                     / abs(want_metrics[k]) for k in ("loss", "ce", "jsd"))
    return (metric_err,
            _worst(state.model.state_dict(), state_dict_from_jax(params,
                                                                 stats)),
            _worst(momentum, state_dict_from_jax(trace, {})))


class _Threading:
    """Records, for every BatchNorm of the port's model, the shift m0 each
    train forward hands K2 and the running mean it leaves."""

    def __init__(self, monkeypatch):
        self.m0, self.after = [], []
        apply, update = port_norm.BnSums.apply, port_norm.BatchNorm.\
            _update_running

        def bn_sums(x, m0):
            self.m0.append(m0.clone())
            return apply(x, m0)

        def update_running(module, mean, var, n):
            update(module, mean, var, n)
            self.after.append(module.running_mean.clone())

        monkeypatch.setattr(port_norm, "BnSums", type(
            "BnSums", (), {"apply": staticmethod(bn_sums)}))
        monkeypatch.setattr(port_norm.BatchNorm, "_update_running",
                            update_running)

    def forwards(self, layers):
        """Per forward, per BatchNorm: (m0, running mean after)."""
        assert len(self.m0) == len(self.after) == 3 * layers
        return [list(zip(self.m0[k * layers:(k + 1) * layers],
                         self.after[k * layers:(k + 1) * layers]))
                for k in range(3)]


_JAX_RUNS = {}


def _wrn_consistency(monkeypatch):
    """cnsn-consist.yaml (CNSN 'both' at pos 'post', 2 of 3 sites on,
    consist_wt 10) on WRN-10-2 at 16², b=4: JAX's step (compiled, its two
    masks and every site's draws recorded) and, from the same key, JAX's
    running statistics after each of its three forwards (run once, shared
    by the tests); the port's steps and arguments for the same step."""
    cfg = load_config(WRN_CONSIST)
    assert (cfg.regime, cfg.active_num, cfg.consist_wt, cfg.crop) == \
        ("cn_consistency", 2, 10, "both")
    sgd = dict(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
               nesterov=cfg.nesterov)
    total = cfg.epochs * STEPS_PER_EPOCH
    kw = dict(depth=10, widen_factor=2, num_classes=cfg.num_classes,
              pos=cfg.pos, cnsn_type=cfg.cnsn_type, crop=cfg.crop,
              beta=cfg.beta)
    rng = np.random.RandomState(6)
    images = rng.randn(4, 16, 16, 3)
    labels = rng.randint(0, 10, 4)
    if "wrn" not in _JAX_RUNS:
        _JAX_RUNS["wrn"] = _jax_wrn_consistency(monkeypatch, cfg, kw, sgd,
                                                total, images, labels)
    init, masks, sites, want_metrics, want, stats_k = _JAX_RUNS["wrn"]
    n = len(sites) // 2
    port = WideResNet(**kw)
    port.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(port.double(), cosine_lr(cfg.lr, total),
                            device="cpu", **sgd)
    port_steps = StepFns(active_num=cfg.active_num,
                         consist_wt=cfg.consist_wt)
    args = (ts, torch.from_numpy(images), torch.from_numpy(labels))
    kwargs = dict(masks=masks, draws=(sites[:n], sites[n:]))
    return port_steps, args, kwargs, want_metrics, want, stats_k


def _jax_wrn_consistency(monkeypatch, cfg, kw, sgd, total, images, labels):
    draws = JaxDraws(monkeypatch)
    key = jax.random.key(7)
    with jax.enable_x64(True):
        model = JaxWideResNet(**kw)
        tx = make_sgd(jax_schedules.cosine_lr(cfg.lr, total), **sgd)
        state, init = _jax_state(model, WideResNet(**kw), (4, 16, 16, 3),
                                 tx)
        steps = JaxStepFns(model, active_num=cfg.active_num,
                           consist_wt=cfg.consist_wt)

        def run(state, images, labels):
            """The step, and beside it (one program) the statistics after
            each of its forwards, from the step's own keys."""
            k1m, k1f, k2m, k2f, kc = jax.random.split(key, 5)
            m1 = sample_cn_mask(k1m, model.cn_num, cfg.active_num)
            m2 = sample_cn_mask(k2m, model.cn_num, cfg.active_num)
            _, s1 = steps._apply(state.params, state.batch_stats, images,
                                 None, kc)
            _, s2 = steps._apply(state.params, s1, images, m1, k1f)
            _, s3 = steps._apply(state.params, s2, images, m2, k2f)
            return (s1, s2, s3), steps._cn_consistency(state, images,
                                                       labels, key)

        stats_k, (new, metrics) = draws.jit(run)(
            state, jnp.asarray(images), jnp.asarray(labels))
        stats_k = [_np64(s) for s in stats_k]
        want_metrics = {k: float(metrics[k]) for k in ("loss", "ce", "jsd")}
        want = (_np64(new.params), _np64(new.batch_stats),
                _np64(_find_trace(new.opt_state)))
    masks = [np.array(m).tolist() for m in draws.masks]
    # the draws of the statistics' forwards, then the step's: the same
    sites = draws.sites(cfg.crop)
    n = 2 * model.cn_num
    assert len(masks) == 2 and len(sites) == 2 * n
    assert all(torch.equal(a["perm"], b["perm"])
               for a, b in zip(sites[:n], sites[n:]))
    sites = sites[n:]
    return init, masks, sites, want_metrics, want, stats_k


def test_cn_consistency_step_matches_jax(monkeypatch):
    """One ``cn_consistency`` step of cnsn-consist.yaml on WRN-10-2 in
    float64: loss, ce, jsd, every parameter and running statistic after
    s3, every momentum buffer; err1 of the clean logits."""
    steps, args, kwargs, want_metrics, want, _ = _wrn_consistency(
        monkeypatch)
    ts, got = steps.cn_consistency(*args, **kwargs)
    assert ts.step == 1 and 0.0 <= float(got["err1"]) <= 100.0
    errs = _errors(got, want_metrics, ts, want)
    assert all(e <= b for e, b in zip(errs, BOUNDS)), errs


def test_statistics_thread_through_the_three_forwards(monkeypatch):
    """In the same step, every BatchNorm's shift m0 in forward 1 is the
    initial running mean, in forward k = 2, 3 exactly the running mean
    forward k−1 left; and the running statistics after each forward are
    JAX's s1, s2, s3 (JAX's three ``_apply`` calls from the step's own
    keys)."""
    steps, args, kwargs, _, _, stats_k = _wrn_consistency(monkeypatch)
    model = args[0].model
    layers = [m for m in model.modules() if isinstance(m, port_norm.BatchNorm)]
    initial = [m.running_mean.clone() for m in layers]
    rec = _Threading(monkeypatch)
    steps.cn_consistency(*args, **kwargs)
    fwd = rec.forwards(len(layers))
    for i, m0 in enumerate(initial):
        assert torch.equal(fwd[0][i][0], m0)
    for k in (1, 2):
        for i in range(len(layers)):
            assert torch.equal(fwd[k][i][0], fwd[k - 1][i][1]), (k, i)
    names = {id(m): n for n, m in model.named_modules()}
    for k in range(3):
        want = state_dict_from_jax({}, stats_k[k])
        got = {f"{names[id(m)]}.running_mean": fwd[k][i][1]
               for i, m in enumerate(layers)}
        assert _worst(got, {n: want[n] for n in got}) <= 1e-6, k
    # three distinct states: each forward moved the statistics
    assert not torch.equal(fwd[0][0][1], fwd[1][0][1])


def test_cn_image_consist_step_matches_jax(monkeypatch):
    """One ``cn_image_consist`` step of imagenet/resnet50/cnsn-consist.yaml
    (SelfNorm post, image CrossNorm crop 'both' drawn twice, consist_wt 10)
    on ResNet-50 layers (1, 1, 1, 1) at 64², b=4, in float64 (64² leaves
    layer4 at 2×2, where 32² would leave SelfNorm a 1×1 plane): JAX's
    ``_cn_image_consist`` (compiled, both image draws recorded) against the
    port's."""
    draws = JaxDraws(monkeypatch)
    cfg = load_config(R50_CONSIST)
    assert (cfg.regime, cfg.crop, cfg.consist_wt) == \
        ("cn_image_consist", "both", 10)
    kw = dict(layers=(1, 1, 1, 1), num_classes=10, pos=cfg.pos,
              cnsn_type=cfg.cnsn_type)
    sgd = dict(momentum=cfg.momentum, weight_decay=cfg.weight_decay,
               nesterov=cfg.nesterov)
    lr = (0.05, 4)
    rng = np.random.RandomState(8)
    images = rng.randn(4, 64, 64, 3)
    labels = rng.randint(0, 10, 4)
    with jax.enable_x64(True):
        model = JaxResNet(**kw, stem="conv")
        tx = make_sgd(jax_schedules.cosine_lr(*lr), **sgd)
        state, init = _jax_state(
            model, build_model("resnet50", generator=torch.Generator(),
                               **kw), (4, 64, 64, 3), tx)
        new, metrics = draws.jit(JaxStepFns(
            model, consist_wt=cfg.consist_wt, image_crop=cfg.crop,
            image_beta=cfg.beta)._cn_image_consist)(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(9))
        want_metrics = {k: float(metrics[k]) for k in ("loss", "ce", "jsd")}
        want = (_np64(new.params), _np64(new.batch_stats),
                _np64(_find_trace(new.opt_state)))
    image_draws = draws.sites(cfg.crop)
    assert len(image_draws) == 2 and all(
        set(d) == {"perm", "style_box", "content_box"} for d in image_draws)
    port = build_model("resnet50", generator=torch.Generator(), **kw)
    port.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(port.double(), cosine_lr(*lr), device="cpu",
                            **sgd)
    ts, got = StepFns(consist_wt=cfg.consist_wt, image_crop=cfg.crop,
                      image_beta=cfg.beta).cn_image_consist(
        ts, torch.from_numpy(images), torch.from_numpy(labels),
        draws=image_draws)
    errs = _errors(got, want_metrics, ts, want)
    assert all(e <= b for e, b in zip(errs, BOUNDS)), errs


def test_consistency_steps_draw_what_they_are_not_given():
    """Without masks or draws, each step draws them from the generator:
    the same generator seed gives the same step, bit for bit."""
    def run(name, seed):
        torch.manual_seed(0)
        model = WideResNet(depth=10, widen_factor=1, pos="post",
                           cnsn_type="cnsn", crop="both",
                           generator=torch.Generator().manual_seed(1))
        ts = create_train_state(model, lambda s: 0.1, device="cpu")
        images = torch.randn(4, 16, 16, 3,
                             generator=torch.Generator().manual_seed(2))
        labels = torch.tensor([0, 1, 2, 3])
        steps = StepFns(active_num=2, consist_wt=10.0, image_crop="both")
        _, metrics = getattr(steps, name)(
            ts, images, labels, generator=torch.Generator().manual_seed(seed))
        return metrics, [p.detach().clone() for p in model.parameters()]

    for name in ("cn_consistency", "cn_image_consist"):
        (m1, p1), (m2, p2), (m3, _) = run(name, 3), run(name, 3), run(name, 4)
        assert set(m1) == {"loss", "ce", "jsd", "err1"}
        assert all(torch.equal(a, b) for a, b in zip(p1, p2))
        assert float(m1["jsd"]) > 0 and float(m1["jsd"]) != float(m3["jsd"])
        np.testing.assert_allclose(
            float(m1["loss"]), float(m1["ce"]) + 10 * float(m1["jsd"]),
            rtol=1e-6)


def _stub(port, jt, calls, names):
    """Replace both Trainers' step functions by stubs recording (package,
    step function, labels)."""
    def port_step(name):
        def step(state, im, lb, generator=None):
            calls.append(("port", name, lb.numpy().tolist()))
            return state, {"loss": torch.zeros((), dtype=torch.float64)}
        return step

    def jax_step(name):
        def step(state, im, lb, key):
            calls.append(("jax", name, np.asarray(lb).tolist()))
            return state, {"loss": jnp.zeros(())}
        return step

    for name in names:
        setattr(port.steps, name, port_step(name))
        setattr(jt.steps, name, jax_step(name))


@pytest.mark.parametrize("recipe,over,regime", [
    (WRN_CONSIST, {}, "cn_consistency"),
    (WRN_CNSN, dict(regime="cn_image_consist"), "cn_image_consist"),
], ids=["cnsn-consist.yaml", "cnsn.yaml-cn_image_consist"])
def test_trainer_gate_dispatches_the_consistency_step(small, recipe, over,
                                                      regime, tmp_path):
    """Two epochs of 64 steps at b=8: each step's function (the
    consistency step when RandomState(seed).rand() < cn_prob, else plain,
    drawn in JAX's order) and its labels, equal to JAX's Trainer's; the
    Trainer passes the recipe's consist_wt to its steps."""
    cfg, jcfg = _configs(recipe, tmp_path, batch_size=8, **over)
    assert cfg.regime == jcfg.regime == regime
    port, jt = Trainer(cfg, device="cpu"), jax_trainer_mod.Trainer(jcfg)
    assert port.steps.consist_wt == jt.steps.consist_wt == (
        cfg.consist_wt or 0.0)
    calls = []
    _stub(port, jt, calls, ("plain", regime))
    for _ in range(2):
        port.train_epoch()
        jt.train_epoch()
    got = [c[1:] for c in calls if c[0] == "port"]
    want = [c[1:] for c in calls if c[0] == "jax"]
    assert len(got) == 2 * 512 // 8 and got == want
    n = sum(name == regime for name, _ in got)
    assert 0 < n < len(got)
    assert abs(n / len(got) - cfg.cn_prob) < 0.15
