"""Rematerialised blocks (``cnsn_tpu_torch/models/remat.py``, the replay of
``ops/recompute.py``) on the CPU in float64.

  * The stage spec of the segmentation backbone (True, '1_2', the int 12
    an unquoted YAML ``1_2`` parses to, 34, False) gives JAX's
    ``SegResNet.remat_stages``.
  * BatchNorm under recomputation, in every ``var_impl``, ``groups`` and
    ``stats_sample`` mode: the output and the gradients equal the plain
    layer's, the running statistics are updated once, and the shift of
    the recomputation is the first run's.
  * A model's steps with remat equal its steps without, bit for bit (the
    running statistics, the parameters, the momentum buffers, the loss),
    with the same CrossNorm draws (each drawn once, the generator left in
    the same state): ResNet-50 with CNSN at crop 'both' (128²: a box is
    drawn), ResNet-50-IBN-b and the FCN-CNSN backbone at crop 'style',
    reduced depth.  The plain versions of K1 and K2 run once more per
    block-internal forward call, the backward ones as often.
  * One remat SGD step of each against JAX's remat step (``nn.remat``),
    from the same weights: the loss within 1e-10, every parameter,
    running statistic and momentum buffer within 1e-6 of its tensor's
    max-abs.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnsn_tpu.segmentation.fcn as jax_fcn
import cnsn_tpu_torch.ops.crossnorm as port_crossnorm
import cnsn_tpu_torch.ops.kernels.bn_stats as port_bn
import cnsn_tpu_torch.ops.kernels.ins_stats as port_ins
import cnsn_tpu_torch.segmentation.fcn as port_fcn
from cnsn_tpu.models.resnet import ResNet as JaxResNet
from cnsn_tpu.models.resnet_ibn import ResNetIBN as JaxResNetIBN
from cnsn_tpu.segmentation import FCNCNSN as JaxFCNCNSN
from cnsn_tpu.segmentation import SegResNet as JaxSegResNet
from cnsn_tpu.segmentation import SegStepFns as JaxSegStepFns
from cnsn_tpu.segmentation import SegTrainState as JaxSegTrainState
from cnsn_tpu.segmentation import make_seg_optimizer as jax_seg_optimizer
from cnsn_tpu.train import schedules as jax_schedules
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.remat import block_call, remat_stages
from cnsn_tpu_torch.nn import BatchNorm, SelfNorm
from cnsn_tpu_torch.segmentation import SegResNet, SegStepFns, fcn_cnsn
from cnsn_tpu_torch.segmentation.train_seg import create_seg_train_state
from cnsn_tpu_torch.train import StepFns, create_train_state
from cnsn_tpu_torch.train.schedules import imagenet_step_lr
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_consistency import _jax_state
from test_torch_seg_ops import patch_jax_float64
from test_torch_wideresnet import _find_trace, _np64
from test_torch_threads import one_thread  # noqa: F401 (autouse)

LAYERS = (1, 1, 1, 1)
SGD = dict(momentum=0.9, weight_decay=1e-4, nesterov=False)
LR = (0.1, 90, 4, 5005)
SEG_OPT = dict(base_lr=0.01, max_iter=3, power=0.9, momentum=0.9,
               weight_decay=1e-4)


@pytest.mark.parametrize("spec", [True, "1_2", 12, 34, False])
def test_remat_stages_match_jax(spec):
    want = JaxSegResNet(layers=LAYERS, remat=spec).remat_stages
    assert remat_stages(spec) == want
    assert SegResNet(layers=LAYERS, remat=spec).remat_stages == want


class _TwoBN(torch.nn.Module):
    """BatchNorm → ReLU → BatchNorm, the shape of a block's BN chain."""

    def __init__(self, **kw):
        super().__init__()
        self.a, self.b = BatchNorm(6, **kw), BatchNorm(6, **kw)

    def forward(self, x):
        return self.b(torch.relu(self.a(x)))


@pytest.mark.parametrize("kw", [
    dict(var_impl="shifted"), dict(var_impl="two"), dict(var_impl="one"),
    dict(groups=2), dict(stats_sample=2)],
    ids=["shifted", "two", "one", "groups", "stats_sample"])
def test_batchnorm_under_recomputation(kw):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 6, 5, 5) * 2 + 1).contiguous(
        memory_format=torch.channels_last)
    g = torch.from_numpy(rng.randn(4, 6, 5, 5))
    plain = _TwoBN(**kw).double()
    with torch.no_grad():
        for p in plain.parameters():
            p.uniform_(0.5, 1.5)
        for name, buf in plain.named_buffers():
            buf.uniform_(0.5, 1.5) if "var" in name else buf.uniform_(-1, 1)
    remat = _TwoBN(**kw).double()
    remat.load_state_dict(plain.state_dict())
    outs = []
    for model, on in ((plain, False), (remat, True)):
        xi = x.clone().requires_grad_()
        y = block_call(model.train(), on, xi)
        (y * g).sum().backward()
        outs.append((y.detach(), xi.grad, [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))
    for k, v in plain.state_dict().items():
        assert torch.equal(v, remat.state_dict()[k]), k


class _Counts:
    """Calls of K1's and K2's plain versions (what launches the kernels on
    the card), and every CrossNorm draw made, by monkeypatch."""

    def __init__(self, monkeypatch):
        self.calls = {"bn_sums": 0, "bn_sums_bwd": 0, "ins_stats": 0,
                      "ins_stats_bwd": 0}
        self.draws = []
        for mod, names in ((port_bn, ("bn_sums", "bn_sums_bwd")),
                           (port_ins, ("ins_stats", "ins_stats_bwd"))):
            for name in names:
                monkeypatch.setattr(mod, f"{name}_reference",
                                    self._count(name, getattr(
                                        mod, f"{name}_reference")))
        draw = port_crossnorm._draw

        def logged(*a):
            d = draw(*a)
            self.draws.append({k: (v.tolist() if isinstance(v, torch.Tensor)
                                   else v) for k, v in d.items()})
            return d

        monkeypatch.setattr(port_crossnorm, "_draw", logged)

    def _count(self, name, fn):
        def run(*a, **k):
            self.calls[name] += 1
            return fn(*a, **k)
        return run

    def take(self):
        """(calls, draws) so far, then start again from none."""
        out = (dict(self.calls), list(self.draws))
        self.calls = dict.fromkeys(self.calls, 0)
        self.draws = []
        return out


def _classifier_run(name, remat, kw, image, steps=2):
    model = build_model(name, 10, generator=torch.Generator().manual_seed(2),
                        layers=LAYERS, remat=remat, **kw)
    ts = create_train_state(model.double(), imagenet_step_lr(*LR),
                            device="cpu", **SGD)
    rng = np.random.RandomState(5)
    gen = torch.Generator().manual_seed(9)
    fns = StepFns(active_num=2)
    metrics = []
    for _ in range(steps):
        x = torch.from_numpy(rng.randn(4, image, image, 3))
        y = torch.from_numpy(rng.randint(0, 10, 4))
        ts, m = fns.cn(ts, x, y, generator=gen)
        metrics.append(float(m["loss"]))
    return ts, metrics, gen.get_state()


def _seg_run(remat, steps=2):
    model = fcn_cnsn(5, crop="style", dropout=0.0, remat=remat,
                     generator=torch.Generator().manual_seed(2))
    ts = create_seg_train_state(model.double(), device="cpu", **SEG_OPT)
    fns = SegStepFns(model, num_classes=5)
    rng = np.random.RandomState(5)
    gen = torch.Generator().manual_seed(9)
    metrics = []
    for _ in range(steps):
        x = torch.from_numpy(rng.randn(2, 65, 65, 3))
        y = torch.from_numpy(rng.randint(0, 5, (2, 65, 65)))
        ts, m = fns.aug(ts, x, y, generator=gen)
        metrics.append(float(m["loss"]))
    return ts, metrics, gen.get_state()


# each case's two steps (every SelfNorm and CrossNorm site, and so every
# K1 call, lies in a block)
CASES = {
    "resnet50": lambda r: _classifier_run(
        "resnet50", r, dict(cnsn_type="cnsn", pos="post", crop="both"), 128),
    "resnet50_ibn_b": lambda r: _classifier_run(
        "resnet50_ibn_b", r, dict(cnsn_type="cnsn", pos="residual",
                                  crop="style"), 64),
    "fcn_cnsn": _seg_run,
}


def _block_bn(model):
    """BatchNorm2d layers inside the bottlenecks (``layerN.*``)."""
    return sum(isinstance(m, BatchNorm) for name, m in model.named_modules()
               if re.search(r"(^|\.)layer\d\.", name))


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_steps_equal_plain_steps(case, monkeypatch):
    monkeypatch.setattr(port_fcn, "seg_resnet50",
                        lambda **k: SegResNet(layers=LAYERS, **k))
    counts = _Counts(monkeypatch)
    plain, m0, g0 = CASES[case](False)
    c0, d0 = counts.take()
    remat, m1, g1 = CASES[case](True)
    c1, d1 = counts.take()
    assert m0 == m1
    assert torch.equal(g0, g1)
    assert d0 == d1 and len(d0) >= 2
    block_bn = _block_bn(plain.model)
    assert block_bn == 16
    sd0, sd1 = plain.model.state_dict(), remat.model.state_dict()
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for p, q in zip(plain.model.parameters(), remat.model.parameters()):
        assert torch.equal(plain.optimizer.state[p]["momentum_buffer"],
                           remat.optimizer.state[q]["momentum_buffer"])
    # two steps: every block-internal forward call once more, the
    # backward ones as often
    sn = sum(isinstance(m, SelfNorm) for m in plain.model.modules())
    assert c1["bn_sums"] == c0["bn_sums"] + 2 * block_bn
    assert c1["ins_stats"] == 2 * c0["ins_stats"] >= 2 * 2 * sn
    for k in ("bn_sums_bwd", "ins_stats_bwd"):
        assert c1[k] == c0[k], k


def test_remat_is_off_in_eval_and_without_grad(monkeypatch):
    import cnsn_tpu_torch.models.remat as remat_mod
    monkeypatch.setattr(remat_mod, "checkpoint", lambda *a, **k: 1 / 0)
    model = build_model("resnet50", 10, layers=LAYERS, remat=True,
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 3)
    model.eval()(x)
    with torch.no_grad():
        model.train()(x)


def _worst(got, want):
    return max(float((got[k].double() - torch.as_tensor(want[k])).abs().max())
               / max(float(np.abs(np.asarray(want[k])).max()), 1e-9)
               for k in want)


def _classifier_vs_jax(jax_model, port_name, kw):
    rng = np.random.RandomState(11)
    images, labels = rng.randn(4, 64, 64, 3), rng.randint(0, 10, 4)
    port = build_model(port_name, 10, generator=torch.Generator().manual_seed(2),
                       layers=LAYERS, remat=True, **kw)
    with jax.enable_x64(True):
        tx = make_sgd(jax_schedules.imagenet_step_lr(*LR), **SGD)
        state, init = _jax_state(jax_model, port, (4, 64, 64, 3), tx)
        new, metrics = JaxStepFns(jax_model).plain(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(0))
        want = (_np64(new.params), _np64(new.batch_stats),
                _np64(_find_trace(new.opt_state)))
        want_loss = float(metrics["loss"])
    port.load_state_dict(state_dict_from_jax(*init), strict=True)
    ts = create_train_state(port.double(), imagenet_step_lr(*LR),
                            device="cpu", **SGD)
    ts, got = StepFns().plain(ts, torch.from_numpy(images),
                              torch.from_numpy(labels))
    momentum = {n: ts.optimizer.state[p]["momentum_buffer"]
                for n, p in ts.model.named_parameters()}
    return (abs(float(got["loss"]) - want_loss) / abs(want_loss),
            _worst(ts.model.state_dict(), state_dict_from_jax(*want[:2])),
            _worst(momentum, state_dict_from_jax(want[2], {})))


def _seg_vs_jax(monkeypatch):
    patch_jax_float64(monkeypatch)
    monkeypatch.setattr(jax_fcn, "seg_resnet50",
                        lambda **kw: JaxSegResNet(layers=LAYERS, **kw))
    monkeypatch.setattr(port_fcn, "seg_resnet50",
                        lambda **kw: SegResNet(layers=LAYERS, **kw))
    rng = np.random.RandomState(7)
    images = rng.randn(2, 33, 33, 3)
    labels = rng.randint(0, 5, (2, 33, 33))
    kw = dict(pos="residual", cn_pos="post", cnsn_type="cnsn",
              crop="style", dropout=0.0, remat="1_2")
    model = fcn_cnsn(5, generator=torch.Generator().manual_seed(3), **kw)
    assert model.backbone.remat_stages == {1, 2}
    with jax.enable_x64(True):
        jm = JaxFCNCNSN(classes=5, **kw)
        # the port's initial weights in JAX's tree (JAX's own init, op by
        # op, costs ~12 s here)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "crossnorm": jax.random.key(1)},
            jnp.zeros(images.shape), False, None, None))
        params, stats, missing = convert_state_dict(
            model.state_dict(), *jax.tree.map(
                lambda a: np.zeros(a.shape, np.float32),
                (dict(shapes["params"]), dict(shapes["batch_stats"]))),
            strict=True, key_map=SEG_KEY_MAP)
        assert missing == []
        params, stats = _np64(params), _np64(stats)
        tx = jax_seg_optimizer(params, *SEG_OPT.values())
        state = JaxSegTrainState.create(apply_fn=jm.apply, params=params,
                                        batch_stats=stats, tx=tx)
        new, metrics = JaxSegStepFns(jm, num_classes=5).plain(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.key(0))
        want = state_dict_from_jax(_np64(new.params),
                                   _np64(new.batch_stats), SEG_KEY_MAP)
        want_m = state_dict_from_jax(_np64(_find_trace(new.opt_state)), {},
                                     SEG_KEY_MAP)
        want_loss = float(metrics["loss"])
    ts = create_seg_train_state(model.double(), device="cpu", **SEG_OPT)
    ts, got = SegStepFns(model, num_classes=5).plain(
        ts, torch.from_numpy(images), torch.from_numpy(labels))
    momentum = {n: ts.optimizer.state[p]["momentum_buffer"]
                for n, p in ts.model.named_parameters()}
    return (abs(float(got["loss"]) - want_loss) / abs(want_loss),
            _worst(ts.model.state_dict(), want), _worst(momentum, want_m))


@pytest.mark.parametrize("case", ["resnet50", "resnet50_ibn_b", "fcn_cnsn"])
def test_remat_step_matches_jax(case, monkeypatch):
    if case == "resnet50":
        kw = dict(pos="post", cnsn_type="sn")
        errs = _classifier_vs_jax(
            JaxResNet(layers=LAYERS, num_classes=10, remat=True, stem="conv",
                      **kw), case, kw)
    elif case == "resnet50_ibn_b":
        kw = dict(pos="residual", cnsn_type="sn")
        errs = _classifier_vs_jax(
            JaxResNetIBN(layers=LAYERS, ibn_cfg=("b", "b", None, None),
                         num_classes=10, remat=True, stem="conv", **kw),
            case, kw)
    else:
        errs = _seg_vs_jax(monkeypatch)
    assert errs[0] <= 1e-10 and errs[1] <= 1e-6 and errs[2] <= 1e-6, errs
