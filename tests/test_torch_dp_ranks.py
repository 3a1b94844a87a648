"""The rank side of the data-parallel test files
(``test_torch_parallel.py``, ``test_torch_dp_steps.py``,
``test_torch_dp_consist.py``, ``test_torch_dp_trainer.py``,
``test_torch_dp_seg.py``): the functions their two gloo ranks run, and
what those need.  It imports neither JAX nor the JAX package, so that a
rank, which imports the module of each function it runs, starts in a
few seconds; it holds no test.  The reduced models and knobs repeat
``test_torch_trainer.py``'s and ``test_torch_seg_trainer.py``'s.
"""
import os
import signal

import torch

import cnsn_tpu_torch.segmentation.fcn as port_fcn
import cnsn_tpu_torch.segmentation.trainer as port_trainer
import cnsn_tpu_torch.train.trainer as trainer_mod
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.data import cifar
from cnsn_tpu_torch.models import build_model
from cnsn_tpu_torch.models.allconv import AllConvNet
from cnsn_tpu_torch.models.resnet import ResNet
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.nn.cnsn import set_num_groups
from cnsn_tpu_torch.nn.norm import BatchNorm, BatchNorm1dStats
from cnsn_tpu_torch.parallel import process_batch_slice, world
from cnsn_tpu_torch.parallel.distributed import COLLECTIVES, shard_range
from cnsn_tpu_torch.parallel.mesh import DataParallel, make_mesh
from cnsn_tpu_torch.segmentation import FCNCNSN, SegResNet
from cnsn_tpu_torch.segmentation.data import synthetic_seg_dataset
from cnsn_tpu_torch.segmentation.trainer import SegConfig, SegTrainer
from cnsn_tpu_torch.train import StepFns, cosine_lr, create_train_state
from cnsn_tpu_torch.train.trainer import Trainer
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax

W = 2
C = 6  # BatchNorm's channels in test_torch_parallel.py
PORT = {"allconv": AllConvNet, "resnet": ResNet, "wrn": WideResNet}

# test_torch_trainer.py's WRN-10-2 runs, on the synthetic set
_WRN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "cifar10", "wideresnet")
SN, CNSN = (os.path.join(_WRN, f) for f in ("sn.yaml", "cnsn.yaml"))
DEPTH, WIDEN = 10, 2
OVER = dict(synthetic_data=True, snapshot=False, batch_size=16,
            eval_batch_size=64)
# 100 synthetic test images at batch 45: 23 rows a rank (rank 1's last
# one padding), then a tail of 10, 5 a rank
EVAL_BATCH, TEST_IMAGES = 45, 100

# test_torch_seg_trainer.py's reduced FCN-CNSN at 33², 5 classes, b=4
LAYERS = (1, 1, 1, 1)
CFG = dict(arch="fcn_cnsn", classes=5, train_h=33, train_w=33, batch_size=4,
           batch_size_val=4, epochs=1, cnsn_type="cnsn", pos="residual",
           cn_pos="post", block_idxs="1_2_3_4", crop="style", mix_prob=0.5,
           print_freq=1, seed=2, snapshot=False)
SEG_SETS = (dict(n=8, hw=(41, 41), classes=5),
            dict(n=5, hw=(33, 33), classes=5, seed=7))


def _knobs(kw):
    return {k: v for k, v in kw.items()
            if v is not None and k not in ("remat", "generator")}


class F64WideResNet(WideResNet):
    """WRN whose float64 parameters see float64 images (the loader's are
    float32)."""

    def forward(self, images, **kw):
        return super().forward(images.double(), **kw)


F64WideResNet.__name__ = "WideResNet"  # the checkpoint files' name


class _F64FCN(FCNCNSN):
    """An FCN whose float64 parameters see float64 images."""

    def forward(self, images, *a, **kw):
        return super().forward(images.double(), *a, **kw)


def _model_kw(cfg):
    return dict(block_idxs=cfg.block_idxs, pos=cfg.pos, cn_pos=cfg.cn_pos,
                cnsn_type=cfg.cnsn_type, crop=cfg.crop, beta=cfg.beta,
                dropout=0.0)


class _Batches:
    """A loader that yields the same batches every epoch."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _seg_datasets():
    return tuple(synthetic_seg_dataset(**kw) for kw in SEG_SETS)


def _slices():
    return process_batch_slice(8), [tuple(map(int, r)) for r in
                                     (shard_range(7, 0, 2),
                                      shard_range(7, 1, 2))]


def _bad_slice():
    process_batch_slice(9)


def _one_rank_fails():
    if world().rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()  # rank 0 waits for rank 1 in vain


def _replicated():
    """Rank 1 starts from other weights; ``replicate`` gives it rank 0's."""
    w = world()
    m = BatchNorm(C)
    with torch.no_grad():
        m.weight.fill_(float(w.rank + 1))
        m.running_var.fill_(float(w.rank + 3))
    DataParallel(make_mesh(2)).replicate(m)
    x = torch.arange(8.0).reshape(8, 1) * (w.rank + 1)
    return (m.weight.tolist(), m.running_var.tolist(),
            DataParallel(make_mesh()).shard_batch(x).flatten().tolist())


def _bn_rows(sd, x, r, groups, sample, var_impl):
    """BatchNorm on this rank's rows (on the whole batch without a
    group): out and dx of those rows, the running statistics, dweight and
    dbias of Σ out·r over those rows."""
    m = BatchNorm(C, groups=groups, stats_sample=sample, var_impl=var_impl)
    m.load_state_dict(sd)
    m.double().train()
    start, size = process_batch_slice(len(x))
    xt = torch.from_numpy(x[start:start + size]).permute(0, 3, 1, 2)
    xt = xt.contiguous(memory_format=torch.channels_last).requires_grad_()
    out = m(xt)
    (out * torch.from_numpy(r[start:start + size]).permute(0, 3, 1, 2)) \
        .sum().backward()
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()  # noqa: E731
    return (nhwc(out), nhwc(xt.grad), m.running_mean.numpy().copy(),
            m.running_var.numpy().copy(), m.weight.grad.numpy().copy(),
            m.bias.grad.numpy().copy(), dict(COLLECTIVES))


def _bn1d_rows(sd, y, r):
    m = BatchNorm1dStats(C)
    m.load_state_dict(sd)
    m.double().train()
    start, size = process_batch_slice(len(y))
    yt = torch.from_numpy(y[start:start + size]).requires_grad_()
    out = m(yt)
    (out * torch.from_numpy(r[start:start + size])).sum().backward()
    return (out.detach().numpy(), yt.grad.numpy(), m.running_mean.numpy(),
            m.running_var.numpy(), m.weight.grad.numpy(),
            m.bias.grad.numpy())


def _spawned(path):
    """A ``spawn`` rank: each writes its rank and the world size."""
    w = world()
    with open(os.path.join(path, f"rank{w.rank}"), "w") as f:
        f.write(f"{w.size} {w.backend}")


def _remat_rows(remat, seed):
    """A plain and a cn_image step of a reduced ResNet-50+SN (float64,
    64², global b=4) on this rank's rows, every bottleneck
    rematerialised or none: the state after them."""
    model = build_model("resnet50", 10, generator=torch.Generator()
                        .manual_seed(0), num_groups=W, layers=(1, 1, 1, 1),
                        pos="post", cnsn_type="sn", remat=remat)
    state = create_train_state(model.double(), cosine_lr(0.05, 4),
                               device="cpu")
    dp = DataParallel(make_mesh(W))
    gen = torch.Generator().manual_seed(seed)
    steps = StepFns(num_groups=W)
    for kind in ("plain", "cn_image"):
        x = dp.shard_batch(torch.randn(4, 64, 64, 3, generator=gen,
                                       dtype=torch.float64))
        y = dp.shard_batch(torch.randint(0, 10, (4,), generator=gen))
        kw = {} if kind == "plain" else {
            "generator": torch.Generator().manual_seed(seed)}
        getattr(steps, kind)(state, x, y, **kw)
    return state.model.state_dict()


def _cn_image_augmix_rows(images3, labels, perm):
    """One cn_image_augmix step of a reduced ResNet-50-IBN-b+SN (float64,
    64², the IBN-b recipe's knobs) on this rank's rows of the views (every
    row without a group), the pairing ``perm`` over the flattened 3B
    views: the global loss and the state."""
    model = build_model("resnet50_ibn_b", 10, generator=torch.Generator()
                        .manual_seed(0), num_groups=W, layers=(1, 1, 1, 1),
                        pos="residual", cnsn_type="sn")
    state = create_train_state(model.double(), cosine_lr(0.05, 4),
                               device="cpu")
    dp = DataParallel(make_mesh())
    im, lb = dp.shard_inputs(torch.from_numpy(images3),
                             torch.from_numpy(labels))
    state, got = StepFns(num_groups=W).cn_image_augmix(
        state, im, lb, perm=torch.as_tensor(perm))
    return float(dp.mean([got["loss"]])[0]), state.model.state_dict()


def _port_rank(name, kw, key_map, init, step, images, labels, lr, sgd,
               steps_kw, feed):
    """The port's ``step`` on this rank's rows (of axis 1 for the (3, B,
    ...) views): the global loss, ce and jsd, the state and momentum."""
    port = set_num_groups(PORT[name](**kw), W)
    port.load_state_dict(state_dict_from_jax(*init, key_map), strict=True)
    ts = create_train_state(port.double(), cosine_lr(*lr), device="cpu",
                            **sgd)
    dp = DataParallel(make_mesh(W))
    im, lb = dp.shard_inputs(torch.from_numpy(images),
                             torch.from_numpy(labels))
    ts, got = getattr(StepFns(num_groups=W, **steps_kw), step)(
        ts, im, lb, **feed)
    keys = [k for k in ("loss", "ce", "jsd") if k in got]
    metrics = dict(zip(keys, dp.mean([got[k] for k in keys]).tolist()))
    opt = ts.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"].clone()
                for n, p in ts.model.named_parameters()}
    return metrics, ts.model.state_dict(), momentum


def _test_loader(package, shard=None):
    """``TEST_IMAGES`` synthetic test images at ``EVAL_BATCH``, by either
    package's loader (``shard``: a rank's rows)."""
    data = package.load_cifar("", train=False, synthetic=True,
                              synthetic_size=TEST_IMAGES)
    kw = {} if shard is None else {"shard": shard}
    return package.CifarLoader(data, EVAL_BATCH, mode="eval", **kw)


def F64_BUILD(*a, num_groups=1, **kw):
    return set_num_groups(F64WideResNet(
        depth=DEPTH, widen_factor=WIDEN, num_classes=a[1],
        generator=kw.get("generator"), **_knobs(kw)), num_groups)


def _f64_factory():
    trainer_mod.build_model = F64_BUILD


def _rank_fit(exp, sd):
    """sn.yaml's epoch and evaluation on this rank, from ``sd`` in
    float64: the global losses of the steps, the epoch's mean, the
    evaluation, the state and momentum, the experiment directory."""
    _f64_factory()
    cfg = load_config(SN, **{**OVER, "exp_dir": exp, "num_devices": W,
                             "epochs": 1, "print_freq": 2,
                             "eval_batch_size": EVAL_BATCH})
    t = Trainer(cfg, device="cpu")
    w = world()
    t.train_loader = cifar.CifarLoader(cifar.load_cifar(
        "", synthetic=True, synthetic_size=64), 16, seed=cfg.seed,
        shard=(w.rank, w.size))
    t.test_loader = _test_loader(cifar, (w.rank, w.size))
    t.state.model.load_state_dict(sd)
    t.state.model.double()
    losses, plain, evaluate = [], t.steps.plain, t.evaluate_clean
    evals = []

    def record(*args):
        state, metrics = plain(*args)
        losses.append(float(t.dp.mean([metrics["loss"]])[0]))
        return state, metrics

    def record_eval():
        evals.append(evaluate())
        return evals[-1]

    t.steps.plain, t.evaluate_clean = record, record_eval
    t.fit()
    opt = t.state.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in t.state.model.named_parameters()}
    return dict(losses=losses, evals=evals, step=t.state.step,
                state=t.state.model.state_dict(), momentum=momentum,
                exp_dir=t.exp_dir, files=sorted(os.listdir(t.exp_dir)))


def _rank_sigterm(exp):
    """cnsn.yaml under ckpt_backend: orbax on this rank; rank 1 gets a
    SIGTERM inside its second step; each rank appends each step's number
    to a file of its own before taking it."""
    _f64_factory()
    cfg = load_config(CNSN, **{**OVER, "exp_dir": exp, "num_devices": W,
                               "epochs": 1, "ckpt_backend": "orbax",
                               "cn_prob": None})
    t = Trainer(cfg, device="cpu")
    w = world()
    t.train_loader = cifar.CifarLoader(cifar.load_cifar(
        "", synthetic=True, synthetic_size=64), 16, seed=cfg.seed,
        shard=(w.rank, w.size))
    plain = t.steps.plain

    def step(state, *args):
        with open(os.path.join(exp, f"steps{w.rank}"), "a") as f:
            f.write(f"{state.step + 1}\n")
        if w.rank == 1 and state.step + 1 == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return plain(state, *args)

    t.steps.plain = step
    t.fit()
    return "finished"


def _rank_seg(save, init, batches, fed):
    """The port's epoch of ``batches`` (this rank's rows of each) and its
    validation on this rank, JAX's aug draws ``fed`` in: the global
    losses of each step, the epoch's, the validation's, the rows of each
    batch the rank evaluated, the state."""
    port_fcn.seg_resnet50 = lambda **kw: SegResNet(layers=LAYERS, **kw)
    port_trainer.build_seg_model = lambda cfg, generator=None, num_groups=1: (
        set_num_groups(_F64FCN(classes=cfg.classes, generator=generator,
                               **_model_kw(cfg)), num_groups))
    cfg = SegConfig(save_path=save, num_devices=W, **CFG)
    pt = SegTrainer(cfg, *_seg_datasets(), device="cpu")
    pt.state.model.load_state_dict(
        state_dict_from_jax(*init, SEG_KEY_MAP), strict=True)
    pt.state.model.double()
    start, size = world().rank * 2, 2
    pt.train_loader = _Batches([(im[start:start + size],
                                 lb[start:start + size])
                                for im, lb in batches])
    kinds, losses, fed = [], [], list(fed)
    plain, aug = pt.steps.plain, pt.steps.aug
    keys = ("loss", "main_loss", "aux_loss")

    def rec(kind, state, m):
        kinds.append(kind)
        losses.append(dict(zip(keys, pt.dp.mean([m[k] for k in keys])
                               .tolist())))
        return state, m

    pt.steps.plain = lambda *a: rec("plain", *plain(*a))
    pt.steps.aug = lambda s, im, lb, generator=None: rec(
        "aug", *aug(s, im, lb, **fed.pop(0)))
    eval_sum, eval_rows = pt.steps.eval_sum, []
    pt.steps.eval_sum = lambda s, im, lb: (eval_rows.append(len(lb)),
                                           eval_sum(s, im, lb))[1]
    epoch = pt.train_epoch(0)
    val = pt.validate()
    return dict(kinds=kinds, losses=losses, epoch=epoch, val=val,
                eval_rows=eval_rows, gates=pt.gates,
                state=pt.state.model.state_dict())
