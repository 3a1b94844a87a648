"""The port's Trainer (cnsn_tpu_torch.train.trainer) against the JAX
package's on the CPU, at a reduced WRN (the model factories patched in
this file only) on the loaders' synthetic set: a plain epoch in float64
from the same weights, the sequence of CN gates and step functions, the
log.txt layout, the checkpoint (resume, and the interchange into the JAX
Trainer through ``pretrained=``) and what raises (the CLI and the
CIFAR-C evaluation: tests/test_torch_trainer_cli.py).

The JAX Trainer runs at ``num_devices=1``: the conftest gives it 8 CPU
devices, and with more than one its models take per-shard BN statistics
(``num_groups``), which the port does not have yet.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import cnsn_tpu.train.trainer as jax_trainer_mod
import cnsn_tpu_torch.models as port_models
import cnsn_tpu_torch.train.trainer as trainer_mod
from cnsn_tpu.config import load_config as jax_load_config
from cnsn_tpu.data import cifar as jax_cifar
from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.data import cifar
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.train.trainer import Trainer
from cnsn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_wideresnet import _find_trace, _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)


_WRN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnsn_tpu", "configs", "cifar10", "wideresnet")
SN, CN, CNSN = (os.path.join(_WRN, f) for f in ("sn.yaml", "cn.yaml",
                                                 "cnsn.yaml"))
DEPTH, WIDEN = 10, 2
# every run: the synthetic set, no code snapshot, one device on JAX's side
OVER = dict(synthetic_data=True, snapshot=False, batch_size=16,
            eval_batch_size=64)


def _knobs(kw):
    return {k: v for k, v in kw.items()
            if v is not None and k not in ("remat", "generator")}


@pytest.fixture
def small(monkeypatch):
    """Both Trainers (and the port's export) build WRN-10-2."""
    def jax_build(name, num_classes, **kw):
        return JaxWideResNet(depth=DEPTH, widen_factor=WIDEN,
                             num_classes=num_classes, **_knobs(kw))

    def port_build(name, num_classes, generator=None, **kw):
        return WideResNet(depth=DEPTH, widen_factor=WIDEN,
                          num_classes=num_classes, generator=generator,
                          **_knobs(kw))

    monkeypatch.setattr(jax_trainer_mod, "build_model", jax_build)
    monkeypatch.setattr(trainer_mod, "build_model", port_build)
    monkeypatch.setattr(port_models, "build_model", port_build)
    return port_build


def _configs(recipe, tmp_path, **kw):
    """The port's and JAX's config, each with an exp_dir of its own (both
    name a run by the second it starts)."""
    over = {**OVER, **kw}
    return (load_config(recipe, exp_dir=str(tmp_path / "port"), **over),
            jax_load_config(recipe, num_devices=1,
                            exp_dir=str(tmp_path / "jax"), **over))


def _loaders(n, batch, seed):
    """The same synthetic train set of ``n`` images for both packages."""
    return (cifar.CifarLoader(cifar.load_cifar("", synthetic=True,
                                               synthetic_size=n), batch,
                              seed=seed),
            jax_cifar.CifarLoader(jax_cifar.load_cifar(
                "", synthetic=True, synthetic_size=n), batch, seed=seed))


def _load_jax_weights(port, jax_state):
    port.state.model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, jax_state.params),
        jax.tree.map(np.asarray, jax_state.batch_stats)), strict=True)


class _F64WideResNet(WideResNet):
    """WRN whose float64 parameters see float64 images (the loader's are
    float32; JAX promotes them against float64 parameters)."""

    def forward(self, images, **kw):
        return super().forward(images.double(), **kw)


def test_plain_epoch_matches_jax_in_float64(small, monkeypatch, tmp_path):
    """sn.yaml's plain regime, 64 images at b=16 (4 steps) through each
    Trainer's train_epoch, both in float64 from JAX's initial weights:
    every step's loss, the epoch's mean, and after it every parameter and
    running statistic and every momentum buffer, at the float64 bounds of
    tests/test_torch_train.py."""
    monkeypatch.setattr(trainer_mod, "build_model",
                        lambda *a, **kw: _F64WideResNet(
                            depth=DEPTH, widen_factor=WIDEN,
                            num_classes=a[1], generator=kw.get("generator"),
                            **_knobs(kw)))
    cfg, jcfg = _configs(SN, tmp_path, print_freq=2)
    assert (cfg.regime, cfg.cn_prob) == ("plain", None)
    port_loader, jax_loader = _loaders(64, 16, cfg.seed)
    with jax.enable_x64(True):
        jt = jax_trainer_mod.Trainer(jcfg)
        jt.train_loader = jax_loader
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     (jt.state.params, jt.state.batch_stats))
        init = jt.state
        jt.state = jt.dp.replicate(jt.state.replace(
            params=params, batch_stats=stats,
            opt_state=jt.state.tx.init(params)))
        want_losses, plain = [], jt.steps.plain

        def record(*args):
            state, metrics = plain(*args)
            want_losses.append(float(metrics["loss"]))
            return state, metrics

        jt.steps.plain = record
        want_avg = jt.train_epoch()
        want = state_dict_from_jax(_np64(jt.state.params),
                                   _np64(jt.state.batch_stats))
        want_m = state_dict_from_jax(_np64(_find_trace(jt.state.opt_state)),
                                     {})
        assert int(jt.state.step) == 4

    pt = Trainer(cfg, device="cpu")
    pt.train_loader = port_loader
    _load_jax_weights(pt, init)
    pt.state.model.double()
    got_losses, plain = [], pt.steps.plain

    def record_port(*args):
        state, metrics = plain(*args)
        got_losses.append(float(metrics["loss"]))
        return state, metrics

    pt.steps.plain = record_port
    got_avg = pt.train_epoch()
    assert pt.state.step == 4 and len(got_losses) == 4
    opt = pt.state.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in pt.state.model.named_parameters()}
    loss_err = max(abs(g - w) / abs(w) for g, w in
                   zip(got_losses + [got_avg], want_losses + [want_avg]))
    errs = (loss_err, _worst(pt.state.model.state_dict(), want),
            _worst(momentum, want_m))
    assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs


def _stub_steps(port, jt, calls):
    """Replace both Trainers' steps by stubs that record (package, step
    function, labels) and leave the state as it is."""
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

    for name in ("plain", "cn"):
        setattr(port.steps, name, port_step(name))
        setattr(jt.steps, name, jax_step(name))


@pytest.mark.parametrize("recipe", [SN, CN, CNSN])
def test_gates_and_step_functions_match_jax(small, recipe, tmp_path):
    """Two epochs of 64 steps at b=8: each step's function (plain or cn,
    by the gate RandomState(seed).rand() < cn_prob, drawn in JAX's order)
    and its labels, equal to JAX's Trainer's."""
    cfg, jcfg = _configs(recipe, tmp_path, batch_size=8)
    port, jt = Trainer(cfg, device="cpu"), jax_trainer_mod.Trainer(jcfg)
    calls = []
    _stub_steps(port, jt, calls)
    for _ in range(2):
        port.train_epoch()
        jt.train_epoch()
    got = [c[1:] for c in calls if c[0] == "port"]
    want = [c[1:] for c in calls if c[0] == "jax"]
    assert len(got) == 2 * 512 // 8 and got == want
    n_cn = sum(name == "cn" for name, _ in got)
    assert (n_cn == 0) == (cfg.cn_prob is None)


def test_log_txt_matches_jax(small, tmp_path):
    """fit over two epochs (steps stubbed, so both models keep JAX's
    initial weights): log.txt's header lines and tab-separated rows equal
    JAX's, and each epoch leaves the checkpoints JAX's Trainer leaves."""
    cfg, jcfg = _configs(CNSN, tmp_path, epochs=2)
    port, jt = Trainer(cfg, device="cpu"), jax_trainer_mod.Trainer(jcfg)
    _load_jax_weights(port, jt.state)
    _stub_steps(port, jt, [])
    port.fit()
    jt.fit()
    got = open(port.log_file).read()
    assert got == open(jt.log_file).read()
    lines = got.splitlines()
    assert lines[:6] == ["dataset: cifar10", "batch size: 16", "lr: 0.1",
                         "momentum: 0.9", "weight_decay: 0.0005",
                         "epoch\tlr\tTrain Loss\tTest Err1\tBest Test Err1"]
    assert [r.split("\t")[0] for r in lines[6:]] == ["0", "1"]
    assert sorted(os.listdir(port.exp_dir)) == sorted(os.listdir(jt.exp_dir))


def _train_small(cfg, n=64):
    """A port Trainer after one real epoch of ``n`` synthetic images."""
    t = Trainer(cfg, device="cpu")
    t.train_loader = _loaders(n, cfg.batch_size, cfg.seed)[0]
    t.train_epoch()
    return t


def test_port_checkpoint_loads_into_the_jax_trainer(small, tmp_path,
                                                   capsys):
    """A port checkpoint (4 SGD steps from the port's own init) is a
    torch .pth that JAX's Trainer takes through ``pretrained=`` with no
    key left over; both evaluations give the same accuracy."""
    cfg, _ = _configs(CNSN, tmp_path)
    port = _train_small(cfg)
    path = save_checkpoint(port.state, "WideResNet", port.exp_dir, 1, 0.5,
                           False)
    assert sorted(load_checkpoint(path)) == ["best_acc", "epoch",
                                             "optimizer", "state_dict",
                                             "step"]
    jcfg = jax_load_config(CNSN, num_devices=1, pretrained=path,
                           **{**OVER, "exp_dir": str(tmp_path)})
    capsys.readouterr()
    jt = jax_trainer_mod.Trainer(jcfg)
    assert f"loaded pretrained '{path}' (0 unmatched keys)" in \
        capsys.readouterr().out
    got, want = port.evaluate_clean(), jt.evaluate_clean()
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


def test_pretrained_counts_the_keys_it_cannot_load(small, tmp_path, capsys):
    """A CIFAR-100 checkpoint into a CIFAR-10 Trainer: every tensor but the
    classifier's weight and bias loads (strict=False)."""
    cfg100, _ = _configs(CNSN, tmp_path, dataset="cifar100")
    src = Trainer(cfg100, device="cpu")
    path = save_checkpoint(src.state, "WideResNet", src.exp_dir, 1, 0.0,
                           False)
    cfg, _ = _configs(CNSN, tmp_path, pretrained=path)
    capsys.readouterr()
    t = Trainer(cfg, device="cpu")
    assert "(2 unmatched keys)" in capsys.readouterr().out
    got, want = t.state.model.state_dict(), src.state.model.state_dict()
    for k in want:
        if k.startswith("fc."):
            assert got[k].shape != want[k].shape
        else:
            assert torch.equal(got[k], want[k]), k


def test_resume_restores_weights_momentum_and_step(small, tmp_path):
    """save_checkpoint → Trainer(resume=) → evaluate_clean unchanged; the
    momentum buffers, the update count (so the LR schedule continues), the
    epoch and best accuracy restored; the next step equal on both."""
    cfg, _ = _configs(CNSN, tmp_path)
    t = _train_small(cfg)
    loss, acc = t.evaluate_clean()
    path = save_checkpoint(t.state, "WideResNet", t.exp_dir, 3, acc, True,
                           keep_epoch_file=True)
    assert {"WideResNet_last_ckpt", "WideResNet_best_ckpt",
            "WideResNet_ckpt_3"} <= set(os.listdir(t.exp_dir))
    r = Trainer(dataclasses.replace(cfg, resume=path), device="cpu")
    assert (r.start_epoch, r.best_acc, r.exp_dir) == (3, acc, t.exp_dir)
    assert r.state.step == t.state.step == 4
    assert r.evaluate_clean() == (loss, acc)
    for (n, p), (_, q) in zip(t.state.model.named_parameters(),
                              r.state.model.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(t.state.optimizer.state[p]["momentum_buffer"],
                           r.state.optimizer.state[q]["momentum_buffer"]), n
    for k, v in t.state.model.state_dict().items():
        assert torch.equal(v, r.state.model.state_dict()[k]), k
    rng = np.random.RandomState(9)
    images = torch.from_numpy(rng.randn(16, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, 16))
    for tr in (t, r):
        tr.steps.plain(tr.state, images, labels)
    for k, v in t.state.model.state_dict().items():
        assert torch.equal(v, r.state.model.state_dict()[k]), k


# a ResNet-50 at 32², b=2: the ImageNet recipes' model, remat reaching it
_R50_REMAT = dict(dataset="imagenet", model="resnet50", cnsn_type="sn",
                  pos="post", image_size=32, batch_size=2, remat=True)


@pytest.mark.parametrize("recipe,over,match", [
    (CNSN, dict(ckpt_backend="orbax"), None),
    (CNSN, dict(fsdp=True), "fsdp"),
    (CNSN, dict(num_devices=2), "num_devices"),
    (CNSN, dict(remat=True), None),
    (CNSN, _R50_REMAT, None),
    ("cnsn-augmix.yaml", dict(fsdp=True), "fsdp"),
])
def test_unported_knobs_raise_at_construction(recipe, over, match,
                                              tmp_path, monkeypatch):
    """fsdp and num_devices > 1 name their ROADMAP item, before anything is
    built or written, on CIFAR and an AugMix recipe alike.  The knobs this
    name listed before they were ported build and take a step: orbax (its
    checkpointer under the experiment directory), remat on WRN (ignored,
    as JAX ignores it on a non-ResNet: cnsn_tpu/train/trainer.py:58-59)
    and on an ImageNet ResNet-50 (every bottleneck rematerialised)."""
    data = (dict(data_dir=_image_folder(tmp_path / "data"))
            if over.get("dataset") == "imagenet"
            else dict(synthetic_data=True))
    exp = tmp_path / "exp"
    cfg = load_config(os.path.join(_WRN, recipe), exp_dir=str(exp),
                      snapshot=False, **data, **over)
    if match is not None:
        with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP"):
            Trainer(cfg, device="cpu")
        assert not exp.exists()
        return
    import cnsn_tpu_torch.models.remat as remat_mod
    calls = []
    checkpoint = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda *a, **k: calls.append(1) or checkpoint(*a, **k))
    t = Trainer(cfg, device="cpu")
    try:
        size = cfg.image_size or 32
        rng = np.random.RandomState(0)
        images = torch.from_numpy(rng.randn(cfg.batch_size, size, size, 3)
                                  .astype(np.float32))
        labels = torch.from_numpy(rng.randint(0, t.cfg.num_classes,
                                              cfg.batch_size))
        before = [p.detach().clone() for p in t.state.model.parameters()]
        _, metrics = t.steps.plain(t.state, images, labels)
        assert np.isfinite(float(metrics["loss"])) and t.state.step == 1
        assert any(not torch.equal(p, q) for p, q in
                   zip(t.state.model.parameters(), before))
        resnet = over.get("model") == "resnet50"
        assert getattr(t.model, "remat", False) is resnet
        assert len(calls) == (16 if resnet else 0)
        if over.get("ckpt_backend") == "orbax":
            assert t.ckpt.save(t.state.step, t.state, wait=True)
            assert t.ckpt.all_steps() == [1]
            assert os.path.dirname(t.ckpt.directory) == t.exp_dir
    finally:
        t.close()


def _image_folder(root):
    """train/ and validation/ of two classes, one JPEG each."""
    rng = np.random.RandomState(4)
    for split in ("train", "validation"):
        for c in range(2):
            os.makedirs(root / split / f"c{c}")
            Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)).save(
                root / split / f"c{c}" / "0.jpeg")
    return str(root)


@pytest.mark.parametrize("recipe,over,mode,steps", [
    (CNSN, dict(dataset="imagenet", cnsn_type="sn", image_size=32,
                batch_size=2),
     "train", ("cn_image", "plain")),
    (CNSN, dict(no_jsd=True, regime="cn_augmix"), "train_augmix_nojsd",
     ("cn", "plain")),
    ("cnsn-augmix.yaml", {}, "train_augmix", ("augmix_cn", "augmix")),
    (CNSN, dict(regime="cn_image_augmix"), "train_augmix",
     ("cn_image_augmix", "augmix")),
], ids=["imagenet", "no_jsd", "cnsn-augmix.yaml", "cn_image_augmix"])
def test_knobs_ported_since_build_at_construction(small, recipe, over, mode,
                                                  steps, tmp_path):
    """ImageNet, no_jsd and the AugMix regimes, which raised before this
    slice, build: the loader's mode and the gate's (gated, otherwise)
    step functions, JAX's (cnsn_tpu/train/trainer.py:259-283)."""
    data = (dict(data_dir=_image_folder(tmp_path / "data"))
            if over.get("dataset") == "imagenet"
            else dict(synthetic_data=True))
    cfg = load_config(os.path.join(_WRN, recipe), snapshot=False,
                      exp_dir=str(tmp_path / "exp"), **data, **over)
    t = Trainer(cfg, device="cpu")
    assert t.train_loader.mode == mode
    assert (t._gated, t._ungated) == steps
    t.close()


def test_no_jsd_on_imagenet_raises(tmp_path):
    cfg = load_config(CNSN, dataset="imagenet", no_jsd=True,
                      exp_dir=str(tmp_path))
    with pytest.raises(ValueError, match="no_jsd is a CIFAR AugMix knob"):
        Trainer(cfg, device="cpu")
    assert os.listdir(tmp_path) == []


def test_trainer_defaults_to_cuda_and_does_not_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error")
    cfg = load_config(CNSN, exp_dir=str(tmp_path), synthetic_data=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    assert os.listdir(tmp_path) == []
