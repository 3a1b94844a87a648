"""The port's Trainer at two data-parallel ranks (two gloo processes on
the CPU, one ``RankPool`` for the module) against JAX's
``Trainer(num_devices=2)``, at the reduced WRN-10-2 of
``tests/test_torch_trainer.py`` (the model factory patched in each rank).

sn.yaml's plain regime, one epoch of 64 synthetic images at b=16 (8 a
rank) in float64 from JAX's initial weights: each step's global loss,
the epoch's mean, the state and the momentum after it at the float64
bounds; log.txt equal to JAX's and written by rank 0 alone (the
experiment directory holds what JAX's holds); the evaluation at batch
45 (23 rows a rank, rank 1's last one padding, as JAX pads the tail),
equal to JAX's (on 100 test images).  The W = 2 checkpoint loaded
into a one-process port Trainer (``resume=``) and into JAX's (as
``pretrained=`` loads it): the same accuracy.  Under ``ckpt_backend:
orbax`` a SIGTERM to rank 1 inside step 2 makes both ranks save nothing
more than step 2 (rank 0 writes it) and exit 143.  The ranks' side:
``test_torch_dp_ranks.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cnsn_tpu.train.trainer as jax_trainer_mod
import cnsn_tpu_torch.train.trainer as trainer_mod
from cnsn_tpu.config import load_config as jax_load_config
from cnsn_tpu.data import cifar as jax_cifar
from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu.utils.torch_import import import_torch_checkpoint
from cnsn_tpu_torch.config import load_config
from cnsn_tpu_torch.data import cifar
from cnsn_tpu_torch.parallel import RankPool
from cnsn_tpu_torch.train.trainer import Trainer
from cnsn_tpu_torch.utils.checkpoint import load_checkpoint
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_dp_ranks import (EVAL_BATCH, F64_BUILD, W, _rank_fit,
                                 _rank_sigterm, _test_loader)
from test_torch_trainer import (DEPTH, OVER, SN, WIDEN, _knobs,
                                small)  # noqa: F401 (fixture)
from test_torch_wideresnet import _find_trace, _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, str(tmp_path_factory.mktemp("store")), device="cpu",
                  timeout=90) as pool:
        yield pool


class _JaxWRN(JaxWideResNet):
    """JAX's WRN with its init compiled (op by op it takes seconds on the
    CPU)."""

    def init(self, rngs, x, *args):
        return jax.jit(lambda r, xx: JaxWideResNet.init(self, r, xx, *args))(
            rngs, x)


_JaxWRN.__name__ = "WideResNet"  # the checkpoint files' name


def test_epoch_log_eval_and_checkpoint_match_jax(ranks, small, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(
        jax_trainer_mod, "build_model",
        lambda name, num_classes, **kw: _JaxWRN(
            depth=DEPTH, widen_factor=WIDEN, num_classes=num_classes,
            **_knobs(kw)))
    jcfg = jax_load_config(SN, **{**OVER, "exp_dir": str(tmp_path / "jax"),
                                  "num_devices": W, "epochs": 1,
                                  "print_freq": 2,
                                  "eval_batch_size": EVAL_BATCH})
    with jax.enable_x64(True):
        jt = jax_trainer_mod.Trainer(jcfg)
        jt.train_loader = jax_cifar.CifarLoader(jax_cifar.load_cifar(
            "", synthetic=True, synthetic_size=64), 16, seed=jcfg.seed)
        jt.test_loader = _test_loader(jax_cifar)
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     (jt.state.params, jt.state.batch_stats))
        sd = state_dict_from_jax(*jax.tree.map(np.asarray, (
            jt.state.params, jt.state.batch_stats)))
        jt.state = jt.dp.replicate(jt.state.replace(
            params=params, batch_stats=stats,
            opt_state=jt.state.tx.init(params)))
        want_losses, plain = [], jt.steps.plain
        want_evals, evaluate = [], jt.evaluate_clean

        def record(*args):
            state, metrics = plain(*args)
            want_losses.append(float(metrics["loss"]))
            return state, metrics

        def record_eval():
            want_evals.append(evaluate())
            return want_evals[-1]

        jt.steps.plain, jt.evaluate_clean = record, record_eval
        jt.fit()
        want = state_dict_from_jax(_np64(jt.state.params),
                                   _np64(jt.state.batch_stats))
        want_m = state_dict_from_jax(_np64(_find_trace(jt.state.opt_state)),
                                     {})
    got = ranks.run(_rank_fit, str(tmp_path / "port"), sd)
    assert got[0]["exp_dir"] == got[1]["exp_dir"]
    for g in got:
        assert g["step"] == 4 and len(g["losses"]) == 4
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(g["losses"], want_losses))
        errs = (loss_err, _worst(g["state"], want),
                _worst(g["momentum"], want_m))
        assert all(e <= b for e, b in zip(errs, (1e-10, 1e-6, 1e-6))), errs
        # the padded evaluation: the same hits; the loss to float32
        (loss, acc), = g["evals"]
        (want_loss, want_acc), = want_evals
        assert acc == want_acc
        # (JAX takes the eval log-softmax in float32: cnsn_tpu/train/
        # steps.py:309)
        assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    # rank 0 alone wrote the directory: what JAX's Trainer writes, log.txt
    # once, rows equal to JAX's
    exp = got[0]["exp_dir"]
    assert got[0]["files"] == sorted(os.listdir(jt.exp_dir))
    log = open(os.path.join(exp, "log.txt")).read()
    assert log == open(jt.log_file).read() and log.count("dataset:") == 1

    # the checkpoint of two ranks into one process: the port's Trainer
    # (resume=) and JAX's (pretrained=)
    ckpt = os.path.join(exp, "WideResNet_last_ckpt")
    cfg = load_config(SN, **{**OVER, "exp_dir": str(tmp_path / "one"),
                             "eval_batch_size": EVAL_BATCH, "resume": ckpt})
    one = Trainer(cfg, device="cpu")
    one.test_loader = _test_loader(cifar)
    assert one.state.step == 4 and one.start_epoch == 1
    # JAX's Trainer takes it as ``pretrained=`` takes it
    # (cnsn_tpu/train/trainer.py:126-138), no key left over
    new, missing = import_torch_checkpoint(
        ckpt, {"params": jt.state.params,
               "batch_stats": jt.state.batch_stats}, strict=False)
    assert missing == []
    jt.state = jt.dp.replicate(jt.state.replace(
        params=new["params"], batch_stats=new["batch_stats"]))
    assert jt.evaluate_clean()[1] == one.evaluate_clean()[1]  # float32
    monkeypatch.setattr(trainer_mod, "build_model", F64_BUILD)
    one = Trainer(cfg, device="cpu")
    one.test_loader = _test_loader(cifar)
    one.state.model.double().load_state_dict(
        load_checkpoint(ckpt)["state_dict"])
    assert one.evaluate_clean()[1] == want_acc


def test_sigterm_on_one_rank_flushes_both_at_the_same_step(small, tmp_path):
    exp = str(tmp_path / "exp")
    os.makedirs(exp)
    with RankPool(W, str(tmp_path / "store"), device="cpu",
                  timeout=60) as pool:
        with pytest.raises(RuntimeError, match="exited"):
            pool.run(_rank_sigterm, exp)
        assert pool.exitcodes == [143, 143]
    for r in range(W):
        assert open(os.path.join(exp, f"steps{r}")).read().split() == \
            ["1", "2"]
    [run] = [os.path.join(exp, d, e) for d in os.listdir(exp)
             if os.path.isdir(os.path.join(exp, d))
             for e in os.listdir(os.path.join(exp, d))]
    assert os.listdir(os.path.join(run, "orbax")) == ["2"]
