"""Segmentation checkpoints, on the CPU, at the FCN-CNSN of layers
(1, 1, 1, 1) of ``test_torch_seg_trainer.py`` (its fixture and helpers):
port → port ``resume`` (weights, statistics, momentum, update count,
epoch) with keep-last-N rotation of ``seg_ckpt_<epoch>``, and port → JAX
``SegTrainer.resume``: the port's ``seg_ckpt_<epoch>`` carried into JAX's
trees by ``convert_state_dict`` (the momentum buffers into optax's trace,
the update count into its schedule count), written as JAX's msgpack
checkpoint, restored by JAX's trainer and validated, in float64."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cnsn_tpu.segmentation.trainer as jax_trainer
from cnsn_tpu.segmentation import SegTrainState as JaxSegTrainState
from cnsn_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from cnsn_tpu.utils.torch_import import convert_state_dict
from cnsn_tpu_torch.utils.checkpoint import load_checkpoint
from cnsn_tpu_torch.utils.jax_params import SEG_KEY_MAP, state_dict_from_jax
from test_torch_seg_ops import patch_jax_float64
from test_torch_seg_trainer import (_configs, _datasets, _port_trainer,
                                    small)  # noqa: F401 (a fixture)
from test_torch_wideresnet import _np64, _worst
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _jax_opt_state(tx, params, trace, step):
    """optax's state of the seg chain with this momentum trace and this
    update count in the schedule."""
    out = []
    for s in tx.init(params):
        if isinstance(s, optax.TraceState):
            s = s._replace(trace=trace)
        elif isinstance(s, optax.ScaleByScheduleState):
            s = s._replace(count=jnp.asarray(step, s.count.dtype))
        out.append(s)
    return tuple(out)


def _port_ckpt_to_jax(path, jt, out_dir):
    """A port seg checkpoint as JAX's msgpack checkpoint, for JAX's
    ``SegTrainer.resume``."""
    payload = load_checkpoint(path)
    like = (jax.tree.map(np.asarray, jt.state.params),
            jax.tree.map(np.asarray, jt.state.batch_stats))
    params, stats, missing = convert_state_dict(
        payload["state_dict"], *like, strict=True, key_map=SEG_KEY_MAP,
        dtype=np.float64)
    assert not missing
    # the optimizer numbers the parameters group by group (body, head),
    # which is their order in the state dict
    names = [k for k in payload["state_dict"]
             if not k.endswith(("running_mean", "running_var"))]
    index = [i for g in payload["optimizer"]["param_groups"]
             for i in g["params"]]
    assert len(index) == len(names)
    buffers = {n: payload["optimizer"]["state"][i]["momentum_buffer"]
               for n, i in zip(names, index)}
    trace, _, missing = convert_state_dict(buffers, like[0], {}, strict=True,
                                           key_map=SEG_KEY_MAP,
                                           dtype=np.float64)
    assert not missing
    state = JaxSegTrainState(
        step=payload["step"], apply_fn=jt.model.apply, params=params,
        batch_stats=stats, tx=jt.state.tx,
        opt_state=_jax_opt_state(jt.state.tx, params, trace,
                                 payload["step"]))
    return jax_save_checkpoint(state, "seg", out_dir, payload["epoch"], 0.0,
                               False)


def test_checkpoints_resume_in_the_port_and_in_jax(small, monkeypatch,
                                                   tmp_path):
    cfg, jcfg = _configs(tmp_path, "ckpt", keep_last=2)
    patch_jax_float64(monkeypatch)
    with jax.enable_x64(True):
        jt = jax_trainer.SegTrainer(jcfg, *_datasets(False))
        init = (_np64(jt.state.params), _np64(jt.state.batch_stats))
    pt = _port_trainer(cfg, small, init)
    pt.train_epoch(0)
    for epoch in (1, 2, 3):
        path = pt.save_checkpoint(epoch)
    files = sorted(f for f in os.listdir(cfg.save_path)
                   if f.startswith("seg_"))
    assert files == ["seg_ckpt_2", "seg_ckpt_3", "seg_last_ckpt"]
    assert path.endswith("seg_last_ckpt")
    want_val = pt.validate()
    opt = pt.state.optimizer
    momentum = {n: opt.state[p]["momentum_buffer"]
                for n, p in pt.state.model.named_parameters()}

    # port -> port
    ckpt = os.path.join(cfg.save_path, "seg_ckpt_3")
    cfg2, _ = _configs(tmp_path, "ckpt2", resume=ckpt)
    p2 = _port_trainer(cfg2, small, init)
    p2.resume(ckpt)
    assert p2.state.step == pt.state.step == 2 and p2.cfg.start_epoch == 3
    assert _worst(p2.state.model.state_dict(),
                  {k: v.double() for k, v in
                   pt.state.model.state_dict().items()}) == 0
    opt2 = p2.state.optimizer
    assert all(torch.equal(opt2.state[p]["momentum_buffer"], momentum[n])
               for n, p in p2.state.model.named_parameters())
    val2 = p2.validate()
    for k in ("loss", "mIoU", "mAcc", "allAcc"):
        assert val2[k] == want_val[k], k
    np.testing.assert_array_equal(val2["iou_class"], want_val["iou_class"])

    # port -> JAX SegTrainer.resume
    with jax.enable_x64(True):
        jpath = _port_ckpt_to_jax(ckpt, jt, str(tmp_path / "to_jax"))
        _, jcfg2 = _configs(tmp_path, "ckpt3", resume=jpath)
        j2 = jax_trainer.SegTrainer(jcfg2, *_datasets(False))
        assert j2.cfg.start_epoch == 3 and int(j2.state.step) == 2
        got = state_dict_from_jax(_np64(j2.state.params),
                                  _np64(j2.state.batch_stats), SEG_KEY_MAP)
        assert _worst(got, pt.state.model.state_dict()) <= 1e-6
        val = j2.validate()
    assert val["loss"] == pytest.approx(want_val["loss"], rel=1e-10)
    assert val["mIoU"] == pytest.approx(want_val["mIoU"], abs=1e-12)
