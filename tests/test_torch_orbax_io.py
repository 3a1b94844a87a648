"""The port's step checkpointer (``cnsn_tpu_torch/utils/orbax_io.py``)
and the Trainers' ``ckpt_backend: orbax``, on the CPU.

  * save, restore and ``latest_step``; an empty directory restores
    nothing; a leftover temporary directory is not a step;
  * the steps kept after a sequence of saves (keep 2; a step not above the
    newest is skipped) equal those JAX's ``OrbaxCheckpointer`` keeps after
    the same saves of a tiny pytree;
  * an asynchronous save holds the state as it was when ``save``
    returned, whatever the next step changes in place;
  * preemption: a Trainer (WRN-10-1 on the synthetic set, host AugMix in
    a worker process) in a subprocess gets SIGTERM after two steps: it
    flushes, exits with 143 and leaves no process behind; a second
    process pointed at the experiment directory restores exactly the
    flushed step (its state equal to the files) and one more step makes
    it step + 1 (JAX: ``tests/test_trainer_orbax.py``);
  * the SegTrainer's auto-restore (JAX ``tests/test_segmentation.py:
    298``, at one device), at layers (1, 1, 1, 1).

This file is also the subprocess's entry point:
``python tests/test_torch_orbax_io.py train|resume <exp_dir>``.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIFAR_AUGMIX = os.path.join(ROOT, "cnsn_tpu", "configs", "cifar10",
                            "wideresnet", "cnsn-augmix.yaml")
TIMEOUT = 120  # seconds a subprocess may take


def _state(seed=0):
    from cnsn_tpu_torch.models.wideresnet import WideResNet
    from cnsn_tpu_torch.train import create_train_state
    model = WideResNet(depth=10, widen_factor=1, num_classes=10,
                       generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, lambda s: 0.1, device="cpu")


def _step(state, seed=0):
    from cnsn_tpu_torch.train import StepFns
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, 4))
    return StepFns().plain(state, images, labels)[0]


def _equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if any(not torch.equal(sa[k], sb[k]) for k in sa):
        return False
    return all(torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           b.optimizer.state[q]["momentum_buffer"])
               for p, q in zip(a.model.parameters(), b.model.parameters()))


def test_save_restore_latest_step(tmp_path):
    from cnsn_tpu_torch.utils.orbax_io import OrbaxCheckpointer
    ckpt = OrbaxCheckpointer(str(tmp_path / "orbax"), keep=2)
    fresh = _state(1)
    assert ckpt.restore(fresh) == (fresh, None, {})
    saved = _step(_state())
    assert ckpt.save(1, saved, extra={"epoch": 3, "best_acc": 0.5},
                     metrics={"test_acc": 0.5}, wait=True)
    assert ckpt.latest_step() == 1 and not _equal(fresh, saved)
    state, step, extra = ckpt.restore(fresh, extra_template={
        "epoch": 0, "best_acc": 0.0, "other": 7})
    assert step == 1 and state is fresh and state.step == 1
    assert extra == {"epoch": 3, "best_acc": 0.5, "other": 7}
    assert _equal(fresh, saved)
    # a leftover temporary directory and a stray name are not steps
    os.makedirs(tmp_path / "orbax" / ".2.tmp-999")
    os.makedirs(tmp_path / "orbax" / "notes")
    assert ckpt.all_steps() == [1] and ckpt.latest_step() == 1
    ckpt.close()


SEQUENCES = ([1, 2, 3, 4, 5], [1, 2, 3, 3, 2, 5], [5, 3, 7], [2, 2])


def test_retention_matches_jax_orbax(tmp_path):
    import dataclasses

    import jax.numpy as jnp
    from flax import struct

    from cnsn_tpu.utils.orbax_io import OrbaxCheckpointer as JaxCheckpointer
    from cnsn_tpu_torch.utils.orbax_io import OrbaxCheckpointer

    @struct.dataclass
    class Tiny:
        params: dict
        batch_stats: dict
        opt_state: dict
        step: int

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    tiny = Tiny({"w": jnp.ones(3)}, {"m": jnp.zeros(2)}, {"t": jnp.ones(1)},
                0)
    state = _state()
    for i, seq in enumerate(SEQUENCES):
        jax_ckpt = JaxCheckpointer(str(tmp_path / f"jax{i}"), keep=2)
        port = OrbaxCheckpointer(str(tmp_path / f"port{i}"), keep=2)
        for step in seq:
            jax_ckpt.save(step, tiny, extra={"epoch": step}, wait=True)
            port.save(step, state, extra={"epoch": step}, wait=True)
        want = list(jax_ckpt.manager.all_steps())
        jax_ckpt.close()
        assert port.all_steps() == want, seq
        assert port.restore(_state(1))[2] == {"epoch": want[-1]}


def test_async_save_does_not_see_a_later_change(tmp_path):
    from cnsn_tpu_torch.utils.orbax_io import OrbaxCheckpointer
    ckpt = OrbaxCheckpointer(str(tmp_path / "orbax"))
    state = _step(_state())
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert ckpt.save(1, state)  # returns with the write in flight
    _step(state, seed=1)        # mutates the parameters in place
    ckpt.wait_until_finished()
    restored, step, _ = ckpt.restore(_state(1))
    assert step == 1
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(state.model.conv1.weight, before["conv1.weight"])


def _session_processes(sid):
    """Pids of live processes in session ``sid`` (read from /proc)."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(name))
    return pids


def _spawn(mode, exp_dir):
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, exp_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, start_new_session=True)


def test_sigterm_mid_epoch_flushes_and_resumes(tmp_path):
    exp_dir = str(tmp_path / "exp")
    os.makedirs(exp_dir)
    p = _spawn("train", exp_dir)
    seen, t0 = 0, time.time()
    for line in p.stdout:
        seen += "Train Loss" in line
        if seen >= 2:
            break
        assert time.time() - t0 < TIMEOUT, "training never started"
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=TIMEOUT)
    assert p.returncode == 143, out[-2000:]
    # the worker pool and its server go with the process
    deadline = time.time() + 10
    while _session_processes(p.pid) and time.time() < deadline:
        time.sleep(0.1)
    assert _session_processes(p.pid) == []

    r = _spawn("resume", exp_dir)
    out, _ = r.communicate(timeout=TIMEOUT)
    assert r.returncode == 0, out[-2000:]
    rec = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert rec["restored_step"] >= 2 and rec["start_epoch"] == 0
    assert rec["state_step"] == rec["restored_step"]
    assert rec["equal_to_files"]
    assert rec["step_after_one"] == rec["restored_step"] + 1


def test_seg_trainer_orbax_auto_restore(tmp_path, monkeypatch):
    import cnsn_tpu_torch.segmentation.fcn as port_fcn
    from cnsn_tpu_torch.segmentation import SegResNet
    from cnsn_tpu_torch.segmentation.data import synthetic_seg_dataset
    from cnsn_tpu_torch.segmentation.trainer import SegConfig, SegTrainer
    monkeypatch.setattr(port_fcn, "seg_resnet50", lambda **k: SegResNet(
        layers=(1, 1, 1, 1), **k))
    kw = dict(arch="fcn_cnsn", classes=5, train_h=33, train_w=33,
              batch_size=4, batch_size_val=4, epochs=1, cnsn_type="sn",
              pos="residual", cn_pos=None, block_idxs="1", crop="neither",
              save_path=str(tmp_path), print_freq=2, snapshot=False,
              ckpt_backend="orbax", eval_freq=100)
    train = synthetic_seg_dataset(8, hw=(41, 41), classes=5)
    tr = SegTrainer(SegConfig(**kw), train, None, device="cpu")
    tr.fit()
    tr.close()
    assert tr.state.step == 2 and tr.ckpt.all_steps() == [2]

    tr2 = SegTrainer(SegConfig(**kw), train, None, device="cpu")
    assert tr2.state.step == 2 and tr2.cfg.start_epoch == 1
    assert _equal(tr.state, tr2.state)
    tr2.close()


# ---------------------------------------------------------------------------
# the subprocess's entry point
# ---------------------------------------------------------------------------

def _trainer(exp_dir):
    torch.set_num_threads(1)
    import cnsn_tpu_torch.train.trainer as trainer_mod
    from cnsn_tpu_torch.config import load_config
    from cnsn_tpu_torch.models.wideresnet import WideResNet

    def small(name, num_classes, generator=None, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return WideResNet(depth=10, widen_factor=1, num_classes=num_classes,
                          generator=generator, **kw)

    trainer_mod.build_model = small
    cfg = load_config(CIFAR_AUGMIX, synthetic_data=True, batch_size=8,
                      eval_batch_size=64, epochs=500, print_freq=1,
                      augmix_workers=1, snapshot=False,
                      ckpt_backend="orbax", exp_dir=exp_dir, resume=exp_dir,
                      seed=3)
    return trainer_mod.Trainer(cfg, device="cpu")


def _child(mode, exp_dir):
    tr = _trainer(exp_dir)
    if mode == "train":
        tr.fit()  # until SIGTERM: the handler flushes and exits 143
        return
    restored = tr.ckpt.latest_step()
    payload = torch.load(os.path.join(tr.ckpt.directory, str(restored),
                                      "state.pt"), weights_only=True)
    sd = tr.state.model.state_dict()
    equal = all(torch.equal(sd[k], v) for k, v in payload["model"].items())
    state_step = tr.state.step
    images, labels = next(iter(tr.train_loader))
    tr.steps.augmix(tr.state, torch.from_numpy(images),
                    torch.from_numpy(np.asarray(labels, np.int64)))
    tr.close()
    print(json.dumps({"restored_step": restored, "state_step": state_step,
                      "start_epoch": tr.start_epoch,
                      "equal_to_files": equal,
                      "step_after_one": tr.state.step}))


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
