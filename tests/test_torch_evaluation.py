"""The port's evaluation (cnsn_tpu_torch.evaluation.classify with
``StepFns.eval_sum``) against the JAX package's on the CPU: a reduced
WRN + CNSN on the same weights over a loader whose last batch is short
(JAX pads it with label −1 rows and masks them; the port runs it at its
own size), CIFAR-C over two fake corruptions, and the mCE arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnsn_tpu.data import cifar as jax_cifar
from cnsn_tpu.evaluation import classify as jax_classify
from cnsn_tpu.models.wideresnet import WideResNet as JaxWideResNet
from cnsn_tpu.train.steps import StepFns as JaxStepFns
from cnsn_tpu.train.steps import create_train_state as jax_train_state
from cnsn_tpu.train.steps import make_sgd
from cnsn_tpu_torch.data import cifar
from cnsn_tpu_torch.evaluation import classify
from cnsn_tpu_torch.models.wideresnet import WideResNet
from cnsn_tpu_torch.train import StepFns, create_train_state
from cnsn_tpu_torch.utils.jax_params import state_dict_from_jax
from test_torch_wideresnet import _perturb
from test_torch_threads import one_thread  # noqa: F401 (autouse)


KW = dict(depth=10, widen_factor=2, num_classes=10, pos="post",
          cnsn_type="cnsn", crop="both")
N, BATCH = 100, 32  # 3 full batches and a short one of 4


@pytest.fixture(scope="module")
def twins():
    """JAX and port train states on the same weights (random BN affine
    and running statistics), and each package's eval_sum."""
    rng = np.random.RandomState(0)
    jm = JaxWideResNet(**KW)
    state = jax_train_state(jm, jax.random.key(0), (2, 32, 32, 3),
                            make_sgd(lambda s: 0.1))
    params = _perturb(dict(state.params), rng, stats=False)
    stats = _perturb(dict(state.batch_stats), rng, stats=True)
    state = state.replace(params=params, batch_stats=stats)
    tm = WideResNet(**KW)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    ts = create_train_state(tm, lambda s: 0.1, device="cpu")
    return state, JaxStepFns(jm).eval_sum, ts, StepFns().eval_sum


def _data(module, n=N):
    return module.load_cifar("", "cifar10", False, synthetic=True,
                             synthetic_size=n)


def test_evaluate_matches_jax_with_a_short_last_batch(twins):
    jstate, jstep, state, step = twins
    want = jax_classify.evaluate(jstep, jstate, jax_cifar.CifarLoader(
        _data(jax_cifar), BATCH, mode="eval"))
    loader = cifar.CifarLoader(_data(cifar), BATCH, mode="eval")
    assert [len(lb) for _, lb in loader] == [32, 32, 32, 4]
    got = classify.evaluate(step, state, loader)
    assert got[1] == want[1]
    # the total of per-batch mean losses over N, float32 on both sides
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert not state.model.training


def test_eval_sum_masks_padding_rows_as_jax_does(twins):
    """A batch padded with label −1 rows gives the unpadded batch's sums,
    and JAX's eval_sum of the same padded batch."""
    jstate, jstep, state, step = twins
    rng = np.random.RandomState(4)
    images = rng.randn(6, 32, 32, 3).astype(np.float32)
    labels = np.array([3, 1, 4, -1, -1, 9])
    keep = labels >= 0
    want = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
    got = step(state, torch.from_numpy(images), torch.from_numpy(labels))
    kept = step(state, torch.from_numpy(images[keep]),
                torch.from_numpy(labels[keep]))
    assert "logits" not in got and int(got["n"]) == int(want["n"]) == 4
    assert int(got["correct"]) == int(want["correct"]) == int(kept["correct"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got["loss"]), float(kept["loss"]),
                               rtol=1e-6)


def test_eval_sum_takes_the_loss_of_bf16_logits_in_fp32():
    """bf16 logits are cast to fp32 before the log-softmax (JAX's
    ``steps.py:311``): the loss equals the float64 cross-entropy of the
    fp32-cast logits to fp32 rounding, not to bf16's."""
    class Logits(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))

        def forward(self, x):
            return x.to(torch.bfloat16)

    logits = torch.from_numpy(
        np.random.RandomState(5).randn(16, 10).astype(np.float32) * 4)
    labels = torch.from_numpy(np.random.RandomState(6).randint(0, 10, 16))
    state = create_train_state(Logits(), lambda s: 0.1, device="cpu")
    got = StepFns().eval_sum(state, logits, labels)
    ref = logits.to(torch.bfloat16).double()
    want = -torch.log_softmax(ref, -1)[torch.arange(16), labels].mean()
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(got["loss"]), float(want), rtol=1e-6)
    assert int(got["correct"]) == int((ref.argmax(-1) == labels).sum())


def test_evaluate_cifar_c_matches_jax(twins, tmp_path, capsys):
    jstate, jstep, state, step = twins
    rng = np.random.RandomState(7)
    np.save(tmp_path / "labels.npy", rng.randint(0, 10, 40))
    names = cifar.CORRUPTIONS[:2]
    for c in names:
        np.save(tmp_path / f"{c}.npy",
                rng.randint(0, 256, (40, 32, 32, 3), np.uint8))
    want = jax_classify.evaluate_cifar_c(jstep, jstate, str(tmp_path), 10,
                                         batch_size=25, corruptions=names)
    jax_out = capsys.readouterr().out
    got = classify.evaluate_cifar_c(step, state, str(tmp_path), 10,
                                    batch_size=25, corruptions=names)
    out = capsys.readouterr().out
    assert got[1] == want[1] and got[0] == want[0]
    # the same lines, each Test Error equal
    assert ([ln.split("Test Error")[1] for ln in out.splitlines()
             if "Test Error" in ln]
            == [ln.split("Test Error")[1] for ln in jax_out.splitlines()
                if "Test Error" in ln])


def test_compute_mce_matches_jax():
    rng = np.random.RandomState(8)
    accs = {c: rng.uniform(0.2, 0.9, 5).tolist() for c in classify.CORRUPTIONS}
    got, got_ce = classify.compute_mce(accs)
    want, want_ce = jax_classify.compute_mce(accs)
    assert classify.ALEXNET_ERR == jax_classify.ALEXNET_ERR
    assert classify.CORRUPTIONS == jax_classify.CORRUPTIONS
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for c in classify.CORRUPTIONS:
        np.testing.assert_allclose(got_ce[c], want_ce[c], rtol=1e-12)


def test_evaluate_of_an_empty_loader():
    state = create_train_state(WideResNet(**KW), lambda s: 0.1, device="cpu")
    assert classify.evaluate(StepFns().eval_sum, state, []) == (0.0, 0.0)
