"""cnsn_tpu_torch.train.rounding on the CPU, the runs other than the
three-step run's own (split from tests/test_torch_rounding.py so that the
two files balance over the test workers): a run with other BatchNorm
sums and input seeds, the tensors a reference leaves at zero, and the
segmentation aug step against its replaying float64 twin."""
import copy

import torch

from cnsn_tpu_torch.train.rounding import (SEG_MASK, compare_runs,
                                           run_augmix_step, run_seg_step,
                                           run_steps)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def test_run_with_other_sums_and_seed_puts_the_plain_version_back():
    """``sums`` takes the place of the BatchNorm sums for one run only;
    ``seed`` draws other inputs (seed 3 is the default)."""
    from cnsn_tpu_torch.ops.kernels import bn_stats
    from cnsn_tpu_torch.train.rounding import exact_bn_sums
    plain = (bn_stats.bn_sums_reference, bn_stats.bn_sums_cuda)
    calls = []

    def sums(x, m0):
        calls.append(x.shape[-1])
        return exact_bn_sums(x, m0)

    run = run_steps("cpu", torch.float32, sums=sums)
    assert (bn_stats.bn_sums_reference, bn_stats.bn_sums_cuda) == plain
    # 17 BatchNorm2d layers of layers (1, 1, 1, 1), three steps
    assert len(calls) == 3 * 17
    assert all(map(torch.isfinite, map(torch.tensor, run.losses)))
    other = run_steps("cpu", torch.float32, seed=4, sums=sums)
    assert other.losses != run.losses
    assert run_steps("cpu", torch.float32, seed=3).losses[0] == \
        run_steps("cpu", torch.float32).losses[0]


def test_compare_runs_holds_the_tensors_a_reference_leaves_at_zero():
    """IBN-b's BatchNorm biases before an InstanceNorm get a zero
    gradient, which leaves them at ~1e-18 in float64, where a relative
    error says nothing.  ``compare_runs`` holds them apart by their
    absolute error: float32 rounding alone in a ``cn_image_augmix`` step
    (measured 1.4e-9 state, 2.7e-8 momentum), and a run that moves one of
    them shows it."""
    run = run_augmix_step("cpu", torch.float32, "cn_image_augmix")
    ref = run_augmix_step("cpu", torch.float64, "cn_image_augmix",
                          replay=run.tape)
    errs = compare_runs(run, ref)
    err, name = errs["step1_state_at_zero"]
    assert name.endswith(("bn3.bias", "downsample.1.bias")), errs
    assert 0 < err <= 1e-8, errs
    assert 0 < errs["step1_momentum_at_zero"][0] <= 1e-7, errs
    assert errs["step1_state"][0] <= 1e-4, errs
    moved = copy.copy(run)
    moved.states = {1: dict(run.states[1])}
    moved.states[1][name] = run.states[1][name] + 1e-3
    assert compare_runs(moved, ref)["step1_state_at_zero"][0] > 9e-4


def test_seg_step_float32_lies_within_rounding_of_its_replaying_twin():
    """The reduced FCN-CNSN's aug step (``run_seg_step``: one CrossNorm
    site on, style box and pairing fixed, the fused class-major CE):
    float32 against the float64 twin that replays its ReLU masks and
    max-pool choices, rounding alone (measured 2.2e-8 loss, 1.8e-5 state
    and 5.9e-5 momentum), each bound ~10x that; the tape holds the stem's
    ReLU and max-pool, three ReLUs in each of 4 blocks and the two heads'
    ReLUs."""
    assert sum(SEG_MASK) == 1
    run = run_seg_step("cpu", torch.float32)
    twin = run_seg_step("cpu", torch.float64, replay=run.tape)
    errs = compare_runs(run, twin)
    assert errs["loss_rel_err"][0] <= 5e-7, errs
    assert errs["step1_state"][0] <= 2e-4, errs
    assert errs["step1_momentum"][0] <= 6e-4, errs
    assert len(run.tape) == len(twin.tape) == 2 + 3 * 4 + 2
