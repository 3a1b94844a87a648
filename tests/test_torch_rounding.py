"""cnsn_tpu_torch.train.rounding on the CPU: a float64 run that replays a
run's ReLU masks and max-pool choices, and the step-1 trace comparison
that locates where two runs part."""
import copy

import pytest
import torch

from cnsn_tpu_torch.train.rounding import (compare_runs, compare_traces,
                                           run_steps)


@pytest.fixture(scope="module")
def f64_run():
    return run_steps("cpu", torch.float64, trace=True)


def test_replaying_its_own_tape_reproduces_a_run(f64_run):
    """Masks and max-pool choices replayed in the same type give the same
    losses and states (a replayed max-pool sums the gradients of shared
    elements in another order, so equal to rounding, not bit for bit, and
    the steps amplify it: measured 1.1e-14 after step 1, 1.9e-12 after
    step 3)."""
    twin = run_steps("cpu", torch.float64, replay=f64_run.tape)
    errs = compare_runs(twin, f64_run)
    assert max(errs["loss_rel_err"]) <= 1e-14, errs
    bounds = {"step1_state": 1e-12, "step1_momentum": 1e-12,
              "step3_state": 1e-10, "step3_momentum": 1e-10}
    assert all(errs[k][0] <= b for k, b in bounds.items()), errs
    # per step: the stem's ReLU and max-pool, three ReLUs in each of 4 blocks
    assert len(twin.tape) == len(f64_run.tape) == 3 * (2 + 3 * 4)


def test_float32_run_lies_within_rounding_of_its_replaying_twin():
    """With the masks shared, float32 differs from float64 by rounding
    alone: measured 4.8e-6 (losses), 3.5e-5 / 9.2e-5 (step-1 state /
    momentum) and 1.4e-3 / 8.6e-3 (step 3), each bound ~10x that."""
    run = run_steps("cpu", torch.float32)
    errs = compare_runs(run, run_steps("cpu", torch.float64,
                                       replay=run.tape))
    assert max(errs["loss_rel_err"]) <= 5e-5, errs
    bounds = {"step1_state": 5e-4, "step1_momentum": 1e-3,
              "step3_state": 2e-2, "step3_momentum": 1e-1}
    assert all(errs[k][0] <= b for k, b in bounds.items()), errs


def test_compare_traces_counts_sign_flips(f64_run):
    """Against itself: no error, no flip.  One ReLU input negated: one
    flip there, and its gradient error counted only where signs agree."""
    rows = {r["module"]: r for r in compare_traces(f64_run, f64_run)}
    assert set(rows) >= {"bn1", "layer2.0.bn1", "layer2.0.bn2",
                         "layer2.0.cnsn", "fc"}
    assert all(r["fwd_err"] == 0 and r.get("grad_err", 0) == 0
               for r in rows.values())
    assert sum(r.get("sign_flips", 0) for r in rows.values()) == 0
    other = copy.copy(f64_run)
    other.trace = dict(f64_run.trace)
    out, grad = f64_run.trace["layer2.0.cnsn"]
    out, grad = out.flatten().clone(), grad.flatten().clone()
    i = int(out.abs().argmax())
    out[i] = -out[i]
    grad[i] += 1.0
    shape = f64_run.trace["layer2.0.cnsn"][0].shape
    other.trace["layer2.0.cnsn"] = [out.reshape(shape), grad.reshape(shape)]
    row = {r["module"]: r for r in compare_traces(other, f64_run)}[
        "layer2.0.cnsn"]
    assert row["sign_flips"] == 1
    assert row["grad_err"] > 0 and row["grad_err_where_signs_agree"] == 0
