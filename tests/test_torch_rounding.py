"""cnsn_tpu_torch.train.rounding on the CPU: a float64 run that replays a
run's ReLU masks and max-pool choices, and the step-1 trace comparison
that locates where two runs part."""
import copy

import pytest
import torch

from cnsn_tpu_torch.train.rounding import (WITNESSES, compare_runs,
                                           compare_traces, run_steps,
                                           seed_bounds)


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


def test_exact_bn_sums_are_the_float64_sums_rounded_once():
    """The exactly rounded K2 sums: float32 differences and rounded
    squares, added in float64, rounded once."""
    from cnsn_tpu_torch.train.rounding import exact_bn_sums
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 5, 7, 6, generator=gen) * 3 + 1
    m0 = torch.randn(6, generator=gen)
    d = (x - m0).double()
    s1, s2 = exact_bn_sums(x, m0)
    assert s1.dtype == s2.dtype == torch.float32
    assert torch.equal(s1, d.sum(dim=(0, 1, 2)).float())
    assert torch.equal(s2, (x - m0).square().double().sum(dim=(0, 1, 2))
                       .float())


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


def _spread_row(card, cpu, torch_sums, exact):
    """A made-up ``seed_spread`` row: per run, three losses and one
    (error, tensor name) per step and part, as ``compare_runs`` gives
    them after a JSON round trip."""
    def run(loss, state):
        return {"loss_rel_err": loss,
                **{f"step{k}_{part}": [state * k, f"layer1.{part}"]
                   for k in (1, 3) for part in ("state", "momentum")}}
    return {"seed": 2, "card": run(*card), "cpu": run(*cpu),
            "card_torch_sums": run(*torch_sums),
            "card_exact_bn_sums": run(*exact)}


def test_seed_bounds_take_the_largest_witness_at_each_quantity():
    """Each quantity's bound is 8x its largest witness (the CPU's loss of
    step 1, torch's sums' loss of step 2, the exact sums' loss of step 3
    and their state errors), floored at 8 x 1e-6."""
    row = _spread_row(card=([1e-7, 3e-5, 5e-5], 2e-3),
                      cpu=([2e-7, 1e-6, 1e-6], 1e-4),
                      torch_sums=([1e-8, 5e-6, 1e-6], 2e-4),
                      exact=([1e-8, 1e-6, 7e-6], 3e-4))
    assert set(WITNESSES) <= set(row)
    got = {q: (e, b) for q, e, b in seed_bounds(row, 8, 1e-6)}
    assert set(got) == {"loss_rel_err[0]", "loss_rel_err[1]",
                        "loss_rel_err[2]", "step1_state", "step1_momentum",
                        "step3_state", "step3_momentum"}
    want = {"loss_rel_err[0]": (1e-7, 8 * 1e-6),
            "loss_rel_err[1]": (3e-5, 8 * 5e-6),
            "loss_rel_err[2]": (5e-5, 8 * 7e-6),
            "step1_state": (2e-3, 8 * 3e-4),
            "step3_momentum": (6e-3, 8 * 9e-4)}
    for q, (e, b) in want.items():
        assert got[q] == pytest.approx((e, b), rel=1e-12), q
    assert all(e <= b for e, b in got.values())


@pytest.mark.parametrize("card,over", [
    (([1e-7, 3e-5, 6e-5], 2e-3), {"loss_rel_err[2]"}),
    (([1e-7, 3e-5, 5e-5], 3e-3), {"step1_state", "step1_momentum",
                                  "step3_state", "step3_momentum"}),
    (([float("nan"), 3e-5, 5e-5], 2e-3), {"loss_rel_err[0]"}),
])
def test_seed_bounds_name_what_lies_beyond(card, over):
    """A card error above its bound, or NaN, is beyond it."""
    row = _spread_row(card=card, cpu=([2e-7, 1e-6, 1e-6], 1e-4),
                      torch_sums=([1e-8, 5e-6, 1e-6], 2e-4),
                      exact=([1e-8, 1e-6, 7e-6], 3e-4))
    assert {q for q, e, b in seed_bounds(row, 8, 1e-6)
            if not e <= b} == over
