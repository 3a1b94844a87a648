"""K4's rule between its three kernels (``wgrad3x3_path``), on the CPU: the
rule is pure Python over dtype, channel counts and addresses, so it is
checked here at every stride-1 3x3 shape of the two training paths that
``chip_smoke.py`` drives, where the card then counts each kernel's
launches."""
import importlib.util
import os

import pytest
import torch

from cnsn_tpu_torch.ops import wgrad3x3_path
from test_torch_threads import one_thread  # noqa: F401 (autouse)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _chip_smoke()
# (H = W, Cin, Cout, sites per step) of every stride-1 3x3 conv at b=128
K4_CASES = ([("wrn", s) for s in _SMOKE.K4_WRN]
            + [("resnet50", s) for s in _SMOKE.K4_R50])


def _pair(hw, cin, cout, dtype=torch.bfloat16):
    return (torch.zeros(2, hw, hw, cin, dtype=dtype),
            torch.zeros(2, hw, hw, cout, dtype=dtype))


@pytest.mark.parametrize("model,shape", K4_CASES)
def test_bf16_shapes_of_the_training_paths(model, shape):
    """Every wide site takes the wgmma kernel; WRN-40-2's three narrow
    shapes (3→16, 16→32, 32→32 at 32²) take the narrow kernel."""
    hw, cin, cout, _ = shape
    if cin % 64 == 0 and cout % 64 == 0:
        want = "wgmma"
    else:
        assert (hw, cin, cout) in ((32, 3, 16), (32, 16, 32), (32, 32, 32))
        want = "narrow"
    assert wgrad3x3_path(*_pair(hw, cin, cout)) == want


def test_launches_per_step_by_kernel():
    """What chip_smoke checks on the card: every ResNet-50 site and 22 of
    WRN-40-2's 35 take the wgmma kernel, WRN's other 13 the narrow
    kernel, and none the wmma kernel."""
    def sites(shapes, path):
        return sum(s[3] for s in shapes
                   if wgrad3x3_path(*_pair(*s[:3])) == path)

    assert sites(_SMOKE.K4_R50, "wgmma") == _SMOKE.R50_K4 == 13
    assert sites(_SMOKE.K4_R50, "narrow") == sites(_SMOKE.K4_R50, "wmma") == 0
    assert sites(_SMOKE.K4_WRN, "wgmma") == _SMOKE.WRN_K4_WGMMA == 22
    assert sites(_SMOKE.K4_WRN, "narrow") == _SMOKE.WRN_K4_NARROW == 13
    assert sites(_SMOKE.K4_WRN, "wmma") == 0
    assert sum(s[3] for s in _SMOKE.K4_WRN) == _SMOKE.WRN_K4 == 35


@pytest.mark.parametrize("cin,cout,want", [
    (1, 16, "narrow"), (3, 16, "narrow"), (32, 16, "narrow"),
    (16, 1, "narrow"), (16, 8, "narrow"), (16, 32, "narrow"),
    (32, 32, "narrow"), (5, 7, "narrow"),
    (33, 32, "wmma"), (32, 33, "wmma"), (33, 33, "wmma"),
    (16, 64, "wmma"), (64, 16, "wmma"), (64, 64, "wgmma")])
def test_narrow_domain_by_channels(cin, cout, want):
    """bf16 with 1 ≤ Cin, Cout ≤ 32 takes the narrow kernel; one side
    past 32 goes to wmma, both multiples of 64 to wgmma."""
    assert wgrad3x3_path(*_pair(4, cin, cout)) == want


@pytest.mark.parametrize("w,want", [(1, "narrow"), (32, "narrow"),
                                    (128, "narrow"), (129, "wmma")])
def test_narrow_domain_by_width(w, want):
    """The narrow kernel stages a band of whole image rows: W ≤ 128,
    where three stages of one row at 32 channels fit in shared memory."""
    x = torch.zeros(1, 2, w, 32, dtype=torch.bfloat16)
    dy = torch.zeros(1, 2, w, 32, dtype=torch.bfloat16)
    assert wgrad3x3_path(x, dy) == want


@pytest.mark.parametrize("operand", ["x", "dy", "fp32"])
def test_narrow_needs_aligned_bf16(operand):
    """The narrow kernel's 16-byte copies start at each tensor's base:
    an unaligned view, like fp32, takes the wmma kernel."""
    x, dy = _pair(32, 32, 32)
    assert wgrad3x3_path(x, dy) == "narrow"
    if operand == "fp32":
        x, dy = x.float(), dy.float()
    else:
        base = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
        view = base[1:].view(x.shape)
        assert view.data_ptr() % 16 != 0
        if operand == "x":
            x = view
        else:
            dy = view
    assert wgrad3x3_path(x, dy) == "wmma"


@pytest.mark.parametrize("model,shape", K4_CASES)
def test_fp32_takes_the_wmma_kernel(model, shape):
    hw, cin, cout, _ = shape
    assert wgrad3x3_path(*_pair(hw, cin, cout, torch.float32)) == "wmma"


@pytest.mark.parametrize("operand", ["x", "dy"])
def test_an_unaligned_view_takes_the_wmma_kernel(operand):
    x, dy = _pair(7, 64, 64)
    assert wgrad3x3_path(x, dy) == "wgmma"
    base = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    view = base[1:].view(x.shape)
    assert view.data_ptr() % 16 != 0
    if operand == "x":
        x = view
    else:
        dy = view
    assert wgrad3x3_path(x, dy) == "wmma"


@pytest.mark.parametrize("cin,cout", [(64, 96), (96, 64), (32, 64),
                                      (64, 32), (128, 192), (192, 128)])
def test_channels_must_both_be_multiples_of_64(cin, cout):
    want = "wgmma" if cin % 64 == 0 and cout % 64 == 0 else "wmma"
    assert wgrad3x3_path(*_pair(4, cin, cout)) == want


def test_sweep_refuses_to_run_without_a_card(monkeypatch, capsys):
    """The chunk sweep times the card's kernels and nothing else: without
    a GPU it exits non-zero and prints no result."""
    from cnsn_tpu_torch.utils import k4_sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k4_sweep.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err
