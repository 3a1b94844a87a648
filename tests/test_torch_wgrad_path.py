"""K4's rule between its two kernels (``wgrad3x3_path``), on the CPU: the
rule is pure Python over dtype, channel counts and addresses, so it is
checked here at every stride-1 3x3 shape of the two training paths that
``chip_smoke.py`` drives, where the card then counts each kernel's
launches."""
import importlib.util
import os

import pytest
import torch

from cnsn_tpu_torch.ops import wgrad3x3_path

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
    hw, cin, cout, _ = shape
    want = "wgmma" if cin % 64 == 0 and cout % 64 == 0 else "wmma"
    assert wgrad3x3_path(*_pair(hw, cin, cout)) == want


def test_launches_per_step_by_kernel():
    """What chip_smoke checks on the card: every ResNet-50 site and 22 of
    WRN-40-2's 35 take the wgmma kernel."""
    def wide(shapes):
        return sum(s[3] for s in shapes
                   if wgrad3x3_path(*_pair(*s[:3])) == "wgmma")

    assert wide(_SMOKE.K4_R50) == _SMOKE.R50_K4 == 13
    assert wide(_SMOKE.K4_WRN) == _SMOKE.WRN_K4_WGMMA == 22
    assert sum(s[3] for s in _SMOKE.K4_WRN) == _SMOKE.WRN_K4 == 35


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
