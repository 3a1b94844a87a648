"""K3's rule between its two kernels (``selfnorm_path``), on the CPU: it
is pure Python over dtypes, channel counts and addresses, so it is checked
here at every SelfNorm shape of ResNet-50 (serving, pos='post') and
WRN-40-2 (pos='pre').  On the card the rule also asks the staged kernel's
plan (``csrc/selfnorm.cu::staged_plan``) whether the planes fit a cluster;
that plan, and the launches of each kernel, are checked by the card tests
(``tests/test_torch_kernels_cuda.py``)."""
import pytest
import torch

from cnsn_tpu_torch.ops import selfnorm_path
from test_torch_threads import one_thread  # noqa: F401 (autouse)


# (H = W, C, sites) of the SelfNorm sites: ResNet-50 at 224² (16) and
# WRN-40-2 at 32² (18: the first block of each group sizes its SelfNorm to
# the group's input channels)
R50 = ((56, 256, 3), (28, 512, 4), (14, 1024, 6), (7, 2048, 3))
WRN = ((32, 16, 1), (32, 32, 6), (16, 64, 6), (8, 128, 5))
SHAPES = [("resnet50", s) for s in R50] + [("wrn", s) for s in WRN]
DTYPES = (torch.float32, torch.bfloat16)


def test_site_counts():
    assert sum(s[2] for s in R50) == 16 and sum(s[2] for s in WRN) == 18


@pytest.mark.parametrize("model,shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_path_of_the_model_shapes_is_staged(model, shape, dtype):
    side, c, _ = shape
    x = torch.zeros(2, side, side, c, dtype=dtype)
    assert selfnorm_path(x) == "staged"
    nchw = torch.zeros(2, c, side, side, dtype=dtype).to(
        memory_format=torch.channels_last)
    assert selfnorm_path(nchw.permute(0, 2, 3, 1)) == "staged"


@pytest.mark.parametrize("dtype,c,want", [
    (torch.bfloat16, 12, "v1"), (torch.bfloat16, 8, "staged"),
    (torch.bfloat16, 24, "staged"), (torch.bfloat16, 3, "v1"),
    (torch.float32, 6, "v1"), (torch.float32, 4, "staged"),
    (torch.float32, 12, "staged"), (torch.float16, 64, "v1"),
    (torch.float64, 64, "v1")])
def test_path_by_dtype_and_channels(dtype, c, want):
    """A 16-byte vector must divide C (8 bf16, 4 fp32); other dtypes have
    no kernel and are refused by the wrapper, the rule says v1."""
    assert selfnorm_path(torch.zeros(2, 5, 5, c, dtype=dtype)) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_path_of_an_unaligned_or_strided_view_is_v1(dtype):
    base = torch.zeros(2 * 5 * 5 * 16 + 8, dtype=dtype)
    off = 1 if base.data_ptr() % 16 == 0 else 2
    x = base[off:off + 2 * 5 * 5 * 16].view(2, 5, 5, 16)
    assert x.data_ptr() % 16 != 0 and selfnorm_path(x) == "v1"
    assert selfnorm_path(torch.zeros(2, 5, 5, 16, dtype=dtype)
                         .permute(0, 2, 1, 3)) == "v1"


def test_stats_sweep_refuses_without_a_gpu():
    from cnsn_tpu_torch.utils import stats_sweep
    if torch.cuda.is_available():
        pytest.skip("has a GPU: the sweep would run")
    assert stats_sweep.main([]) == 1


def test_bn_shapes_of_resnet50():
    """The 12 BatchNorm2d input shapes over 53 layers that chip_smoke and
    the sweep time K2 at."""
    from cnsn_tpu_torch.utils.stats_sweep import bn_shapes
    shapes = bn_shapes(224)
    assert len(shapes) == 12 and sum(shapes.values()) == 53
    assert shapes[(112, 64)] == 1 and shapes[(14, 256)] == 11
