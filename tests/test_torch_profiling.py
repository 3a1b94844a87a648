"""Port profiling helpers (cnsn_tpu_torch.utils.profiling) that need no
card: kernel-name families and the busy-time union."""
import pytest

from cnsn_tpu_torch.utils.profiling import _union_us, kernel_family


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::selfnorm_infer_kernel<__nv_bfloat16>"
     "(...)", "selfnorm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv_gemm"),
    ("void at::native::batch_norm_transform_input_channels_last_kernel",
     "batch_norm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc",
     "pool"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduce"),
    ("nvjet_tst_256x128_64x4_1x2_h_ssched_bz_coopA_TNT", "conv_gemm"),
    ("Memset (Device)", "memcpy_memset"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_family(name, family):
    assert kernel_family(name) == family


def test_union_of_overlapping_intervals():
    assert _union_us([]) == 0
    assert _union_us([(0, 10), (5, 15), (20, 25)]) == 20
    assert _union_us([(0, 10), (2, 3)]) == 10
