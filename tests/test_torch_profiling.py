"""Port profiling helpers (cnsn_tpu_torch.utils.profiling) that need no
card: kernel-name families, the busy-time union, and a profile without a
window marker."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cnsn_tpu_torch.utils import profiling
from cnsn_tpu_torch.utils.profiling import _union_us, kernel_family
from test_torch_threads import one_thread  # noqa: F401 (autouse)


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
    ("void (anonymous namespace)::ins_bwd_kernel<float, 4>(...)",
     "ins_stats_bwd"),
    ("void (anonymous namespace)::ins_bwd_stream_kernel<__nv_bfloat16, 8>("
     "__nv_bfloat16 const*, float const*, float const*, float const*, "
     "float const*, __nv_bfloat16*, int, int, int, int, float)",
     "ins_stats_bwd"),
    ("void (anonymous namespace)::ins_bwd_stream_kernel<float, 1>(...)",
     "ins_stats_bwd"),
    ("void (anonymous namespace)::bn_sums_kernel<__nv_bfloat16, 8>(...)",
     "bn_stats"),
    ("(anonymous namespace)::bn_finalize_kernel(...)", "bn_stats"),
    ("void (anonymous namespace)::ins_stats_cluster_kernel<__nv_bfloat16, 8>"
     "(__nv_bfloat16 const*, float*, float*, int, int, int, int, float, "
     "float)", "ins_stats"),
    ("void (anonymous namespace)::ins_stats_cluster_kernel<__nv_bfloat16, 1>"
     "(...)", "ins_stats"),
    ("void (anonymous namespace)::ins_stats_cluster_kernel<float, 4>(...)",
     "ins_stats"),
    ("void (anonymous namespace)::ins_stats_cluster_kernel<float, 1>(...)",
     "ins_stats"),
    ("void (anonymous namespace)::bn_bwd_stream_kernel<__nv_bfloat16, 8>("
     "__nv_bfloat16 const*, float const*, float const*, float const*, "
     "__nv_bfloat16*, int, int, int, int)", "bn_stats_bwd"),
    ("void (anonymous namespace)::bn_bwd_stream_kernel<__nv_bfloat16, 1>"
     "(...)", "bn_stats_bwd"),
    ("void (anonymous namespace)::bn_bwd_stream_kernel<float, 4>(...)",
     "bn_stats_bwd"),
    ("void (anonymous namespace)::bn_bwd_stream_kernel<float, 1>(...)",
     "bn_stats_bwd"),
    ("void (anonymous namespace)::bn_sums_persistent_kernel<__nv_bfloat16, "
     "8>(__nv_bfloat16 const*, float const*, double*, unsigned int*, float*,"
     " float*, int, int, int, int)", "bn_stats"),
    ("void (anonymous namespace)::bn_sums_persistent_kernel<float, 1>(...)",
     "bn_stats"),
    ("void (anonymous namespace)::selfnorm_staged_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, float const*, float const*, float const*, "
     "__nv_bfloat16*, int, int, int, int, float, float)", "selfnorm"),
    ("void cudnn::bn_bw_1C11_kernel_new<float, float>(...)", "batch_norm"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv_gemm"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>",
     "optimizer"),
    ("void (anonymous namespace)::wgrad3x3_kernel<__nv_bfloat16, 8>(...)",
     "conv_wgrad3x3"),
    ("(anonymous namespace)::wgrad3x3_finalize_kernel(...)", "conv_wgrad3x3"),
    ("void (anonymous namespace)::wgrad3x3_wgmma_kernel<128>(CUtensorMap_st,"
     " CUtensorMap_st, float*, (anonymous namespace)::WgPlan)",
     "conv_wgrad3x3"),
    ("void (anonymous namespace)::wgrad3x3_narrow_kernel<2, 4>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, float*, "
     "(anonymous namespace)::NaPlan)", "conv_wgrad3x3"),
    ("(anonymous namespace)::wgrad3x3_narrow_sum_kernel(float const*, "
     "float*, int, int)", "conv_wgrad3x3"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv_gemm"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_family(name, family):
    assert kernel_family(name) == family


def test_union_of_overlapping_intervals():
    assert _union_us([]) == 0
    assert _union_us([(0, 10), (5, 15), (20, 25)]) == 20
    assert _union_us([(0, 10), (2, 3)]) == 10


def test_window_kernels_raise_without_a_marker():
    """A profile that holds none of ``window``'s markers (here: no card
    activity at all) has no window to count."""
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x.add_(1)
    with pytest.raises(RuntimeError, match="no window marker"):
        profiling.window_kernels(prof)
