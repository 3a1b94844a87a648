"""Port profiling helpers (cnsn_tpu_torch.utils.profiling) that need no
card: kernel-name families, the busy-time union, a profile without a
window marker, and ``window_kernels``' matching of the card's records to
the host's calls by correlation id, on hand-made records."""
import types

import pytest
import torch
from torch.autograd import DeviceType
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


def _record(corr, name, device, start=0):
    kind = DeviceType.CUDA if device else DeviceType.CPU
    return types.SimpleNamespace(
        correlation_id=lambda: corr, name=lambda: name,
        device_type=lambda: kind, start_ns=lambda: start * 1000,
        end_ns=lambda: start * 1000 + 500)


def _profile(records):
    result = types.SimpleNamespace(events=lambda: records)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=result))


def _window(lose=(), marker_records=range(8)):
    """The records of a window: 8 marker launches (ids 10-17), then two
    kernel launches, a copy and a host call that puts nothing on the card
    (ids 20-23), and the card's records of each (the markers' in
    ``marker_records``, none of the ids in ``lose``), beside the
    profiler's step annotation on the card (id 5)."""
    host = [_record(10 + i, "cudaLaunchKernel", False) for i in range(8)]
    host += [_record(20, "cudaLaunchKernelExC", False),
             _record(21, "cuLaunchKernel", False),
             _record(22, "cudaMemcpyAsync", False),
             _record(23, "cudaStreamSynchronize", False)]
    card = [_record(10 + i, "spin_kernel", True, i) for i in marker_records]
    card += [_record(c, name, True, 50 - c)
             for c, name in ((20, "bn_sums_persistent_kernel<float, 4>"),
                             (21, "vectorized_elementwise_kernel"),
                             (22, "Memcpy HtoD (Pageable -> Device)"))
             if c not in lose]
    return _profile(host + card + [_record(5, "ProfilerStep#1", True)])


def test_window_kernels_match_the_blocks_calls():
    got = profiling.window_kernels(_window(marker_records=range(2, 8)))
    assert [k.name for k in got] == [
        "Memcpy HtoD (Pageable -> Device)", "vectorized_elementwise_kernel",
        "bn_sums_persistent_kernel<float, 4>"]  # by start on the card


@pytest.mark.parametrize("lose", [(20,), (21,)])
def test_window_kernels_raise_on_a_lost_launch(lose):
    with pytest.raises(profiling.LostRecords, match="lost the card's record"):
        profiling.window_kernels(_window(lose=lose))


def test_window_kernels_raise_where_the_markers_do_not_open_it():
    prof = _window()
    records = prof.profiler.kineto_results.events()
    records.insert(0, _record(9, "cudaLaunchKernel", False))
    with pytest.raises(profiling.LostRecords, match="no window marker"):
        profiling.window_kernels(prof)


def test_window_kernels_read_the_window_on_the_host():
    """The card lost its records of every marker (as it does of a
    profile's first records): the host's launches still open the window,
    and its kernels are counted."""
    got = profiling.window_kernels(_window(marker_records=()))
    assert len(got) == 3
