"""The reading of a trace: kernel classes, busy time, idle gaps, the
breakdown, and the per-layer metric readers, on made-up events."""

from __future__ import annotations

import pytest

from benchmark.cells import load_benchmark, load_metric
from benchmark.trace import HOST_ONLY, Reading, kernel_class

# names as the profiler gave them on the H100 (bf16 scoring, the fp32 training step)
NAMES = {
    "nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN": "gemm",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)": "gemm",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas": "gemm",
    "void (anonymous namespace)::mha_tc_kernel<64, (anonymous namespace)::Packed>((anonymous namespace)::Packed, int, int, int, int, float)": "attention",
    "void mha_bld_tf32_fwd_kernel<32>(Operand, Operand, Operand, float*, int, int, int, int, float)": "attention",
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8_stage3_warpsize2x2x1_g1_ffma_al": "conv",
    "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize64x64x8_stage3_warpsize2x2x1_ffma_aligna8_alignc8_e": "conv",
    "void fft2d_r2c_32x32<float, false, 1u, false>(float2*, float const*, int, int, int, int, int, int, int, int, int, cudnn::reduced_divisor, bool, int2, int, int)": "conv",
    "void at::native::vectorized_elementwise_kernel<8, at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, at::native::binary_internal::MulFunctor": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float, float, float>, unsigned int, float, 4, 4> >(at::native::Red": "elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::opera": "elementwise",
}


@pytest.mark.parametrize("name,cls", list(NAMES.items()))
def test_kernel_classes(name, cls):
    assert kernel_class(name) == cls


def reading() -> Reading:
    kernels = [("gemm_a", "gemm", 100.0, 50.0), ("elt", "elementwise", 120.0, 60.0),  # overlap: 100-180
               ("mha_tc_kernel", "attention", 300.0, 100.0), ("conv", "conv", 500.0, 200.0)]
    copies = [("Memcpy HtoD (Pageable -> Device)", 700.0, 100.0)]
    host = [("aten::copy_", 150.0, 850.0), ("cudaStreamSynchronize", 190.0, 290.0)]
    return Reading(kernels, copies, host, (0.0, 1000.0), 1e-3, {"real_frames": 10, "encoded_frames": 20, "steps": 2},
                   {"flops": 1e9, "peak_flops": 1e15, "attention_bound_s": 25e-6})


def test_busy_idle_and_breakdown():
    r = reading()
    assert r.intervals() == [(100.0, 180.0), (300.0, 400.0), (500.0, 800.0)]
    assert r.busy_s == pytest.approx(480e-6)
    gaps = r.idle_gaps()
    assert gaps[0] == [HOST_ONLY, pytest.approx(200e-6)]  # 800-1000, past the host ops
    assert ["cudaStreamSynchronize", pytest.approx(120e-6)] in gaps  # 180-300, the innermost op
    assert ["aten::copy_", pytest.approx(100e-6)] in gaps  # 400-500
    assert [HOST_ONLY, pytest.approx(100e-6)] in gaps  # 0-100, before the first kernel
    assert len(gaps) == 4
    assert r.device_ops()[0] == ["conv", pytest.approx(200e-6)]
    assert r.copy_s("HtoD") == pytest.approx(100e-6)


def test_metric_readers():
    r = reading()
    want = {"encode_ratio.score": 2.0, "elementwise_us_per_frame.score": 3.0, "attn_roofline_pct.score": 25.0,
            "mfu_pct.score": 100.0 * 1e9 / 1e-3 / 1e15, "device_idle_pct.score": 52.0,
            "h2d_ms_per_step.train": 0.05, "conv_ms_per_step.train": 0.1, "attn_roofline_pct.train": 25.0,
            "mfu_pct.train": 100.0 * 1e9 / 1e-3 / 1e15, "device_idle_pct.train": 52.0}
    names = [m["name"] for m in load_benchmark()["per_layer"]]
    assert sorted(names) == sorted(want)
    for name in names:
        assert load_metric(name)(r) == pytest.approx(want[name]), name


def test_readers_that_find_nothing_return_nothing():
    empty = Reading([], [], [], (0.0, 1000.0), 1e-3)
    for m in load_benchmark()["per_layer"]:
        assert load_metric(m["name"])(empty) is None, m["name"]
