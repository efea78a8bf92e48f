"""The trace reduction on a synthetic Chrome trace, and the kernel classes
against kernel names as the profiler gives them on the card."""
import fnmatch
import time

import pytest

from perfbench import harness
from perfbench.trace import Trace

CONV = ["void dram::(anonymous namespace)::conv3x3x3_mma_kernel<64, true, "
        "true, false>(dram::(anonymous namespace)::ConvArgs)",
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
        "tilesize256x128x64_warpgroupsize2x1x1_g1_execute_segment_k_off_"
        "kernel__5x_cudnn",
        "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc"
        "_nhwc_tilesize64x128x64_warpgroupsize1x1x1_g1_execute_kernel__5x_"
        "cudnn",
        "void dram::(anonymous namespace)::stem_mma_kernel(dram::(anonymous "
        "namespace)::StemArgs)",
        "void dram::(anonymous namespace)::stem_f32_kernel(dram::(anonymous "
        "namespace)::StemArgs)",
        "void dram::(anonymous namespace)::wgrad_mma_kernel(dram::(anonymous "
        "namespace)::WgradArgs)",
        "void dram::(anonymous namespace)::sum_partials_kernel(float const*, "
        "float*, int, int)"]
OTHER = ["void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
         "impl_nocast<at::native::direct_copy_kernel_cuda>",
         "void dram::(anonymous namespace)::max_pool3d_kernel<__nv_bfloat16>",
         "void dram::(anonymous namespace)::masked_sums_vec<__nv_bfloat16>("
         "dram::(anonymous namespace)::SumArgs<__nv_bfloat16>)",
         "Memcpy HtoD (Pinned -> Device)"]


def _match(name, cls):
    return any(fnmatch.fnmatchcase(name, p)
               for p in harness.kernel_patterns(cls))


def test_kernel_classes():
    assert all(_match(n, "conv") for n in CONV)
    assert not any(_match(n, "conv") for n in OTHER)
    assert _match("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl")
    assert not any(_match(n, "nccl") for n in CONV + OTHER)


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_idle_and_classes():
    events = [_ev("perfbench.window", "user_annotation", 1000.0, 1000.0),
              _ev("loader", "user_annotation", 1000.0, 500.0),
              _ev(CONV[0], "kernel", 900.0, 200.0),        # clipped to 100
              _ev(CONV[1], "kernel", 1050.0, 100.0),       # overlaps
              _ev(OTHER[0], "kernel", 1600.0, 100.0),
              _ev(OTHER[2], "gpu_memcpy", 1900.0, 200.0)]  # clipped to 100
    tr = Trace(events)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(350e-6)
    assert tr.class_seconds(harness.kernel_patterns("conv")) == \
        pytest.approx(200e-6)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["loader", pytest.approx(450e-6)]
    assert gaps[1] == ["host, no torch op open", pytest.approx(200e-6)]
    top = dict(tr.top_ops())
    assert top[CONV[1]] == pytest.approx(100e-6)


def test_no_window_span():
    with pytest.raises(ValueError):
        Trace([_ev(CONV[0], "kernel", 0.0, 1.0)])


def test_trainer_reads_its_trace_after_the_window(tmp_path):
    """A traced tiny trainer run reports its cell's per-layer metrics with
    the device's busy and window seconds, and exports and reads the
    profiler's trace only once the window has closed."""
    from perfbench.tests import tiny

    seen = {}

    def hook(driver):
        marks, read = driver.Marks, driver.from_profiler

        class Kept(marks):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                seen["marks"] = self

        def from_profiler(*a, **k):
            seen["read_at"] = time.perf_counter()
            return read(*a, **k)

        driver.Marks, driver.from_profiler = Kept, from_profiler

    res = tiny.run(tmp_path, "train.tiny", trace=True, seconds=2.0,
                   driver_hook=hook)
    assert res["correct"], res["checks"]
    # no convolution kernel runs on a device in a CPU run
    assert set(res["metrics"]) == {m["name"] for m in tiny.TRAIN_LAYER} - {
        "conv_roofline.train"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert seen["read_at"] > seen["marks"].t_stop
