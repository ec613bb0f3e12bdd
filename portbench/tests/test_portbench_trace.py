"""The kernel classifier, the idle share, the breakdown and the launch check
on a canned profiler event list."""

import json

import pytest

from portbench import trace
from portbench.trace import Event


@pytest.mark.parametrize("name, cls", [
    ("void (anonymous namespace)::walk_kernel<Int8Tiles, 128>(Args, Work, int)", "port"),
    ("void (anonymous namespace)::finish_kernel(Args, Work)", "port"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16_warpgroupsize1x1x1_execute_segment_k_off_kernel__"
     "5x_cublas", "gemm"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(Params)", "gemm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false, false>(Params)", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1> >"
     "(int, FillFunctor<float>, std::array<char*, 1>)", "aten"),
    ("void at::native::(anonymous namespace)::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true>()",
     "aten"),
    ("void at_cuda_detail::cub::DeviceScanKernel<int>()", "aten"),
])
def test_kernel_classes(name, cls):
    assert trace.kernel_class(Event(name, "kernel", 0.0, 1.0)) == cls


def test_copies_are_aten():
    assert trace.kernel_class(Event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 0.0, 1.0)) == "aten"
    assert trace.kernel_class(Event("Memset (Device)", "gpu_memset", 0.0, 1.0)) == "aten"


def canned():
    """A 100 us window of two steps: device busy 0-20 (port, overlapping
    10-20 with a GEMM), 30-40 (ATen copy), 70-90 (port); idle 20-30,
    40-70, 90-100, while the host ran aten::nonzero over 40-70."""
    ev = [
        Event(trace.WINDOW, "user_annotation", 0.0, 100.0),
        Event(trace.STEP, "user_annotation", 0.0, 50.0),
        Event(trace.STEP, "user_annotation", 50.0, 40.0),
        Event("cudaLaunchKernel", "cuda_runtime", 1.0, 1.0, 1),
        Event("cudaLaunchKernel", "cuda_runtime", 2.0, 1.0, 2),
        Event("cudaLaunchKernel", "cuda_runtime", 52.0, 1.0, 3),
        Event("aten::nonzero", "cpu_op", 38.0, 35.0),
        Event("aten::mm", "cpu_op", 0.5, 3.0),
        Event("void (anonymous namespace)::walk_kernel<X>(A)", "kernel", 0.0, 20.0, 1),
        Event("ampere_sgemm_128x64_nn", "kernel", 10.0, 10.0, 2),
        Event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 30.0, 10.0),
        Event("void (anonymous namespace)::walk_kernel<X>(A)", "kernel", 70.0, 20.0, 3),
    ]
    return ev


def test_idle_share_and_breakdown():
    s = trace.summarize(canned())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(50e-6)
    assert s.idle_share == pytest.approx(0.5)
    assert s.steps == 2
    assert s.class_s == pytest.approx({"port": 40e-6, "gemm": 10e-6, "aten": 10e-6})
    assert s.device_ops[0] == ["walk_kernel", pytest.approx(40e-6)]
    assert s.idle_gaps[0] == ["aten::nonzero", pytest.approx(30e-6)]
    assert [g[1] for g in s.idle_gaps] == pytest.approx([30e-6, 10e-6, 10e-6])


def test_launch_check():
    ev = canned()
    assert trace.step_of_kernels(ev) == [1, 1]
    assert trace.launches_agree(ev, [1, 1])
    assert not trace.launches_agree(ev, [2, 1])  # a launch the trace dropped
    assert not trace.launches_agree(ev[:-1], [1, 1])  # steps alike, kernels not


def test_chrome_trace_reader(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 5, "dur": 2, "args": {"correlation": 9}},
        {"ph": "i", "cat": "x", "name": "marker", "ts": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.5, "dur": 1},
    ]}))
    assert trace.read_chrome_trace(str(path)) == [Event("k", "kernel", 5.0, 2.0, 9),
                                                   Event("aten::add", "cpu_op", 1.5, 1.0, None)]
