"""Program spans on a canned profiler event list: kernels placed in the span
that holds their launch call, idle gaps in the span open at their start,
and the readings with and without their spans."""

import pytest

from portbench import spans, trace
from portbench.trace import Event
from gnn_computing_tpu_torch.utils.profiling import Span

from test_portbench_trace import canned


def annotated():
    """test_portbench_trace's window, with the program's spans: step 1 is
    gnn.step 0-50 holding gnn.backward 0-25, whose residual gnn.agg_t.residual
    (1.5-2.5) ran on autograd's thread and launched the GEMM (call at 2);
    gnn.sync 38-45 holds the start of the 40-70 gap; step 2 is gnn.step
    50-90 holding gnn.optimizer 51-60 (the walk kernel's call at 52)."""
    return canned() + [
        Event("gnn.step", "user_annotation", 0.0, 50.0),
        Event("gnn.backward", "user_annotation", 0.0, 25.0),
        Event("gnn.agg_t.residual", "user_annotation", 1.5, 1.0),
        Event("gnn.sync", "user_annotation", 38.0, 7.0),
        Event("gnn.step", "user_annotation", 50.0, 40.0),
        Event("gnn.optimizer", "user_annotation", 51.0, 9.0),
    ]


def test_kernels_go_to_the_spans_holding_their_launch_call():
    s = spans.by_span(annotated())
    assert s.steps == 2
    assert s.device_s == pytest.approx({
        "gnn.step": 50e-6,  # walk 20 + GEMM 10 (step 1), walk 20 (step 2); the copy has no launch call
        "gnn.backward": 30e-6,
        "gnn.agg_t.residual": 10e-6,  # the GEMM alone: its call at 2, on another thread
        "gnn.sync": 0.0,
        "gnn.optimizer": 20e-6,
    })


def test_gaps_go_to_the_spans_open_at_their_start():
    s = spans.by_span(annotated())
    # gaps 20-30 (in gnn.backward's step 1), 40-70 (starts in gnn.sync), 90-100 (outside)
    assert s.idle_s == pytest.approx({"gnn.step": 40e-6, "gnn.backward": 10e-6, "gnn.agg_t.residual": 0.0,
                                      "gnn.sync": 30e-6, "gnn.optimizer": 0.0})
    assert s.innermost_idle_s == pytest.approx({"gnn.backward": 10e-6, "gnn.sync": 30e-6, "none": 10e-6})


def test_the_harness_summary_reads_the_first_capture_unchanged():
    """The harness's summary labels a gap with the host op at its middle;
    only a capture with the recorder off, holding no gnn.* span, reads as
    at the parent."""
    assert trace.summarize(canned()).idle_gaps[0] == ["aten::nonzero", pytest.approx(30e-6)]


def setup_spans():
    def sp(name, s, e, **attrs):
        return Span(name, s, e, None, 1, attrs)

    return [sp("gnn.plan.densify", 0, 2_000_000_000), sp("gnn.plan.transpose", 2_000_000_000, 2_500_000_000),
            sp("gnn.plan.transpose", 3_000_000_000, 3_250_000_000),
            sp("gnn.build", 4_000_000_000, 4_100_000_000, kernel="bcsr_spmm", cached=False)]


def test_readings():
    s = spans.by_span(annotated())
    got = spans.readings("train", s, setup_spans(), {"residual.edges": 30, "residual.slots": 40})
    assert got == pytest.approx({
        "residual_ms.train": 5e-3, "bwd_ms.train": 15e-3, "opt_ms.train": 10e-3, "sync_idle_ms.train": 15e-3,
        "residual_occupancy.train": 75.0, "plan_densify_s": 2.0, "plan_transpose_s": 0.75, "build_s": 0.1,
    })


def test_each_reading_is_none_without_its_spans_or_counters():
    got = spans.readings("forward", spans.by_span(canned()), [], {})
    assert got == dict.fromkeys(["residual_ms.forward", "bwd_ms.forward", "opt_ms.forward", "sync_idle_ms.forward",
                                 "residual_occupancy.forward", "plan_densify_s", "plan_transpose_s", "build_s"])
    assert spans.readings("gat", None, [], {"residual.edges": 3})["residual_occupancy.gat"] is None


def test_host_reads_per_pass_by_site():
    def sp(name, parent, **attrs):
        return Span(name, 0, 1, parent, 1, attrs)

    rec = [sp("gnn.step", None), sp("gnn.sync", 0, site="a"), sp("gnn.sync", 0, site="b"), sp("gnn.sync", 0, site="a"),
           sp("gnn.step", None), sp("gnn.sync", 4, site="a")]
    assert spans.per_pass_by_site(rec) == {"a": 1.5, "b": 0.5}
    assert spans.per_pass_by_site([]) == {}
