"""The trace's arithmetic on a synthetic Chrome trace."""

import pytest


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    from benchmark.core.trace import Trace

    return Trace([
        _ev("bench.traced", "user_annotation", 1000.0, 1000.0),
        _ev("bench.upload", "user_annotation", 1000.0, 300.0),
        _ev("bench.program", "user_annotation", 1300.0, 500.0),
        _ev("bench.wait", "user_annotation", 1800.0, 200.0),
        # a kernel before the window, partly inside it
        _ev("void coupling_mma_kernel<16, 4>(x)", "kernel", 900.0, 200.0),
        _ev("void coupling_mma_narrow_kernel(x)", "kernel", 1400.0, 100.0),
        _ev("void transition_mma_kernel<16, 16, false, false>(x)",
            "kernel", 1450.0, 100.0),
        _ev("Memcpy DtoH", "gpu_memcpy", 1850.0, 50.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 1300.0, 10.0),
    ])


def test_idle_is_the_window_less_the_union_of_device_events():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    # inside [1000, 2000]: [1000, 1100] + [1400, 1550] + [1850, 1900]
    assert t.busy_s == pytest.approx(300e-6)


def test_a_gap_before_the_first_device_event_counts_as_idle():
    from benchmark.core.trace import Trace

    t = Trace([_ev("bench.traced", "user_annotation", 0.0, 1000.0),
               _ev("k", "kernel", 600.0, 400.0)])
    assert t.busy_s / t.window_s == pytest.approx(0.4)
    assert t.idle_gaps() == [["host", pytest.approx(600e-6)]]


def test_kernels_by_name_and_the_breakdown():
    t = _trace()
    n, s = t.kernels(("coupling_mma",))
    assert n == 2 and s == pytest.approx(200e-6)
    assert t.kernels(("transition_mma",))[0] == 1
    ops = t.top_ops()
    assert ops[0][0].startswith("void coupling_mma_narrow") or ops[0][1] \
        == pytest.approx(100e-6)
    gaps = t.idle_gaps()
    # longest: [1100, 1400] under upload (mid 1250), then [1550, 1850]
    assert gaps[0] == ["upload", pytest.approx(300e-6)]
    assert gaps[1] == ["program", pytest.approx(300e-6)]
    assert {g[0] for g in gaps} <= {"upload", "program", "wait", "host"}
    assert len(gaps) == 3
