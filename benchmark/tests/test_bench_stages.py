"""The program's stages (benchmark/core/stages.py) on a synthetic Chrome
trace, the segment a traced run records for them, and the metrics that
read them."""

import os
import types

import pytest

from conftest import ROOT


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _ev("cudaLaunchKernel", "cuda_runtime", ts, 5.0, corr)


SPANS = [
    _ev("vst.segment", "user_annotation", 100.0, 300.0),
    _ev("vst.regional_cwct", "user_annotation", 400.0, 300.0),
    _ev("vst.tile_pass1", "user_annotation", 700.0, 400.0),
    _ev("vst.encode", "user_annotation", 750.0, 150.0),       # nested
    _ev("vst.tile_pass2", "user_annotation", 1100.0, 200.0),
    _ev("vst.decode", "user_annotation", 1150.0, 100.0),
    _ev("vst.cwct", "user_annotation", 1260.0, 30.0),
]

EVENTS = [
    _ev("bench.traced", "user_annotation", 0.0, 2000.0),
    _ev("bench.program", "user_annotation", 100.0, 1300.0),
    # segment: two kernels that overlap on the device
    _launch(120.0, 1), _ev("k_a", "kernel", 150.0, 200.0, 1),
    _launch(200.0, 2), _ev("k_b", "kernel", 300.0, 80.0, 2),
    # regional_cwct: a kernel, then a copy; the device idles inside it
    _launch(450.0, 3), _ev("k_c", "kernel", 500.0, 50.0, 3),
    _ev("cudaMemcpyAsync", "cuda_runtime", 460.0, 5.0, 4),
    _ev("Memcpy DtoH", "gpu_memcpy", 560.0, 40.0, 4),
    # encode inside tile_pass1
    _launch(760.0, 6), _ev("k_d", "kernel", 800.0, 200.0, 6),
    # decode and cwct inside tile_pass2; a device range of the profiler's
    _launch(1160.0, 7), _ev("k_e", "kernel", 1200.0, 100.0, 7),
    _launch(1270.0, 8), _ev("k_f", "kernel", 1300.0, 20.0, 8),
    _ev("cudaMemsetAsync", "cuda_driver", 1280.0, 5.0, 9),
    _ev("Memset", "gpu_memset", 1320.0, 10.0, 9),
    _ev("vst.decode", "gpu_user_annotation", 1200.0, 100.0),
    # launched outside every span
    _launch(1500.0, 5), _ev("k_g", "kernel", 1600.0, 100.0, 5),
] + SPANS


def _ctx(stages=None, units=2, traced=True, cell=None, state=None):
    """A traced run's context whose stage segment is already recorded
    as `stages` (recorded on first read where `stages` is None)."""
    from benchmark.core.session import Context
    from benchmark.core.trace import Trace

    notes = []
    ctx = Context(cell or types.SimpleNamespace(name="cell"), state, None,
                  0.0, trace=Trace(EVENTS) if traced else None,
                  traced_units=units if traced else 0)
    ctx.note = notes.append
    if stages is not None:
        ctx.stages = stages
    return ctx, notes


class _Loop:
    """A cell's loop whose program opens the stage spans as the port's
    video program does, or none (an earlier commit's program)."""

    def __init__(self, spans=True):
        self.spans, self.calls = spans, []

    def run_traced(self, state, units):
        import torch

        from benchmark.core.trace import span as bench_span
        from vstnet_tpu_torch.runtime.profiling import span

        self.calls.append(units)
        x = torch.ones(8, 8)
        for _ in range(units):
            with bench_span("program"):
                if self.spans:
                    with span("segment"):
                        x = x @ x
                    with span("regional_cwct"):
                        x = x + 1


def test_a_run_records_its_stage_segment_once():
    """The first stage metric of a traced run records ctx.traced_units
    more units inside bench.traced and keeps them for the others; an
    earlier program's loop is not run again."""
    from benchmark.core import stages

    loop = _Loop()
    cell = types.SimpleNamespace(name="cell", loop=lambda bench_dir: loop)
    ctx, notes = _ctx(cell=cell, units=3)
    assert stages.per_unit(ctx, "host_ms", "segment") > 0.0
    assert stages.per_unit(ctx, "host_ms", "regional_cwct") > 0.0
    assert loop.calls == [3] and notes == []
    assert {n: len(v) for n, v in ctx.stages.spans.items()} == {
        "segment": 3, "regional_cwct": 3}
    # a program that opens no span in its calls
    loop = _Loop(spans=False)
    cell = types.SimpleNamespace(name="cell", loop=lambda bench_dir: loop)
    ctx, notes = _ctx(cell=cell)
    assert stages.per_unit(ctx, "host_ms", "segment") is None
    assert notes == ["no vst.segment span in the trace"]
    # a program without runtime/profiling's spans records nothing
    import vstnet_tpu_torch.runtime.profiling as profiling

    prefix = profiling.SPAN_PREFIX
    del profiling.SPAN_PREFIX
    try:
        ctx, notes = _ctx(cell=cell)
        assert stages.per_unit(ctx, "device_ms", "segment") is None
        assert stages.per_unit(ctx, "host_ms", "segment") is None
    finally:
        profiling.SPAN_PREFIX = prefix
    assert loop.calls == [2] and len(notes) == 1
    assert "opens no vst.* span" in notes[0]


def test_device_host_idle_and_launches_of_a_stage():
    from benchmark.core.stages import Stages

    st = Stages(EVENTS)
    # segment: [150, 350] and [300, 380] merge
    assert st.device_ms("segment") == pytest.approx(0.230)
    assert st.host_ms("segment") == pytest.approx(0.300)
    # the window idles [100, 150] and [380, 400] inside the span
    assert st.idle_ms("segment") == pytest.approx(0.070)
    assert st.launches("segment") == 2
    # regional_cwct: a kernel and a copy, one launch; idle [400, 500],
    # [550, 560] and [600, 700]
    assert st.device_ms("regional_cwct") == pytest.approx(0.090)
    assert st.idle_ms("regional_cwct") == pytest.approx(0.210)
    assert st.launches("regional_cwct") == 1
    # nesting: encode's kernel is tile_pass1's too
    assert st.device_ms("tile_pass1") == st.device_ms("encode") \
        == pytest.approx(0.200)
    assert st.device_ms("tile_pass2") == pytest.approx(0.130)
    assert st.device_ms("encode", "decode") == pytest.approx(0.300)
    # the kernel launched outside every span belongs to none
    owned = {d for n in st.spans for d in st.owned([n])}
    assert len(owned) == len(st.device) - 1
    assert all(d[1] != 1600.0 for d in owned)


@pytest.mark.parametrize("name, want", [
    ("segmenter_device_ms.masked", 0.115),
    ("segmenter_host_ms.masked", 0.150),
    ("segmenter_idle_ms.masked", 0.035),
    ("regional_cwct_device_ms.masked", 0.045),
    ("regional_cwct_host_ms.masked", 0.150),
    ("regional_cwct_idle_ms.masked", 0.105),
    ("regional_cwct_launches.masked", 0.5),
    ("cwct_device_ms.video", 0.015),
    ("network_device_ms.image", 0.150),
    ("tile_pass1_ms", 0.100),
    ("tile_pass2_ms", 0.065),
])
def test_each_stage_metric_reads_per_unit_and_none_without_spans(name,
                                                                 want):
    from benchmark.core import spec

    read = spec.load_module("metrics", name,
                            os.path.join(ROOT, "benchmark")).read
    from benchmark.core.stages import Stages

    ctx, notes = _ctx(Stages(EVENTS))
    assert read(ctx) == pytest.approx(want)
    assert notes == []
    # a trace in which the program opened no vst.* span
    ctx, notes = _ctx(Stages([e for e in EVENTS if e not in SPANS]))
    assert read(ctx) is None
    assert len(notes) == 1 and "span in the trace" in notes[0]
    # an untraced run has no trace
    assert read(_ctx(traced=False)[0]) is None
