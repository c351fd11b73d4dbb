"""The port's stage spans (runtime/profiling.span) on the CPU.

Under a CPU torch.profiler each program opens its stage spans once a call,
in order: the masked (auto-seg) video program segment, remap, encode,
regional_cwct, decode; the global one encode, cwct, decode;
pipeline.stylize an encode for each image, cwct, decode; the tiler
tile_pass1 and tile_pass2 once an image. Outputs are bit-equal with and
without the profiler. Without a profiler, and while torch.export or
torch.compile traces, a span is one shared nullcontext and enters no
record_function. Tiny configurations (one or two blocks a stage, one
SegFormer block a stage) at 32-64 px; weights seeded.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models import cwct, pipeline, ultra
from vstnet_tpu_torch.models import remapping as remap
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.models import segformer as sf
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.runtime import export as ex
from vstnet_tpu_torch.runtime import profiling

torch.set_num_threads(2)

SMALL = RevResNetConfig(n_blocks=(1, 1, 1))
TINY = (1, 1, 1, 1)
MASKED = ["segment", "remap", "encode", "regional_cwct", "decode"]


@pytest.fixture(scope="module")
def net():
    net = RevResNet(SMALL, device="cpu")
    net.init_weights(torch.Generator().manual_seed(0))
    return net


@pytest.fixture(scope="module")
def seg():
    torch.manual_seed(2)
    return sf.Segmenter(net=sf.SegFormer(TINY, device="cpu"),
                        label_mapping=remap.load_label_mapping())


def _images(seed, n, h, w):
    g = torch.Generator().manual_seed(seed)
    small = torch.rand((n, 3, h // 8, w // 8), generator=g)
    x = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear")
    return x.permute(0, 2, 3, 1).contiguous()


def _spans(fn, calls=1):
    """(the vst.* spans that `calls` calls of fn() open under a CPU
    profiler, by start, without the prefix; the last output), after
    checking that the output equals the output without a profiler."""
    want = fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            got = fn()
    for a, b in zip(*(torch.utils._pytree.tree_leaves(o)
                      for o in (want, got))):
        assert torch.equal(a, b)
    events = sorted((e for e in prof.events()
                     if e.name.startswith(profiling.SPAN_PREFIX)),
                    key=lambda e: e.time_range.start)
    return [e.name[len(profiling.SPAN_PREFIX):] for e in events], got


def test_masked_video_program_opens_its_five_stages_in_order(net, seg):
    style = _images(1, 1, 64, 64)
    frames = _images(2, 2, 64, 64)
    fast = rf.pack_revresnet(net)
    region, plan, _ = pipeline.prepare_masked_style(fast, seg, style, SMALL)
    fn = pipeline.make_masked_fused_video_fn(SMALL, seg_hw=(32, 32),
                                             seg_half=False, out_u8=True)
    names, (out, masks) = _spans(
        lambda: fn(fast, seg.net, seg.label_mapping, region, plan, frames),
        calls=2)
    assert names == MASKED * 2
    assert out.dtype == torch.uint8 and masks.shape == (2, 64, 64)


@pytest.mark.parametrize("interp", [False, True])
def test_global_video_program_opens_encode_cwct_decode(net, interp):
    fast = rf.pack_revresnet(net, torch.bfloat16)
    ls, mu = cwct.style_factors_packed(rf.encode_fast(
        fast, _images(1, 1, 32, 32).to(torch.bfloat16), SMALL,
        packed_latent=True), SMALL.latent_channels)
    fn = pipeline.make_fused_video_fn(SMALL, out_u8=True, interp=interp)
    alpha = (torch.tensor(0.25),) if interp else ()
    frames = _images(3, 2, 32, 32)
    names, _ = _spans(lambda: fn(fast, frames, ls, mu, *alpha))
    assert names == ["encode", "cwct", "decode"]


def test_stylize_opens_two_encodes_a_cwct_and_a_decode(net):
    c, s = _images(4, 1, 32, 32), _images(5, 1, 32, 48)
    names, _ = _spans(lambda: pipeline.stylize(net, c, s))
    assert names == ["encode", "encode", "cwct", "decode"]


@pytest.mark.parametrize("mode", ["global", "interp", "masked"])
def test_tiler_opens_each_pass_once_an_image(net, mode):
    c = _images(6, 1, 64, 96)
    s = _images(7, 1, 32, 32)
    kw = dict(tile=48, overlap=8)
    if mode == "global":
        fn = lambda: ultra.stylize_tiled(net, c, s, SMALL, **kw)  # noqa: E731
    elif mode == "interp":
        fn = lambda: ultra.stylize_tiled_interp(  # noqa: E731
            net, c, [s, s.flip(1)], torch.tensor([0.5, 0.5]), SMALL,
            alpha_c=0.25, **kw)
    else:
        cm = (torch.arange(96)[None, None, :] // 48).expand(1, 64, 96)
        sm = (torch.arange(32)[None, None, :] // 16).expand(1, 32, 32)
        fn = lambda: ultra.stylize_tiled_masked(  # noqa: E731
            net, c, s, cm.to(torch.int32), sm.to(torch.int32), SMALL,
            max_labels=4, **kw)
    names, out = _spans(fn, calls=2)
    assert names == ["tile_pass1", "tile_pass2"] * 2
    assert out.shape == (1, 64, 96, 3)


@pytest.fixture
def entries(monkeypatch):
    """The calls of record_function's entry op, counted."""
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def spy(*args):
        calls.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        spy)
    return calls


def test_without_a_profiler_a_span_is_the_shared_nullcontext(net, entries):
    off = profiling.span("encode")
    assert off is profiling.span("decode") and off is profiling._OFF
    c, s = _images(8, 1, 32, 32), _images(9, 1, 32, 32)
    pipeline.stylize(net, c, s)
    assert entries == []
    with profile(activities=[ProfilerActivity.CPU]):
        pipeline.stylize(net, c, s)
    assert entries == ["vst.encode", "vst.encode", "vst.cwct", "vst.decode"]


def test_an_export_under_a_profiler_holds_no_profiler_op(net):
    with profile(activities=[ProfilerActivity.CPU]):
        ep, _ = ex.export_stylize(net, SMALL, 16, 16, device="cpu")
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]


def test_a_compiled_program_under_a_profiler_enters_no_span(net, entries):
    def fn(x):
        with profiling.span("encode"):
            return x * 2.0

    compiled = torch.compile(fn, backend="eager", fullgraph=True)
    x = torch.from_numpy(np.arange(4, dtype=np.float32))
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.equal(compiled(x), x * 2.0)
    # torch.compile records its own ranges
    assert entries and not [e for e in entries
                            if e.startswith(profiling.SPAN_PREFIX)]
