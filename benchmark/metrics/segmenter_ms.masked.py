"""Milliseconds of segment_mask (SegFormer-B4, bf16, as the auto-seg
program calls it) alone on a batch of the window's frames, between CUDA
events, after the window: the mean of 5 calls after 2."""

from benchmark.core.window import cuda_ms


def read(ctx):
    st = ctx.state
    if not getattr(st, "masked", False) or not st.on_card:
        return None
    from vstnet_tpu_torch.models.segformer import segment_mask

    x = st.window_batch()
    return cuda_ms(lambda: segment_mask(st.seg.net, x, half=True), st.dev)
