"""Milliseconds of the regional cWCT (cwct.transfer_masked_factored, as
the auto-seg program calls it) alone on a batch of the window's frames
under their masks, between CUDA events, after the window: the mean of 5
calls after 2."""

from benchmark.core.window import cuda_ms


def read(ctx):
    st = ctx.state
    if not getattr(st, "masked", False) or not st.on_card:
        return None
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.models import revresnet_fast as rf
    from vstnet_tpu_torch.ops.resize import resize_nearest

    x = st.window_batch()
    fast = st.model.fast_params
    _, cm = st.stylize([x])
    z = rf.encode_fast(fast, x.to(fast["dtype"]), st.model.cfg)
    m = resize_nearest(cm[0], z.shape[1], z.shape[2])
    labels, ns, mean_s, cov_s = st.region
    return cuda_ms(lambda: cwct.transfer_masked_factored(
        z, m, labels, ns, mean_s, cov_s), st.dev)
