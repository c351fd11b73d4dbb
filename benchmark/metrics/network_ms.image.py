"""Milliseconds of the standard network alone on one request (the two
encodes and the decode, float32, TF32 off), between CUDA events, after
the window: the mean of 5 calls after 2."""

from benchmark.core.window import cuda_ms


def read(ctx):
    st = ctx.state
    if st.p.get("route") != "standard" or not st.on_card:
        return None
    from vstnet_tpu_torch.models import cwct

    net = st.model.net
    c = st.put(st.pool[0], st.dev)
    s = st.put(st.style_u8, st.dev)
    z = cwct.transfer(net.encode(c), net.encode(s))
    return cuda_ms(lambda: (net.encode(c), net.encode(s), net.decode(z)),
                   st.dev)
