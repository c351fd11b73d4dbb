"""Fast-path reversible network: every block runs as one fused kernel.

Counterpart of vstnet_tpu/models/revresnet_fast.py. The same math as
models/revresnet.py, with every stride-1 block (the channel reduction's
included) routed through `fused_coupling` (K1) and every stride-2 block
through `fused_transition` (K2) or `fused_transition_half` (K3), in bf16 or
float32, at any batch and any image size that is a multiple of 4. On the
CPU the wrappers run their plain versions, so this module is also the CPU
path.

The TPU route tables (tile pickers, batch caps, the flat layout and its
segments) have no counterpart: the CUDA kernels take every shape. One rule
of them is kept, so that both packages run the same kernel on the same
frames: a stride-2 block takes the full-resolution entry (K2) when its
half-resolution width is a multiple of 128 and the half-resolution entry
(K3, pixel (un)shuffle by the caller) otherwise (`_half_res_entry`).
"""

from __future__ import annotations

import torch

from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.ops.coupling import (
    channel_merge,
    channel_split,
    injective_pad,
    injective_unpad,
    pixel_shuffle,
    pixel_unshuffle,
)
from vstnet_tpu_torch.ops.coupling_fused import (
    fused_coupling,
    fused_transition,
    fused_transition_half,
    pack_coupling_weights,
    pack_transition_weights,
)


def pack_revresnet(net, dtype=torch.float32):
    """RevResNet -> fast-path weights on the net's device, packed once:
    {"stack": [(stride, packed), ...], "reduction": [packed, ...],
    "dtype": dtype}."""
    stack = []
    for block in net.stack:
        pack = (pack_coupling_weights if block.stride == 1
                else pack_transition_weights)
        stack.append((block.stride, pack(block.weights(), dtype)))
    reduction = [pack_coupling_weights(b.weights(), dtype)
                 for b in net.channel_reduction.block_list]
    return {"stack": stack, "reduction": reduction, "dtype": dtype}


def _half_res_entry(w_half: int) -> bool:
    """Whether a stride-2 block whose output is w_half wide takes K3: the
    JAX package's rule (its full-resolution entry needs a half-res width
    that is a multiple of 128 lanes)."""
    return w_half % 128 != 0


def _split(x):
    """channel_split into the contiguous streams the kernels take."""
    x1, x2 = channel_split(x)
    return x1.contiguous(), x2.contiguous()


@torch.no_grad()
def encode_fast(fast_params, x, cfg: RevResNetConfig,
                packed_latent: bool = False):
    """x: NHWC (B, H, W, 3) -> latent NHWC.

    packed_latent=True returns the pre-shuffle NCHW tensor
    (B, latent_channels * 4**sp_steps, H/4, W/4): each shuffled pixel's
    latent is a contiguous chunk of these channels, so the global cWCT runs
    on it directly and decode_fast(packed_latent=True) takes it back."""
    ds = cfg.down_scale
    if x.shape[1] % ds or x.shape[2] % ds:
        raise ValueError(f"encode_fast: spatial dims {x.shape[1]}x"
                         f"{x.shape[2]} must be multiples of {ds}")
    x1, x2 = _split(injective_pad(x.permute(0, 3, 1, 2), cfg.inj_pad))
    for stride, w in fast_params["stack"]:
        if stride == 1:
            x1, x2 = x2, fused_coupling(x1, x2, w)
        elif _half_res_entry(x1.shape[3] // 2):
            x1, x2 = fused_transition_half(
                pixel_unshuffle(x1).contiguous(),
                pixel_unshuffle(x2).contiguous(), w)
        else:
            x1, x2 = fused_transition(x1, x2, w)
    for w in fast_params["reduction"]:
        x1, x2 = x2, fused_coupling(x1, x2, w)
    x = channel_merge(x1, x2)
    if packed_latent:
        return x
    for _ in range(cfg.sp_steps):
        x = pixel_shuffle(x)
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def decode_fast(fast_params, z, cfg: RevResNetConfig,
                packed_latent: bool = False):
    """Latent (NHWC, or packed NCHW) -> image NHWC; inverse of encode_fast."""
    if packed_latent:
        x = z
    else:
        x = z.permute(0, 3, 1, 2)
        for _ in range(cfg.sp_steps):
            x = pixel_unshuffle(x)
    x1, x2 = _split(x)
    # forward: (a, b) -> (b, F(b) + a); inverse: (p, q) -> (q - F(p), p)
    for w in reversed(fast_params["reduction"]):
        x1, x2 = fused_coupling(x2, x1, w, inverse=True), x1
    for stride, w in reversed(fast_params["stack"]):
        if stride == 1:
            x1, x2 = fused_coupling(x2, x1, w, inverse=True), x1
        elif _half_res_entry(x1.shape[3]):
            x1, x2 = fused_transition_half(x2, x1, w, inverse=True)
            x1 = pixel_shuffle(x1).contiguous()
            x2 = pixel_shuffle(x2).contiguous()
        else:
            x1, x2 = fused_transition(x2, x1, w, inverse=True)
    x = injective_unpad(channel_merge(x1, x2), cfg.inj_pad)
    return x.permute(0, 2, 3, 1)
