"""Operations and bytes of the RevResNet's launches, from shapes.

Each coupling block is one launch (K1, csrc/coupling_mma.cu); each
stride-2 block one launch of K2 (csrc/transition_mma.cu, full-resolution
entry, when the half-resolution width is a multiple of 128) or K3 (the
same file, half-resolution entry), as the configuration's blocks fall.
A decode makes the same launches as an encode. Operations are 2 per
multiply-add of the three 3x3 convs; bytes count each input read once and
each output written once: a stream is `elem` bytes an element, the
weights are bf16 with a float32 bias.
"""

from __future__ import annotations

import collections

Launch = collections.namedtuple("Launch", "kernel flop nbytes")


def _conv_macs(cin, mid, cout):
    return 9 * (cin * mid + mid * mid + mid * cout)


def launches(cfg, b: int, h: int, w: int, elem: int = 2):
    """[Launch] of one encode of a (b, h, w, 3) batch."""
    out = []
    d = 1
    plan = []
    for ch, depth, stride in zip(cfg["nChannels"], cfg["nBlocks"],
                                 cfg["nStrides"]):
        plan += [(ch, stride)] + [(ch, 1)] * (depth - 1)
    plan += [(cfg["hidden_dim"] * 4 ** cfg["sp_steps"], 1)] * cfg[
        "reduction_blocks"]
    for ch, stride in plan:
        mid = ch // cfg["mult"]
        cin = ch if stride == 1 else ch // 4
        macs = _conv_macs(cin, mid, ch)
        wbytes = 2 * macs + 4 * (2 * mid + ch)
        if stride == 1:
            px = b * (h // d) * (w // d)
            out.append(Launch("k1", 2 * macs * px, 3 * ch * px * elem
                              + wbytes))
            continue
        d *= 2
        px = b * (h // d) * (w // d)
        if (w // d) % 128 == 0:        # K2: a, b in; out and pass out
            out.append(Launch("k2", 2 * macs * px, 4 * ch * px * elem
                              + wbytes))
        else:                          # K3: a_u, b_u in; out
            out.append(Launch("k3", 2 * macs * px, 3 * ch * px * elem
                              + wbytes))
    return out


def encode_flop(cfg, b: int, h: int, w: int) -> float:
    return float(sum(l.flop for l in launches(cfg, b, h, w)))


def network_flop(cfg, b: int, h: int, w: int) -> float:
    """An encode and a decode."""
    return 2 * encode_flop(cfg, b, h, w)
