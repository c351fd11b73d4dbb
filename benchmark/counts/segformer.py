"""Operations and bytes of SegFormer, from shapes.

`flop` is the whole network on a (b, h, w) batch: every conv and linear
(2 per multiply-add), the attention's two products (4 N M C a block), the
depthwise convs; norms, softmax, GELU and resizes are left out. The two
kernel lists give the launches of the port's hand-written kernels as the
configuration routes them: spatial-reduction attention (K4,
csrc/attention.cu) where a stage has at least MIN_Q queries and at most
MAX_KV keys, and the MixFFN's depthwise conv + bias + GELU (K5,
csrc/dwconv.cu) where the hidden width is a multiple of 128; bf16
activations.
"""

from __future__ import annotations

import collections

Launch = collections.namedtuple("Launch", "kernel flop nbytes")

MIN_Q = 8192       # K4 takes a stage with at least this many queries
MAX_KV = 8192      # and at most this many keys


def grids(cfg, h: int, w: int):
    """[(h_s, w_s, m_s)]: each stage's token grid and its key count."""
    out = []
    for s in range(4):
        k, st = cfg["patch_sizes"][s], cfg["strides"][s]
        h = (h + 2 * (k // 2) - k) // st + 1
        w = (w + 2 * (k // 2) - k) // st + 1
        sr = cfg["sr_ratios"][s]
        m = (h // sr) * (w // sr) if sr > 1 else h * w
        out.append((h, w, m))
    return out


def flop(cfg, b: int, h: int, w: int) -> float:
    total = 0
    cin = cfg["num_channels"]
    g = grids(cfg, h, w)
    for s, (hs, ws, m) in enumerate(g):
        c = cfg["hidden_sizes"][s]
        r = cfg["mlp_ratios"][s]
        sr = cfg["sr_ratios"][s]
        k = cfg["patch_sizes"][s]
        n = hs * ws
        total += 2 * cin * c * k * k * n
        blk = (2 * n * c * c            # q
               + 2 * m * c * 2 * c      # kv
               + 4 * n * m * c          # q k^T, p v
               + 2 * n * c * c          # proj
               + 2 * n * c * r * c * 2  # fc1, fc2
               + 2 * 9 * r * c * n)     # depthwise
        if sr > 1:
            blk += 2 * c * c * sr * sr * m
        total += cfg["depths"][s] * blk
        cin = c
    e = cfg["decoder_hidden_size"]
    n1 = g[0][0] * g[0][1]
    total += sum(2 * g[s][0] * g[s][1] * cfg["hidden_sizes"][s] * e
                 for s in range(4))
    total += 2 * n1 * 4 * e * e + 2 * n1 * e * cfg["num_labels"]
    return float(b * total)


def attention_launches(cfg, b: int, h: int, w: int):
    out = []
    for s, (hs, ws, m) in enumerate(grids(cfg, h, w)):
        n = hs * ws
        c = cfg["hidden_sizes"][s]
        if n >= MIN_Q and m <= MAX_KV:
            nbytes = b * 2 * c * (2 * n + 2 * m)     # q, k, v in; o out
            out += [Launch("k4", b * 4 * n * m * c, nbytes)] * cfg[
                "depths"][s]
    return out


def dwconv_launches(cfg, b: int, h: int, w: int):
    out = []
    for s, (hs, ws, _) in enumerate(grids(cfg, h, w)):
        c = cfg["mlp_ratios"][s] * cfg["hidden_sizes"][s]
        if c % 128 == 0:
            n = b * hs * ws
            nbytes = 2 * 2 * c * n + 4 * 10 * c      # x in, y out; taps, bias
            out += [Launch("k5", 2 * 9 * c * n, nbytes)] * cfg["depths"][s]
    return out
