"""Plain ultra-resolution stylization by overlapping tiles (global cWCT).

The tiler the configuration's 4K route states: tiles of `tile` pixels
(floored to the network's down-scale, at most the image) overlapping by
`overlap`, starting every tile - 2 overlap pixels with the last tile
flush against the far edge; each latent pixel is owned by exactly one
tile (splits at the overlaps' midpoints); the content's statistics are
the owned pixels' moments summed in float64 over the tiles; one global
transform; each tile encoded, transformed, decoded and blended into the
image with raised-cosine ramps over its overlaps (1 on the image's
edges), normalised by the summed weights.

Tiles go through the reference network one at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cwct
from benchmark.reference import revresnet as rn
from benchmark.reference.lowp import Exact


def _starts(total, tile, stride):
    if total <= tile:
        return [0]
    s = list(range(0, total - tile, stride))
    s.append(total - tile)
    return s


def _ramp(n, overlap, lo_edge, hi_edge):
    w = np.ones(n, np.float32)
    r = 0.5 - 0.5 * np.cos(np.linspace(0.0, np.pi, overlap + 2)[1:-1])
    if not lo_edge:
        w[:overlap] = r
    if not hi_edge:
        w[n - overlap:] = r[::-1]
    return w


class Grid:
    def __init__(self, h, w, ds, sc, tile, overlap):
        tile = min(tile, max(h, w))
        tile = max(tile - tile % ds, ds)
        self.ov = max(overlap - overlap % ds, ds)
        self.th, self.tw = min(tile, h), min(tile, w)
        self.h, self.w, self.sc = h, w, sc
        self.ys = _starts(h, self.th, max(self.th - 2 * self.ov, ds))
        self.xs = _starts(w, self.tw, max(self.tw - 2 * self.ov, ds))

    def tiles(self):
        for iy, y0 in enumerate(self.ys):
            for ix, x0 in enumerate(self.xs):
                yield iy, y0, ix, x0

    def owned(self, iy, y0, ix, x0):
        """The latent rectangle (y0, y1, x0, x1) the tile owns, in tile
        coordinates."""
        sc, ov = self.sc, self.ov
        oy0 = 0 if iy == 0 else ov // sc
        oy1 = (self.th // sc if iy == len(self.ys) - 1
               else (self.ys[iy + 1] - y0) // sc + ov // sc)
        ox0 = 0 if ix == 0 else ov // sc
        ox1 = (self.tw // sc if ix == len(self.xs) - 1
               else (self.xs[ix + 1] - x0) // sc + ov // sc)
        return oy0, oy1, ox0, ox1

    def weight(self, y0, x0, device):
        wy = _ramp(self.th, self.ov, y0 == 0, y0 + self.th == self.h)
        wx = _ramp(self.tw, self.ov, x0 == 0, x0 + self.tw == self.w)
        return torch.from_numpy(np.outer(wy, wx)).to(device)[..., None]


@torch.no_grad()
def stylize_tiled(weights, cfg, content, style, tile, overlap, lp=Exact()):
    """content (1, H, W, 3), style (1, Hs, Ws, 3) in [0, 1] -> (1, H, W, 3)
    float32 raw decoder output."""
    _, h, w, _ = content.shape
    ds = 1
    for s in cfg["nStrides"]:
        ds *= s
    sc = ds // 2 ** cfg["sp_steps"]
    g = Grid(h, w, ds, sc, tile, overlap)
    ls, mu_s = cwct.style_factor(rn.encode(weights, cfg, style, lp)[0])

    def tile_of(y0, x0):
        return content[:, y0:y0 + g.th, x0:x0 + g.tw]

    c = 2 * cfg["hidden_dim"]
    n = 0
    s1 = torch.zeros(c, dtype=torch.float64, device=content.device)
    s2 = torch.zeros((c, c), dtype=torch.float64, device=content.device)
    for iy, y0, ix, x0 in g.tiles():
        z = rn.encode(weights, cfg, tile_of(y0, x0), lp)[0]
        oy0, oy1, ox0, ox1 = g.owned(iy, y0, ix, x0)
        rows = z[oy0:oy1, ox0:ox1].reshape(-1, c).double()
        n += rows.shape[0]
        s1 += rows.sum(dim=0)
        s2 += rows.t() @ rows
    mean = s1 / n
    cov = (s2 - n * torch.outer(mean, mean)) / (n - 1)
    t, b = cwct.transform(mean.float(), cov.float(), ls, mu_s)

    out = torch.zeros((h, w, 3), dtype=torch.float64, device=content.device)
    wsum = torch.zeros((h, w, 1), dtype=torch.float64, device=content.device)
    for _, y0, _, x0 in g.tiles():
        z = rn.encode(weights, cfg, tile_of(y0, x0), lp)[0]
        zt = cwct.apply(z.reshape(-1, c), t, b).reshape(z.shape)
        o = rn.decode(weights, cfg, zt[None], lp)[0].double()
        wt = g.weight(y0, x0, content.device).double()
        out[y0:y0 + g.th, x0:x0 + g.tw] += o * wt
        wsum[y0:y0 + g.th, x0:x0 + g.tw] += wt
    return (out / wsum).float()[None]
