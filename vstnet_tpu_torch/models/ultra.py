"""Ultra-resolution stylization by overlapping tiles, in bounded memory.

Counterpart of vstnet_tpu/models/ultra.py. An image of any size (4K and
above) runs through the network as overlapping tiles, so device memory
and the kernels' shapes stay those of one tile batch, in three steps:

  1. style factors: the style image is encoded whole (styles are small)
     and reduced to (Ls, mu_s) by cwct.style_factors;
  2. content statistics, streamed (pass 1, under the span tile_pass1 of
     runtime/profiling.span): each tile batch is encoded and the
     latent moments of the pixels each tile owns (every latent pixel is
     owned by exactly one tile) are added to accumulators in
     cwct._accumulate's dtype (float64 on a card; float32 on the CPU, as
     the JAX package sums them), and the statistics are rounded to
     float32 once; the sums equal the whole image's wherever an owned
     pixel lies a receptive field inside its tile (the network is fully
     convolutional);
  3. transform, decode and a raised-cosine blend of each tile into (H, W)
     float32 canvases (pass 2, under the span tile_pass2).

With an overlap of at least the receptive field the result equals the
whole-image pipeline to float tolerance; smaller overlaps blend
approximate seams (PSNR-gated in the tests). Tiles run TILE_BATCH at a
time and the tail batch is padded with repeats of its last tile that own
nothing and weigh nothing, so every batch has one shape and makes the same
launches.

Everything stays on the device: tile slicing indexes the content tensor,
ownership masks and blend weights are built there, the moments accumulate
there and each tile is slice-added into the canvases there. Only the
finished image, returned as a (1, H, W, 3) tensor, is the caller's to
read back.

Precision: `fast_params` (revresnet_fast.pack_revresnet, bf16 for
StyleModel.fast_params) routes the tiles through encode_fast/decode_fast
in the packed dtype; without it the tiles take the float32 standard path
(RevResNet.encode/decode). The latent is float32 for the statistics
either way, and is cast back to the packed dtype before decode_fast. The
statistics' matmuls run with TF32 off (cwct.true_f32_matmul) and sum in
cwct._accumulate's dtype: float64 on a card, for the global pass 1
(_moments_chunk, _content_stats) and the regional one
(cwct.region_moments: on a card, one launch of the regional moments
kernel a tile batch, ops/regions.py). Summed in float32 there (cuBLAS over a tile
batch's 4 M latent rows, then the cancelling Gram - n mean mean^T), the
global covariance of a 3840x2160 content lies 2.1e-6 (float32 route) and
1.4e-5 (fused route) of its max from float64 of the same rows, against a
bound of 5e-7; summed in float64, 2.8e-8 and 3.0e-8
(tests/test_torch_cuda.py::
test_tiled_global_statistics_on_card_match_float64). The float32
route's convs run through cuDNN on a card, which uses TF32 unless
`torch.backends.cudnn.allow_tf32` is False: the CLIs clear it for their
process, a library caller who wants true float32 clears it too.

The tile geometry (receptive_field, _starts, _ramp, _TileGrid's starts,
ownership bounds and ramps, ownership_check) is a numpy copy of the JAX
module's; _TileGrid.chunks builds the masks and weights from it on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from vstnet_tpu_torch.config import RevResNetConfig
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.ops.resize import resize_nearest
from vstnet_tpu_torch.runtime.profiling import span

# tiles per batch: pass 1 and pass 2 each run ceil(n_tiles / TILE_BATCH)
# batches of this many tiles
TILE_BATCH = 4


def receptive_field(cfg: RevResNetConfig) -> int:
    """One-sided receptive field (pixels) of encode (== decode): each 3x3
    conv adds 1 px at its stage's scale; 3 convs per block."""
    rf_px = 0
    scale = 1
    for n, stride in zip(cfg.n_blocks, cfg.strides):
        scale *= stride
        rf_px += 3 * n * scale
    rf_px += 3 * 2 * scale  # channel-reduction blocks
    return rf_px


def _starts(total: int, tile: int, stride: int):
    """Tile start offsets covering [0, total), the last tile flush against
    the edge (so the image's borders get true reflection, not reflections
    of padded content)."""
    if total <= tile:
        return [0]
    s = list(range(0, total - tile, stride))
    s.append(total - tile)
    return s


def _ramp(n: int, overlap: int, lo_edge: bool, hi_edge: bool):
    """1D blend weights: 1 in the interior, raised cosine over the overlap
    margins; sides on the image's edge stay at 1."""
    w = np.ones(n, np.float32)
    r = 0.5 - 0.5 * np.cos(np.linspace(0.0, np.pi, overlap + 2)[1:-1])
    if not lo_edge:
        w[:overlap] = r
    if not hi_edge:
        w[n - overlap:] = r[::-1]
    return w


def _enc(weights, x, cfg, fast: bool):
    """Tile encode: the fused kernel path in the packed weights' dtype, or
    the float32 standard path (weights: the RevResNet); the latent comes
    back float32 either way."""
    if fast:
        return rf.encode_fast(weights, x.to(weights["dtype"]), cfg).float()
    return weights.encode(x)


def _dec(weights, z, cfg, fast: bool):
    if fast:
        return rf.decode_fast(weights, z.to(weights["dtype"]), cfg).float()
    return weights.decode(z)


def _slice_tiles(content, y0s, x0s, th: int, tw: int):
    """content (1, H, W, C) -> (T, th, tw, C): the tiles at (y0, x0)."""
    return torch.stack([content[0, y0:y0 + th, x0:x0 + tw]
                        for y0, x0 in zip(y0s, x0s)])


def _moments_chunk(weights, content, y0s, x0s, acc, owns,
                   cfg: RevResNetConfig, th: int, tw: int,
                   fast: bool = False):
    """One tile batch of pass 1: encode, then add the owned pixels' latent
    moments to acc = (n, s1 (C,), s2 (C, C)) in place, in acc's dtype.
    owns (T, h_lat, w_lat) float32 in {0, 1}; all-zero rows pad the tail
    batch. Where acc is wider than the latent (float64 on a card), the
    latent goes to it one tile at a time, so that its wider copies hold
    one tile's rows and not the batch's; otherwise the batch is one
    product, as the JAX package sums it."""
    z = _enc(weights, _slice_tiles(content, y0s, x0s, th, tw), cfg, fast)
    c = z.shape[-1]
    n, s1, s2 = acc
    step = z.shape[0] if s2.dtype == z.dtype else 1
    with cwct.true_f32_matmul():
        for i in range(0, z.shape[0], step):
            zi = z[i:i + step].reshape(-1, c).to(s2.dtype)
            own = owns[i:i + step].reshape(-1, 1).to(s2.dtype)
            zm = zi * own
            n += own.sum()
            s1 += zm.sum(dim=0)
            s2.addmm_(zm.t(), zi)
    return acc


def _tile_masks(cm_lat, y0s, x0s, th: int, tw: int, sc: int):
    """The latent-resolution label tiles of a tile batch."""
    return torch.stack([cm_lat[y0 // sc:y0 // sc + th // sc,
                               x0 // sc:x0 // sc + tw // sc]
                        for y0, x0 in zip(y0s, x0s)])


def _moments_chunk_masked(weights, content, y0s, x0s, acc, owns, cm_lat,
                          labels, cfg: RevResNetConfig, th: int, tw: int,
                          sc: int, fast: bool = False):
    """Per-label pass 1: pixels a tile does not own take label -2 (match
    nothing); the batch's per-label moments are added to acc in place."""
    z = _enc(weights, _slice_tiles(content, y0s, x0s, th, tw), cfg, fast)
    m = torch.where(owns > 0, _tile_masks(cm_lat, y0s, x0s, th, tw, sc), -2)
    for a, d in zip(acc, cwct.region_moments(z, m, labels)):
        a += d
    return acc


def _blend(o, wts, y0s, x0s, out, wsum, th: int, tw: int):
    """Slice-add a batch of stylized tiles, weighted, into the (H, W)
    canvases in place (zero-weight rows pad the tail batch)."""
    for i, (y0, x0) in enumerate(zip(y0s, x0s)):
        out[y0:y0 + th, x0:x0 + tw] += o[i] * wts[i]
        wsum[y0:y0 + th, x0:x0 + tw] += wts[i]
    return out, wsum


def _stylize_chunk(weights, content, y0s, x0s, wts, t, b, out, wsum,
                   cfg: RevResNetConfig, th: int, tw: int,
                   fast: bool = False):
    """One tile batch of pass 2: encode, the global transform, decode,
    blend."""
    z = _enc(weights, _slice_tiles(content, y0s, x0s, th, tw), cfg, fast)
    o = _dec(weights, cwct.apply_transform(z, t, b), cfg, fast)
    return _blend(o, wts, y0s, x0s, out, wsum, th, tw)


def _stylize_chunk_masked(weights, content, y0s, x0s, wts, cm_lat, labels,
                          tsb, valids, out, wsum, cfg: RevResNetConfig,
                          th: int, tw: int, sc: int, fast: bool = False):
    """One tile batch of the regional pass 2: each pixel takes its
    region's transform (cwct.apply_regions: on a card, one launch of the
    regional apply kernel)."""
    ts, bs = tsb
    z = _enc(weights, _slice_tiles(content, y0s, x0s, th, tw), cfg, fast)
    m = _tile_masks(cm_lat, y0s, x0s, th, tw, sc)
    y = cwct.apply_regions(z.reshape(-1, z.shape[-1]),
                           m.reshape(-1).to(torch.int32), labels, ts, bs,
                           valids)
    o = _dec(weights, y.reshape(z.shape), cfg, fast)
    return _blend(o, wts, y0s, x0s, out, wsum, th, tw)


class _TileGrid:
    """Tile geometry shared by every tiled variant: starts, ownership
    bounds (each latent pixel owned by exactly one tile; splits at the
    overlaps' midpoints) and blend ramps."""

    def __init__(self, h, w, cfg, tile, overlap):
        ds = cfg.down_scale
        if h % ds or w % ds:
            raise ValueError(f"content dims must be multiples of {ds}")
        tile = min(tile, max(h, w))
        tile = max(tile - tile % ds, ds)
        self.overlap = max(overlap - overlap % ds, ds)
        self.th = min(tile, h)
        self.tw = min(tile, w)
        stride_h = max(self.th - 2 * self.overlap, ds)
        stride_w = max(self.tw - 2 * self.overlap, ds)
        self.h, self.w = h, w
        self.ys = _starts(h, self.th, stride_h)
        self.xs = _starts(w, self.tw, stride_w)
        self.sc = cfg.latent_scale

    def tiles(self):
        for iy, y0 in enumerate(self.ys):
            for ix, x0 in enumerate(self.xs):
                yield iy, y0, ix, x0

    def own_bounds(self, iy, y0, ix, x0):
        """(oy0, oy1, ox0, ox1): the latent rectangle the tile owns."""
        sc, ov = self.sc, self.overlap
        oy0 = 0 if iy == 0 else (ov // sc)
        oy1 = self.th // sc if iy == len(self.ys) - 1 else (
            (self.ys[iy + 1] - y0) // sc + ov // sc)
        ox0 = 0 if ix == 0 else (ov // sc)
        ox1 = self.tw // sc if ix == len(self.xs) - 1 else (
            (self.xs[ix + 1] - x0) // sc + ov // sc)
        return oy0, oy1, ox0, ox1

    def ramps(self, y0, x0):
        """The tile's blend ramps along H and along W."""
        return (_ramp(self.th, self.overlap, y0 == 0, y0 + self.th == self.h),
                _ramp(self.tw, self.overlap, x0 == 0, x0 + self.tw == self.w))

    def chunks(self, tile_batch: int = TILE_BATCH, need: str = "own",
               device="cpu"):
        """Per batch of `tile_batch` tiles: (y0s, x0s, owns, wts), the
        starts as ints and, on `device`, either the ownership masks (T,
        h_lat, w_lat) (need="own", pass 1) or the blend weights (T, th, tw,
        1) (need="wt", pass 2), made on the device from the rectangles and
        the 1D ramps. The tail batch is padded with repeats of its last
        tile that own nothing and weigh nothing."""
        items = list(self.tiles())
        for c0 in range(0, len(items), tile_batch):
            chunk = items[c0:c0 + tile_batch]
            pad = tile_batch - len(chunk)
            y0s = [it[1] for it in chunk] + [chunk[-1][1]] * pad
            x0s = [it[3] for it in chunk] + [chunk[-1][3]] * pad
            if need == "own":
                owns = torch.zeros((tile_batch, self.th // self.sc,
                                    self.tw // self.sc), dtype=torch.float32,
                                   device=device)
                for i, it in enumerate(chunk):
                    oy0, oy1, ox0, ox1 = self.own_bounds(*it)
                    owns[i, oy0:oy1, ox0:ox1] = 1.0
                yield y0s, x0s, owns, None
            else:
                wy = np.zeros((tile_batch, self.th), np.float32)
                wx = np.zeros((tile_batch, self.tw), np.float32)
                for i, it in enumerate(chunk):
                    wy[i], wx[i] = self.ramps(it[1], it[3])
                wy = torch.from_numpy(wy).to(device)
                wx = torch.from_numpy(wx).to(device)
                yield y0s, x0s, None, (wy[:, :, None, None]
                                       * wx[:, None, :, None])


def _pick_weights(net, fast_params):
    return (fast_params, True) if fast_params is not None else (net, False)


def _zero_moments(c: int, device):
    """Pass 1's accumulators (n, s1 (C,), s2 (C, C)) in the dtype that a
    float32 latent's statistics are summed in on `device`
    (cwct._accumulate: float64 on a card, float32 on the CPU)."""
    dt = cwct._accumulate(torch.empty(0, device=device))
    return tuple(torch.zeros(shape, dtype=dt, device=device)
                 for shape in ((), (c,), (c, c)))


def _content_stats(g, weights, content, cfg, fast, tile_batch):
    """Pass 1 of the global modes: (mean_c, cov_c) float32 of the whole
    image's latent from the tiles' owned pixels, summed and formed (Gram
    - n mean mean^T, which cancels digits) in _zero_moments' dtype and
    rounded once. Runs under the span tile_pass1."""
    with span("tile_pass1"):
        acc = _zero_moments(cfg.latent_channels, content.device)
        for y0s, x0s, owns, _ in g.chunks(tile_batch, "own", content.device):
            acc = _moments_chunk(weights, content, y0s, x0s, acc, owns, cfg,
                                 g.th, g.tw, fast)
        n, s1, s2 = acc
        mean_c = s1 / n
        cov_c = (s2 - n * torch.outer(mean_c, mean_c)) / (n - 1.0)
        return mean_c.float(), cov_c.float()


def _canvases(h, w, device):
    return (torch.zeros((h, w, 3), dtype=torch.float32, device=device),
            torch.zeros((h, w, 1), dtype=torch.float32, device=device))


def _global_pass(g, weights, content, t, b, cfg, fast, tile_batch):
    """Pass 2 of the global modes: (1, H, W, 3) blended output. Runs under
    the span tile_pass2."""
    with span("tile_pass2"):
        out, wsum = _canvases(g.h, g.w, content.device)
        for y0s, x0s, _, wts in g.chunks(tile_batch, "wt", content.device):
            out, wsum = _stylize_chunk(weights, content, y0s, x0s, wts, t, b,
                                       out, wsum, cfg, g.th, g.tw, fast)
        return (out / wsum)[None]


@torch.no_grad()
def stylize_tiled(net, content, style, cfg: RevResNetConfig,
                  tile: int = 1024, overlap: int = 128,
                  eps: float = cwct.EPS_DEFAULT, fast_params=None,
                  tile_batch: int = TILE_BATCH):
    """Global-cWCT stylization of an arbitrarily large content image.

    net: the RevResNet; content (1, H, W, 3) float32 NHWC on its device (H
    and W multiples of cfg.down_scale); style (1, Hs, Ws, 3), encoded
    whole. Returns the raw decoder output (1, H, W, 3) float32 on the
    device (the caller clamps). fast_params routes the tiles through the
    fused kernel path. The content statistics are summed over the tiles
    in cwct._accumulate's dtype (float64 on a card, float32 on the CPU)
    and rounded to float32 once; the latent is float32 on either route."""
    _, h, w, _ = content.shape
    g = _TileGrid(h, w, cfg, tile, overlap)
    weights, fast = _pick_weights(net, fast_params)
    ls, mu_s = cwct.style_factors(_enc(weights, style, cfg, fast), eps)
    mean_c, cov_c = _content_stats(g, weights, content, cfg, fast,
                                   tile_batch)
    t, b = cwct.transform_from_stats(mean_c, cov_c, ls[0], mu_s[0], eps)
    return _global_pass(g, weights, content, t, b, cfg, fast, tile_batch)


@torch.no_grad()
def stylize_tiled_masked(net, content, style, cmask, smask,
                         cfg: RevResNetConfig, tile: int = 1024,
                         overlap: int = 128, max_labels: int = 32,
                         eps: float = cwct.EPS_DEFAULT,
                         min_pixels: float = cwct.MIN_PIXELS,
                         max_ratio: float = cwct.MAX_RATIO_RESEARCH,
                         fast_params=None, tile_batch: int = TILE_BATCH):
    """Regional (semantic-mask) stylization of an arbitrarily large image.

    Pass 1 sums per-label latent moments over the tiles' owned pixels, so
    the per-label transforms come from the same statistics as a
    whole-image masked transfer (summed in cwct.region_moments' dtype,
    float64 on a card, and rounded to float32 once); pass 2 applies each
    region's transform tile by tile, with the raised-cosine blend. cmask
    (1, H, W) int labels at content resolution, smask (1, Hs, Ws) at the
    style's. A content mask with more distinct labels than max_labels
    raises ValueError (size it with cwct.label_capacity)."""
    _, h, w, _ = content.shape
    g = _TileGrid(h, w, cfg, tile, overlap)
    weights, fast = _pick_weights(net, fast_params)
    sc = g.sc
    dev = content.device
    cmask = torch.as_tensor(cmask, device=dev)
    smask = torch.as_tensor(smask, device=dev)

    # dropping labels beyond max_labels would pass those regions' content
    # through: that must be the caller's choice, never a surprise
    n_distinct = int(torch.unique(cmask).numel())
    if n_distinct > max_labels:
        raise ValueError(
            f"content mask has {n_distinct} distinct labels > "
            f"max_labels={max_labels}; raise max_labels (e.g. "
            "cwct.label_capacity(mask)) or pre-merge the mask")
    labels = cwct._padded_labels(cmask, max_labels)
    cm_lat = resize_nearest(cmask, h // sc, w // sc)[0].to(torch.int32)

    z_s = _enc(weights, style, cfg, fast)[0]
    sm_lat = resize_nearest(smask, z_s.shape[0], z_s.shape[1])[0]
    style_moments = cwct.region_moments(z_s, sm_lat.to(torch.int32), labels)
    ns, mean_s, cov_s = cwct.stats_from_moments(*style_moments,
                                                dtype=torch.float32)

    with span("tile_pass1"):
        # the tile batches' moments add up in the style moments' dtype
        acc = tuple(torch.zeros_like(a) for a in style_moments)
        for y0s, x0s, owns, _ in g.chunks(tile_batch, "own", dev):
            acc = _moments_chunk_masked(weights, content, y0s, x0s, acc,
                                        owns, cm_lat, labels, cfg, g.th,
                                        g.tw, sc, fast)
        nc, mean_c, cov_c = cwct.stats_from_moments(*acc,
                                                    dtype=torch.float32)
    ts, bs, valids = cwct.region_transforms(
        labels, nc, mean_c, cov_c, ns, mean_s, cov_s, eps,
        float(min_pixels), max_ratio)

    with span("tile_pass2"):
        out, wsum = _canvases(h, w, dev)
        for y0s, x0s, _, wts in g.chunks(tile_batch, "wt", dev):
            out, wsum = _stylize_chunk_masked(
                weights, content, y0s, x0s, wts, cm_lat, labels, (ts, bs),
                valids, out, wsum, cfg, g.th, g.tw, sc, fast)
        return (out / wsum)[None]


@torch.no_grad()
def stylize_tiled_interp(net, content, styles, alpha_s,
                         cfg: RevResNetConfig, alpha_c: float = 0.0,
                         tile: int = 1024, overlap: int = 128,
                         eps: float = cwct.EPS_DEFAULT, fast_params=None,
                         tile_batch: int = TILE_BATCH):
    """Style interpolation (with the alpha_c content blend) at ultra
    resolution: mix_Ls = sum_i alpha_i Ls_i, blended with Lc by alpha_c,
    through the streaming tiler. One global transform, so only the content
    statistics stream. styles: a list of (1, Hs, Ws, 3) images; alpha_s
    (S,) weights."""
    _, h, w, _ = content.shape
    g = _TileGrid(h, w, cfg, tile, overlap)
    weights, fast = _pick_weights(net, fast_params)
    ls, mu = zip(*(cwct.style_factors(_enc(weights, s, cfg, fast), eps)
                   for s in styles))
    mix_ls, mix_mu = cwct.mix_factors(torch.cat(ls), torch.cat(mu), alpha_s)
    mean_c, cov_c = _content_stats(g, weights, content, cfg, fast,
                                   tile_batch)
    lc = cwct.robust_cholesky(cov_c, eps)
    mix_ls = mix_ls * (1.0 - alpha_c) + lc * alpha_c
    mix_mu = mix_mu * (1.0 - alpha_c) + mean_c * alpha_c
    t, b = cwct.transform_from_stats(mean_c, cov_c, mix_ls, mix_mu, eps)
    return _global_pass(g, weights, content, t, b, cfg, fast, tile_batch)


def ownership_check(h: int, w: int, cfg, tile: int, overlap: int) -> bool:
    """Whether every latent pixel is owned by exactly one tile."""
    ds = cfg.down_scale
    tile = max(min(tile, max(h, w)) - min(tile, max(h, w)) % ds, ds)
    th, tw = min(tile, h), min(tile, w)
    overlap = max(overlap - overlap % ds, ds)
    sh, sw = max(th - 2 * overlap, ds), max(tw - 2 * overlap, ds)
    sc = cfg.latent_scale
    cover = np.zeros((h // sc, w // sc), np.int32)
    ys, xs = _starts(h, th, sh), _starts(w, tw, sw)
    for iy, y0 in enumerate(ys):
        for ix, x0 in enumerate(xs):
            oy0 = 0 if iy == 0 else overlap // sc
            oy1 = th // sc if iy == len(ys) - 1 else (
                (ys[iy + 1] - y0) // sc + overlap // sc)
            ox0 = 0 if ix == 0 else overlap // sc
            ox1 = tw // sc if ix == len(xs) - 1 else (
                (xs[ix + 1] - x0) // sc + overlap // sc)
            cover[y0 // sc + oy0:y0 // sc + oy1,
                  x0 // sc + ox0:x0 // sc + ox1] += 1
    return bool((cover == 1).all())
