"""Cholesky whitening-coloring transfer (cWCT), global and regional.

Counterpart of vstnet_tpu/models/cwct.py (robust_cholesky, the global
transfer, multi-style interpolation, the precomputed style factors and
their packed-latent forms, the transform from streamed statistics that
the ultra-resolution tiler uses, and the regional transfer under semantic
masks at the end of the file). The
whole transform is one per-sample (or per-region) product y = T x + b with
T = Ls Lc^{-1} and b = mu_s - T mu_c.

Every global function works on a (B, G, C, N) view of the latent: the
packed NCHW latent (B, G*C, h, w) of encode_fast(packed_latent=True) is a
free reshape to it, and an NHWC latent (B, H, W, C) is its G = 1 case.

Precision: statistics, Cholesky factors and transforms are float32 with
TF32 off, even when the latent is bf16 (float64 on a float64 latent, for
reference runs: ops.at_least_f32); the statistics are summed in float64
on a CUDA card and in an exported program, and rounded once
(_accumulate); the apply sums in float32 and rounds once to the latent's
dtype. The global transfer has no hand-written kernel: its 32x32
statistics, the Cholesky, the triangular solve and the apply product are
torch ops. The regional transfer's two passes over the rows, the
per-label moments and the per-label apply, run as two kernels on a CUDA
card (ops/regions.py, csrc/regions.cu) for a bf16 or float32 latent 32 or
128 channels wide, a whole batch of frames a launch; everywhere else, and
as the kernels' reference, they run as the torch loops region_moments_plain
and apply_regions_plain. The 32x32 factorisations between them are torch
ops, batched over the frames.
"""

from __future__ import annotations

import contextlib

import torch

from vstnet_tpu_torch.ops import at_least_f32, regions

EPS_DEFAULT = 2e-5


@contextlib.contextmanager
def true_f32_matmul():
    """Clear torch.backends.cuda.matmul.allow_tf32 for the block and
    restore it after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _jitter_ladder(cov, eps: float, attempts: int):
    """(first finite factor, whether one was found) among the Cholesky
    factors of cov + s * eps * I for s = 0, 1, 2, 4, ..., in cov's dtype."""
    c = cov.shape[-1]
    eye = torch.eye(c, dtype=cov.dtype, device=cov.device)
    scales = torch.cat([
        torch.zeros(1, dtype=cov.dtype, device=cov.device),
        2.0 ** torch.arange(attempts - 1, dtype=cov.dtype,
                            device=cov.device)]) * eps
    cands = cov.unsqueeze(-3) + scales[:, None, None] * eye
    ls, info = torch.linalg.cholesky_ex(cands)
    ok = (info == 0) & torch.isfinite(ls).all(dim=-1).all(dim=-1)
    idx = torch.argmax(ok.to(torch.int32), dim=-1)
    l = torch.take_along_dim(ls, idx[..., None, None, None], dim=-3)
    return l.squeeze(-3), ok.any(dim=-1)


def robust_cholesky(cov, eps: float = EPS_DEFAULT, attempts: int = 8,
                    use_double: bool = False):
    """First finite Cholesky factor among escalating diagonal jitters
    (0, eps, 2 eps, 4 eps, ...) of cov (..., C, C).

    A candidate passes when cholesky_ex reports info == 0 and the factor is
    finite. If none passes, the result is NaN and poisons the output
    (host_check_finite detects it). All on the device: no host sync.

    use_double=True retries a factor that failed every jitter in float64,
    with the same ladder (at least 8 steps), and rounds the result back to
    cov's dtype. The JAX package runs that retry on the host, as a TPU has
    no float64 units; the card has them, so it stays on the device."""
    l, good = _jitter_ladder(cov, eps, attempts)
    if use_double:
        l64, good64 = _jitter_ladder(cov.double(), eps, max(attempts, 8))
        l64 = l64.to(cov.dtype)
        good64 = good64 & torch.isfinite(l64).all(dim=-1).all(dim=-1)
        l = torch.where(good[..., None, None], l, l64)
        good = good | good64
    return torch.where(good[..., None, None], l,
                       torch.full_like(l, float("nan")))


def host_check_finite(x, what: str = "stylized output"):
    """Raise FloatingPointError if x holds a non-finite value (a failed
    Cholesky poisons its output with NaN). One bool crosses to the host."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(
            f"Cholesky decomposition failed: non-finite {what} "
            "(degenerate feature covariance survived eps escalation)")
    return x


def _inv_lower(l):
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye.expand_as(l), upper=False)


def _accumulate(x):
    """The dtype the statistics of x (float32 or float64) are summed in:
    float64 for float32 on a CUDA card or while torch.export traces, x's
    own otherwise. Used by the global statistics (_stats, row_stats), the
    regional moments (region_moments: the masked transfers and the tiler's
    per-label pass) and the global tiler's pass 1 (models/ultra.py). The
    export rule: the device test is a Python branch that torch.export
    fixes when it traces, and a program traced on the CPU runs on the card
    once load_exported or native.package_program moves it there, so an
    exported program sums in float64 wherever it was traced (a program
    traced and run on the CPU sums in float64 too; eager CPU code keeps
    float32). The card's float32 Gram over the pixels (cuBLAS, one chain
    along them) lies ~20x further from float64 than the CPU's (4.2e-6
    against 2.0e-7 of its max at 32 channels and 1024 pixels), and the
    Cholesky factors and their inverse carry that times the covariance's
    condition number (~6e3 at the first cWCT of chip_smoke.py's
    float32-vs-float64 training batch) into the transfer and the training
    step's gradient (scripts/torch_cwct_f32_card.py). The regional
    covariances, formed from raw moments as Gram - n mean mean^T, lay up
    to 1.5e-6 of their max from float64 when summed in float32 on the
    card (tests/test_torch_cuda.py::
    test_region_statistics_on_card_match_float64)."""
    if x.dtype == torch.float32 and (x.device.type == "cuda"
                                     or torch.compiler.is_exporting()):
        return torch.float64
    return x.dtype


def _stats(x):
    """x: (B, G, C, N) -> mean (B, C), covariance (B, C, C) with /(n-1),
    in float32 (float64 for a float64 x), summed in _accumulate(x) and
    rounded once."""
    x = at_least_f32(x)
    out = x.dtype
    x = x.to(_accumulate(x))
    b, g, c, n = x.shape
    mean = x.mean(dim=(1, 3))
    xc = (x - mean[:, None, :, None]).transpose(1, 2).reshape(b, c, g * n)
    cov = torch.bmm(xc, xc.transpose(1, 2)) / (g * n - 1)
    return mean.to(out), cov.to(out)


def _factors(x, eps, use_double: bool = False):
    with true_f32_matmul():
        mean, cov = _stats(x)
        return robust_cholesky(cov, eps, use_double=use_double), mean


def _transfer(x, ls, mu_s, eps, alpha_c=None, use_double: bool = False):
    """Global transfer of x (B, G, C, N) against style factors (ls, mu_s),
    which may have batch 1 to broadcast over x's batch. alpha_c blends the
    content factor in (interpolation): Ls' = Ls (1-a) + Lc a, likewise the
    means."""
    bsz = x.shape[0]
    with true_f32_matmul():
        mean, cov = _stats(x)
        lc = robust_cholesky(cov, eps, use_double=use_double)
        wd = mean.dtype
        ls = ls.to(wd).expand(bsz, *ls.shape[1:])
        mu = mu_s.to(wd).expand(bsz, *mu_s.shape[1:])
        if alpha_c is not None:
            # a float stays a 0-d tensor on the host, which the device ops
            # take as a scalar: a copy to the card would be a blocking one
            # (the host would wait for the device to drain its stream)
            a = torch.as_tensor(alpha_c, dtype=wd)
            ls = ls * (1.0 - a) + lc * a
            mu = mu * (1.0 - a) + mean * a
        t = ls @ _inv_lower(lc)
        b = mu - (t @ mean[..., None])[..., 0]
        t = t.to(x.dtype).to(wd)
        y = torch.matmul(t[:, None], x.to(wd)) + b[:, None, :, None]
    return y.to(x.dtype)


def _gcn(zp, c: int):
    b, k, h, w = zp.shape
    return zp.reshape(b, k // c, c, h * w)


def _nhwc_as_gcn(feat):
    b, h, w, c = feat.shape
    return feat.reshape(b, h * w, c).transpose(1, 2)[:, None]


def _gcn_as_nhwc(x, shape):
    return x[:, 0].transpose(1, 2).reshape(shape)


# ---------------------------------------------------------------------------
# Packed latent (B, G*C, h, w): the video fast path
# ---------------------------------------------------------------------------

def style_factors_packed(zp, c: int, eps: float = EPS_DEFAULT):
    """(Ls (B, C, C), mu_s (B, C)) from a packed NCHW latent."""
    return _factors(_gcn(zp, c), eps)


def transfer_with_factors_packed(zp, ls, mu_s, c: int,
                                 eps: float = EPS_DEFAULT):
    """Global transfer on a packed latent against precomputed factors."""
    return _transfer(_gcn(zp, c), ls, mu_s, eps).reshape(zp.shape)


def interp_with_factors_packed(zp, mix_ls, mix_mu, alpha_c, c: int,
                               eps: float = EPS_DEFAULT):
    """Style interpolation on a packed latent: the style factors blended
    with each frame's content factor by alpha_c (a float or a 0-d tensor).
    At alpha_c == 0 this is transfer_with_factors_packed."""
    return _transfer(_gcn(zp, c), mix_ls, mix_mu, eps,
                     alpha_c=alpha_c).reshape(zp.shape)


# ---------------------------------------------------------------------------
# NHWC latent (B, H, W, C): the standard path
# ---------------------------------------------------------------------------

def style_factors(style_feat, eps: float = EPS_DEFAULT,
                  use_double: bool = False):
    """style_feat (B, H, W, C) -> (Ls (B, C, C), mu_s (B, C))."""
    return _factors(_nhwc_as_gcn(style_feat), eps, use_double)


def transfer_with_factors(content_feat, ls, mu_s, eps: float = EPS_DEFAULT,
                          use_double: bool = False):
    """Global transfer of an NHWC latent against precomputed factors."""
    y = _transfer(_nhwc_as_gcn(content_feat), ls, mu_s, eps,
                  use_double=use_double)
    return _gcn_as_nhwc(y, content_feat.shape)


def interp_with_factors(content_feat, mix_ls, mix_mu, alpha_c,
                        eps: float = EPS_DEFAULT):
    """interp_with_factors_packed on an NHWC latent."""
    y = _transfer(_nhwc_as_gcn(content_feat), mix_ls, mix_mu, eps,
                  alpha_c=alpha_c)
    return _gcn_as_nhwc(y, content_feat.shape)


def transfer(content_feat, style_feat, eps: float = EPS_DEFAULT,
             use_double: bool = False):
    """Global cWCT of content (B, Hc, Wc, C) by style (B or 1, Hs, Ws, C),
    computed in float32 (float64 on float64 features) and returned in the
    content's dtype. use_double retries failed factorizations in float64
    (robust_cholesky). Differentiable: the training step backpropagates
    through the statistics, the Cholesky and the solve."""
    ls, mu = style_factors(at_least_f32(style_feat), eps, use_double)
    return transfer_with_factors(at_least_f32(content_feat), ls, mu, eps,
                                 use_double).to(content_feat.dtype)


# ---------------------------------------------------------------------------
# Row shards: an NHWC latent split over rows onto several devices
# (parallel/halo.py, parallel/sharding.py with spatial=True)
# ---------------------------------------------------------------------------

def row_stats(shards):
    """Mean (B, C) and covariance (B, C, C) with /(n-1) of the NHWC latent
    that `shards` (row shards in order, one a device) make up, on the
    first shard's device. Two passes, as the JAX package's _feat_stats
    runs under GSPMD: the shards' sums, added on the first device, give
    the mean; each shard's Gram of its pixels centred on that mean, added
    there, gives the covariance. float32 with TF32 off (float64 for
    float64 shards), summed in _accumulate of the first shard, as _stats
    sums the whole latent; n is summed from the shapes on the host."""
    dev = shards[0].device
    n = sum(s.shape[1] * s.shape[2] for s in shards)
    out = at_least_f32(shards[0]).dtype
    acc = _accumulate(at_least_f32(shards[0]))
    xs = [s.to(acc).reshape(s.shape[0], -1, s.shape[-1]) for s in shards]
    with true_f32_matmul():
        total = xs[0].sum(dim=1)
        for x in xs[1:]:
            total = total + x.sum(dim=1).to(dev, non_blocking=True)
        mean = total / n
        gram = None
        for x in xs:
            xc = x - mean.to(x.device, non_blocking=True)[:, None]
            g = torch.bmm(xc.transpose(1, 2), xc).to(dev, non_blocking=True)
            gram = g if gram is None else gram + g
    return mean.to(out), (gram / (n - 1)).to(out)


def style_factors_rows(shards, eps: float = EPS_DEFAULT):
    """style_factors of the NHWC latent that the row shards make up:
    (Ls (B, C, C), mu_s (B, C)) from row_stats, on the first shard's
    device."""
    with true_f32_matmul():
        mean, cov = row_stats(shards)
        return robust_cholesky(cov, eps), mean


def transfer_rows(shards, ls, mu_s, eps: float = EPS_DEFAULT):
    """transfer_with_factors of the NHWC latent that the row shards make
    up, as row shards: the content's statistics reduced over the shards
    (row_stats), the transform (T, b) made once a sample on the first
    shard's device (transform_from_stats), copied to every shard and
    applied there (apply_transform). ls and mu_s (batch B or 1) lie on the
    first shard's device."""
    mean, cov = row_stats(shards)
    bsz = mean.shape[0]
    ls = ls.expand(bsz, *ls.shape[1:])
    mu_s = mu_s.expand(bsz, *mu_s.shape[1:])
    t, b = map(torch.stack, zip(*(
        transform_from_stats(mean[i], cov[i], ls[i], mu_s[i], eps)
        for i in range(bsz))))
    out = []
    for s in shards:
        tk = t.to(s.device, non_blocking=True)
        bk = b.to(s.device, non_blocking=True)
        out.append(torch.cat([apply_transform(s[i:i + 1], tk[i], bk[i])
                              for i in range(bsz)]))
    return out


# ---------------------------------------------------------------------------
# Streaming statistics: the ultra-resolution tiler (models/ultra.py)
# ---------------------------------------------------------------------------

def transform_from_stats(mean_c, cov_c, ls, mu_s, eps: float = EPS_DEFAULT):
    """(T (C, C), b (C,)) of the global transfer from precomputed content
    statistics and style factors: T = Ls Lc^{-1}, b = mu_s - T mu_c, in
    float32 with TF32 off (float64 for float64 statistics). The
    statistics may come from moments summed over tiles (models/ultra.py)
    or from row shards (row_stats)."""
    with true_f32_matmul():
        lc = robust_cholesky(at_least_f32(cov_c), eps)
        t = ls.to(lc.dtype) @ _inv_lower(lc)
        b = mu_s.to(lc.dtype) - t @ mean_c.to(lc.dtype)
    return t, b


def apply_transform(feat, t, b):
    """y = x T^T + b on every pixel of an NHWC latent, summed in float32
    (TF32 off; float64 for a float64 latent) and returned in the latent's
    dtype."""
    shape = feat.shape
    x = at_least_f32(feat.reshape(-1, shape[-1]))
    with true_f32_matmul():
        y = x @ t.to(x.dtype).t() + b.to(x.dtype)
    return y.reshape(shape).to(feat.dtype)


def mix_factors(ls, mu, alpha_s):
    """(sum_i alpha_i Ls_i, sum_i alpha_i mu_i) over the leading (style)
    axis of ls (S, ..., C, C) and mu (S, ..., C), in float32."""
    a = torch.as_tensor(alpha_s, dtype=torch.float32, device=ls.device)
    with true_f32_matmul():
        return (torch.tensordot(a, ls.float(), dims=1),
                torch.tensordot(a, mu.float(), dims=1))


def interpolation(content_feat, style_feats, alpha_s, alpha_c=0.0,
                  eps: float = EPS_DEFAULT, use_double: bool = False):
    """Multi-style interpolation. content_feat (B, H, W, C); style_feats
    (S, B or 1, Hs, Ws, C) or a list of S (B or 1, Hs, Ws, C) latents;
    alpha_s (S,) weights. Per frame the style factors are mixed,
    mix_Ls = sum_i alpha_i Ls_i and mix_mu = sum_i alpha_i mu_i, blended
    with the content's by alpha_c (Ls' = mix_Ls (1 - a) + Lc a, likewise
    the means) and applied as T = Ls' Lc^{-1}. Batch-1 styles broadcast
    over the content's batch. Statistics in float32 with TF32 off; the
    result is in the content's dtype."""
    if isinstance(style_feats, (list, tuple)):
        style_feats = torch.stack(list(style_feats))
    s, bs = style_feats.shape[:2]
    ls, mu = style_factors(style_feats.reshape(s * bs,
                                               *style_feats.shape[2:])
                           .float(), eps, use_double)
    mix_ls, mix_mu = mix_factors(ls.reshape(s, bs, *ls.shape[1:]),
                                 mu.reshape(s, bs, -1), alpha_s)
    y = _transfer(_nhwc_as_gcn(content_feat.float()), mix_ls, mix_mu, eps,
                  alpha_c=alpha_c, use_double=use_double)
    return _gcn_as_nhwc(y, content_feat.shape).to(content_feat.dtype)


# ---------------------------------------------------------------------------
# Regional (masked) transfer: the same transform per semantic region
# ---------------------------------------------------------------------------
#
# Counterpart of the regional part of vstnet_tpu/models/cwct.py. Pixels are
# rows here: x (N, C) with a label per row, or a batch of frames (B, N, C).
# K is the region capacity: the label list is the sorted distinct labels
# padded with -1 to K. The sums are taken in _accumulate's dtype: float32 on
# the CPU (the JAX package's), float64 on a CUDA card and in an exported
# program. On a card, a bf16 or float32 latent of 32 or 128 channels goes to
# the two kernels of ops/regions.py (regions.takes): the per-label moments,
# each row added to its own slot alone, and the apply, each row under its own
# slot's transform, a batch of frames a launch. Everywhere else (the CPU,
# other widths and dtypes, torch.export) the same sums run as the plain
# loops, which the card tests also hold the kernels to: region_moments_plain,
# the JAX package's (chunk, K, C) one-hot scans as one batched matmul per
# chunk of pixels, (K*C, chunk) @ (chunk, C), with TF32 off, and
# apply_regions_plain, every label's transform on a chunk and one taken. A
# bf16 latent holds bf16 values and its products are exact in either dtype,
# so bf16 moments equal float32 moments of the same values up to the order of
# the sums.

MIN_PIXELS = 10
MAX_RATIO_RESEARCH = 100.0
LABEL_BUCKETS = (8, 16, 32, 64, 150)
# pixels per matmul of the apply and of float32 moments: bounds the
# (chunk, K*C) intermediate to 128 MiB at K = C = 32 (region_moments scales
# it down for a wider dtype, keeping the bytes)
REGION_CHUNK = 32768


def label_capacity(*masks) -> int:
    """Smallest capacity bucket covering every distinct label of the given
    masks (host side: one sync per mask)."""
    n = 1
    for m in masks:
        if m is not None:
            n = max(n, int(torch.unique(torch.as_tensor(m)).numel()))
    for b in LABEL_BUCKETS:
        if b >= n:
            return b
    return n


def _padded_labels(mask, k: int):
    """The first k sorted distinct labels of mask, padded with -1 (host
    side: torch.unique syncs)."""
    u = torch.unique(mask.reshape(-1))[:k].to(torch.int32)
    pad = torch.full((k - u.numel(),), -1, dtype=torch.int32,
                     device=mask.device)
    return torch.cat([u, pad])


def _chunks(n: int, chunk: int):
    return [(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def region_moments(x, m, labels, chunk=None):
    """Per-label raw moments of x (..., N, C) under labels m (..., N):
    counts (K,), sums (K, C), gram (K, C, C), summed over every row in
    _accumulate of x in at least float32 (float32 for a float32 or bf16 x
    on the CPU, float64 on a CUDA card or for a float64 x) and returned in
    that dtype: stats_from_moments rounds the statistics once. Raw moments,
    not means and covariances, so that a caller can add them up over
    several passes (the tiler's tiles, models/ultra.py) before
    stats_from_moments. Leading dims are rows too: a batch of tiles gives
    the sum of the JAX package's batched=True moments over its tiles.
    The kernel where regions.takes(x), else region_moments_plain (chunk:
    its rows per matmul)."""
    if regions.takes(x):
        c = x.shape[-1]
        cnt, sm, gm = regions.region_moments(x.reshape(1, -1, c),
                                             m.reshape(1, -1), labels)
        return cnt[0], sm[0], gm[0]
    return region_moments_plain(x, m, labels, chunk)


def frame_moments(x, m, labels):
    """region_moments of each frame of x (B, N, C) under m (B, N), stacked:
    counts (B, K), sums (B, K, C), gram (B, K, C, C). labels (K,) serves
    every frame, (B, K) gives each its own. One kernel launch where
    regions.takes(x), else region_moments_plain frame by frame."""
    if regions.takes(x):
        return regions.region_moments(x, m, labels)
    return tuple(map(torch.stack, zip(*(
        region_moments_plain(x[i], m[i], _frame(labels, i))
        for i in range(x.shape[0])))))


def _frame(t, i):
    """Frame i's label table: labels (K,) are shared, (B, K) are not."""
    return t[i] if t.dim() == 2 else t


def region_moments_plain(x, m, labels, chunk=None):
    """region_moments as torch loops, the one-hot form: chunk rows per
    matmul, by default REGION_CHUNK float32 rows' bytes (32768 rows in
    float32, 16384 in float64)."""
    c = x.shape[-1]
    x, m = x.reshape(-1, c), m.reshape(-1)
    n = x.shape[0]
    k = labels.shape[0]
    acc = _accumulate(at_least_f32(x[:0]))    # dtype and device only
    if chunk is None:
        chunk = REGION_CHUNK * 4 // acc.itemsize
    cnt = torch.zeros((k,), dtype=acc, device=x.device)
    sm = torch.zeros((k, c), dtype=acc, device=x.device)
    gm = torch.zeros((k * c, c), dtype=acc, device=x.device)
    with true_f32_matmul():
        for lo, hi in _chunks(n, chunk):
            xf = x[lo:hi].to(acc)
            w = (m[lo:hi, None] == labels[None, :]).to(acc)      # (n, K)
            cnt += w.sum(dim=0)
            sm += w.t() @ xf
            xw = (w[:, :, None] * xf[:, None, :]).reshape(hi - lo, k * c)
            gm += xw.t() @ xf
    return cnt, sm, gm.reshape(k, c, c)


def stats_from_moments(cnt, sm, gm, dtype=None):
    """(counts, sums, gram) -> (counts, means, covariances) with /(n - 1)
    and the divisors clamped for empty regions, formed in the moments'
    dtype (the subtraction Gram - n mean mean^T cancels digits) and
    rounded once to `dtype` when it is given. Any leading batch dims."""
    means = sm / cnt.clamp(min=1.0)[..., None]
    covs = (gm - cnt[..., None, None] * means[..., :, None]
            * means[..., None, :]) / (cnt.clamp(min=2.0) - 1.0)[..., None,
                                                                 None]
    if dtype is None:
        return cnt, means, covs
    return cnt.to(dtype), means.to(dtype), covs.to(dtype)


def _region_stats(x, m, labels):
    """Per-label (counts, means, covariances) of x (N, C) in float32
    (float64 for a float64 x), summed in region_moments' dtype and rounded
    once."""
    return stats_from_moments(*region_moments(x, m, labels),
                              dtype=at_least_f32(x[:0]).dtype)


def _frame_stats(x, m, labels):
    """_region_stats of each frame of x (B, N, C), stacked (frame_moments)."""
    return stats_from_moments(*frame_moments(x, m, labels),
                              dtype=at_least_f32(x[:0]).dtype)


def region_transforms(labels, nc, mean_c, cov_c, ns, mean_s, cov_s,
                      eps: float = EPS_DEFAULT,
                      min_pixels: float = MIN_PIXELS,
                      max_ratio: float = MAX_RATIO_RESEARCH):
    """Per-label (T (K, C, C), b (K, C), valid (K,)) from per-label content
    and style statistics: T = Ls Lc^{-1}, b = mu_s - T mu_c; a region is
    valid when its label is real, both sides hold more than min_pixels and
    their area ratio is bounded by max_ratio. Leading dims broadcast: a
    batch of frames' statistics (B, K, ...) against one style's (K, ...)
    gives (B, K, ...) in one call."""
    valids = ((labels >= 0) & (nc > min_pixels) & (ns > min_pixels)
              & (nc < max_ratio * ns) & (ns < max_ratio * nc))
    with true_f32_matmul():
        lc = robust_cholesky(cov_c, eps)
        ls = robust_cholesky(cov_s, eps)
        ts = ls @ _inv_lower(lc)
        bs = mean_s - (ts @ mean_c[..., None])[..., 0]
    return ts, bs, valids


def apply_regions(x, m, labels, ts, bs, valids):
    """y_n = T_{label(n)} x_n + b_{label(n)} for rows in valid regions;
    rows of any other label keep their content. x (N, C) with ts (K, C, C),
    bs (K, C), valids (K,), or a batch of frames x (B, N, C) with ts
    (B, K, C, C), bs (B, K, C), valids (B, K) and labels (K,) or (B, K);
    the product sums in float32 over x's values and T rounded to x's
    dtype, and is rounded once to x's dtype. One kernel launch where
    regions.takes(x), else apply_regions_plain frame by frame."""
    if x.dim() == 2:
        return apply_regions(x[None], m[None], labels, ts[None], bs[None],
                             valids[None])[0]
    if regions.takes(x):
        return regions.apply_regions(x, m, labels, ts, bs, valids)
    return torch.stack([
        apply_regions_plain(x[i], m[i], _frame(labels, i), ts[i], bs[i],
                            valids[i]) for i in range(x.shape[0])])


def apply_regions_plain(x, m, labels, ts, bs, valids,
                        chunk: int = REGION_CHUNK):
    """apply_regions of x (N, C) as torch loops: every label's transform
    on a chunk of rows, the row's own taken."""
    n, c = x.shape
    k = labels.shape[0]
    t_all = ts.to(x.dtype).float().reshape(k * c, c)
    out = torch.empty_like(x)
    with true_f32_matmul():
        for lo, hi in _chunks(n, chunk):
            xc = x[lo:hi]
            sel = (m[lo:hi, None] == labels[None, :]) & valids[None, :]
            idx = sel.to(torch.int32).argmax(dim=1)
            z = (xc.float() @ t_all.t()).reshape(hi - lo, k, c)
            y = torch.take_along_dim(z, idx[:, None, None], dim=1)[:, 0]
            y = (y + bs[idx]).to(x.dtype)
            out[lo:hi] = torch.where(sel.any(dim=1)[:, None], y, xc)
    return out


def _rows(feat):
    return feat.reshape(feat.shape[0], -1, feat.shape[-1])


def _regional_dtype(*feats):
    """bf16 only when every latent is bf16; float32 otherwise."""
    if all(f.dtype == torch.bfloat16 for f in feats):
        return torch.bfloat16
    return torch.float32


def transfer_masked(content_feat, style_feat, cmask, smask,
                    eps: float = EPS_DEFAULT, max_labels: int = 32,
                    min_pixels: int = MIN_PIXELS,
                    max_ratio: float = MAX_RATIO_RESEARCH):
    """Regional cWCT under semantic masks. content_feat (B, Hc, Wc, C)
    with cmask (B, Hc, Wc) int labels >= 0, style likewise. Each region of
    the content takes the statistics of the style's region of the same
    label; rows whose label fails the validity rule keep their content.
    max_labels is the region capacity K (the first K distinct labels)."""
    dt = _regional_dtype(content_feat, style_feat)
    xc, xs = _rows(content_feat).to(dt), _rows(style_feat).to(dt)
    cm = cmask.reshape(cmask.shape[0], -1).to(torch.int32)
    sm = smask.reshape(smask.shape[0], -1).to(torch.int32)
    labels = torch.stack([_padded_labels(cm[i], max_labels)
                          for i in range(cm.shape[0])])
    ts, bs, valids = region_transforms(
        labels, *_frame_stats(xc, cm, labels), *_frame_stats(xs, sm, labels),
        eps, float(min_pixels), max_ratio)
    out = apply_regions(xc, cm, labels, ts, bs, valids)
    return out.reshape(content_feat.shape).to(content_feat.dtype)


def style_region_factors(style_feat, smask, max_labels: int = 32):
    """Per-label style statistics, computed once for a fixed style.

    style_feat (1, H, W, C) latent; smask (1, H, W) int labels (already
    self-remapped). Returns (labels (K,), ns (K,), mean_s (K, C),
    cov_s (K, C, C)), in float32. The label set is the style's distinct
    labels: after cross_remapping every content label lies in it."""
    xs = _rows(style_feat)[0].float()
    sm = smask.reshape(-1).to(torch.int32)
    labels = _padded_labels(sm, max_labels)
    ns, mean_s, cov_s = _region_stats(xs, sm, labels)
    return labels, ns, mean_s, cov_s


def transfer_masked_factored(content_feat, cmask, labels, ns, mean_s, cov_s,
                             eps: float = EPS_DEFAULT,
                             min_pixels: int = MIN_PIXELS,
                             max_ratio: float = MAX_RATIO_RESEARCH):
    """Regional cWCT against precomputed per-label style statistics
    (style_region_factors). Equal to transfer_masked whenever every content
    label appears in `labels`. content_feat (B, H, W, C); cmask (B, H, W);
    the style-side tensors are shared across the batch. No host sync. The
    frames' moments, their transforms and the apply each run once for the
    whole batch."""
    xc = _rows(content_feat)
    if xc.dtype not in (torch.float32, torch.bfloat16):
        xc = xc.float()
    cm = cmask.reshape(cmask.shape[0], -1).to(torch.int32)
    ts, bs, valids = region_transforms(
        labels, *_frame_stats(xc, cm, labels), ns, mean_s, cov_s, eps,
        float(min_pixels), max_ratio)
    out = apply_regions(xc, cm, labels, ts, bs, valids)
    return out.reshape(content_feat.shape).to(content_feat.dtype)
