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
reference runs: ops.at_least_f32); the apply sums in float32 and
rounds once to the latent's dtype. There is no hand-written kernel here:
the 32x32 statistics, the Cholesky, the triangular solve and the apply
product are torch ops.
"""

from __future__ import annotations

import contextlib

import torch

from vstnet_tpu_torch.ops import at_least_f32

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


def _stats(x):
    """x: (B, G, C, N) -> mean (B, C), covariance (B, C, C) with /(n-1),
    in float32 (float64 for a float64 x)."""
    x = at_least_f32(x)
    b, g, c, n = x.shape
    mean = x.mean(dim=(1, 3))
    xc = (x - mean[:, None, :, None]).transpose(1, 2).reshape(b, c, g * n)
    cov = torch.bmm(xc, xc.transpose(1, 2)) / (g * n - 1)
    return mean, cov


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
            a = torch.as_tensor(alpha_c, dtype=wd, device=x.device)
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
# Streaming statistics: the ultra-resolution tiler (models/ultra.py)
# ---------------------------------------------------------------------------

def transform_from_stats(mean_c, cov_c, ls, mu_s, eps: float = EPS_DEFAULT):
    """(T (C, C), b (C,)) of the global transfer from precomputed content
    statistics and style factors: T = Ls Lc^{-1}, b = mu_s - T mu_c, in
    float32 with TF32 off. The statistics may come from moments summed
    over tiles (models/ultra.py)."""
    with true_f32_matmul():
        lc = robust_cholesky(cov_c.float(), eps)
        t = ls.float() @ _inv_lower(lc)
        b = mu_s.float() - t @ mean_c.float()
    return t, b


def apply_transform(feat, t, b):
    """y = x T^T + b on every pixel of an NHWC latent, summed in float32
    (TF32 off) and returned in the latent's dtype."""
    shape = feat.shape
    x = feat.reshape(-1, shape[-1]).float()
    with true_f32_matmul():
        y = x @ t.float().t() + b.float()
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
# rows here: x (N, C) with a label per row. K is the region capacity: the
# label list is the sorted distinct labels padded with -1 to K. The JAX
# package scans (chunk, K, C) one-hot products; here the same sums are one
# batched matmul per chunk of pixels, (K*C, chunk) @ (chunk, C), in float32
# with TF32 off. A bf16 latent holds bf16 values, its one-hot products are
# exact, and the float32 accumulation is the one the JAX package asks of
# its bf16 contraction, so bf16 moments equal float32 moments of the same
# values up to the order of the sums.

MIN_PIXELS = 10
MAX_RATIO_RESEARCH = 100.0
LABEL_BUCKETS = (8, 16, 32, 64, 150)
# pixels per matmul of the moments and the apply: bounds the (chunk, K*C)
# float32 intermediate (128 MiB at K = C = 32)
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


def region_moments(x, m, labels, chunk: int = REGION_CHUNK):
    """Per-label raw moments of x (..., N, C) under labels m (..., N):
    counts (K,), sums (K, C), gram (K, C, C), float32, summed over every
    row. Raw moments, not means and covariances, so that a caller can add
    them up over several passes (the tiler's tiles, models/ultra.py) before
    stats_from_moments. Leading dims are rows too: a batch of tiles gives
    the sum of the JAX package's batched=True moments over its tiles."""
    c = x.shape[-1]
    x, m = x.reshape(-1, c), m.reshape(-1)
    n = x.shape[0]
    k = labels.shape[0]
    cnt = torch.zeros((k,), dtype=torch.float32, device=x.device)
    sm = torch.zeros((k, c), dtype=torch.float32, device=x.device)
    gm = torch.zeros((k * c, c), dtype=torch.float32, device=x.device)
    with true_f32_matmul():
        for lo, hi in _chunks(n, chunk):
            xf = x[lo:hi].float()
            w = (m[lo:hi, None] == labels[None, :]).float()      # (n, K)
            cnt += w.sum(dim=0)
            sm += w.t() @ xf
            xw = (w[:, :, None] * xf[:, None, :]).reshape(hi - lo, k * c)
            gm += xw.t() @ xf
    return cnt, sm, gm.reshape(k, c, c)


def stats_from_moments(cnt, sm, gm):
    """(counts, sums, gram) -> (counts, means, covariances) with /(n - 1)
    and the divisors clamped for empty regions. Any leading batch dims."""
    means = sm / cnt.clamp(min=1.0)[..., None]
    covs = (gm - cnt[..., None, None] * means[..., :, None]
            * means[..., None, :]) / (cnt.clamp(min=2.0) - 1.0)[..., None,
                                                                 None]
    return cnt, means, covs


def _region_stats(x, m, labels):
    return stats_from_moments(*region_moments(x, m, labels))


def region_transforms(labels, nc, mean_c, cov_c, ns, mean_s, cov_s,
                      eps: float = EPS_DEFAULT,
                      min_pixels: float = MIN_PIXELS,
                      max_ratio: float = MAX_RATIO_RESEARCH):
    """Per-label (T (K, C, C), b (K, C), valid (K,)) from per-label content
    and style statistics: T = Ls Lc^{-1}, b = mu_s - T mu_c; a region is
    valid when its label is real, both sides hold more than min_pixels and
    their area ratio is bounded by max_ratio."""
    valids = ((labels >= 0) & (nc > min_pixels) & (ns > min_pixels)
              & (nc < max_ratio * ns) & (ns < max_ratio * nc))
    with true_f32_matmul():
        lc = robust_cholesky(cov_c, eps)
        ls = robust_cholesky(cov_s, eps)
        ts = ls @ _inv_lower(lc)
        bs = mean_s - (ts @ mean_c[..., None])[..., 0]
    return ts, bs, valids


def apply_regions(x, m, labels, ts, bs, valids, chunk: int = REGION_CHUNK):
    """y_n = T_{label(n)} x_n + b_{label(n)} for rows in valid regions;
    rows of any other label keep their content. x (N, C); the product sums
    in float32 over x's values and T rounded to x's dtype, and is rounded
    once to x's dtype."""
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
    out = torch.empty_like(xc)
    for i in range(xc.shape[0]):
        labels = _padded_labels(cm[i], max_labels)
        nc, mean_c, cov_c = _region_stats(xc[i], cm[i], labels)
        ns, mean_s, cov_s = _region_stats(xs[i], sm[i], labels)
        ts, bs, valids = region_transforms(
            labels, nc, mean_c, cov_c, ns, mean_s, cov_s, eps,
            float(min_pixels), max_ratio)
        out[i] = apply_regions(xc[i], cm[i], labels, ts, bs, valids)
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
    the style-side tensors are shared across the batch. No host sync."""
    xc = _rows(content_feat)
    if xc.dtype not in (torch.float32, torch.bfloat16):
        xc = xc.float()
    cm = cmask.reshape(cmask.shape[0], -1).to(torch.int32)
    out = torch.empty_like(xc)
    for i in range(xc.shape[0]):
        nc, mean_c, cov_c = _region_stats(xc[i], cm[i], labels)
        ts, bs, valids = region_transforms(
            labels, nc, mean_c, cov_c, ns, mean_s, cov_s, eps,
            float(min_pixels), max_ratio)
        out[i] = apply_regions(xc[i], cm[i], labels, ts, bs, valids)
    return out.reshape(content_feat.shape).to(content_feat.dtype)
