"""Cholesky whitening-coloring transfer (cWCT), global form.

Counterpart of vstnet_tpu/models/cwct.py (robust_cholesky, the global
transfer, the precomputed style factors and their packed-latent forms).
The whole transform is one per-sample product y = T x + b with
T = Ls Lc^{-1} and b = mu_s - T mu_c.

Every function works on a (B, G, C, N) view of the latent: the packed NCHW
latent (B, G*C, h, w) of encode_fast(packed_latent=True) is a free reshape
to it, and an NHWC latent (B, H, W, C) is its G = 1 case.

Precision: statistics, Cholesky factors and transforms are float32 with
TF32 off, even when the latent is bf16; the apply sums in float32 and
rounds once to the latent's dtype. There is no hand-written kernel here:
the 32x32 statistics, the Cholesky, the triangular solve and the apply
product are torch ops.
"""

from __future__ import annotations

import contextlib

import torch

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


def robust_cholesky(cov, eps: float = EPS_DEFAULT, attempts: int = 8):
    """First finite Cholesky factor among escalating diagonal jitters
    (0, eps, 2 eps, 4 eps, ...) of cov (..., C, C).

    A candidate passes when cholesky_ex reports info == 0 and the factor is
    finite. If none passes, the result is NaN and poisons the output
    (host_check_finite detects it). All on the device: no host sync."""
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
    l = l.squeeze(-3)
    bad = ~ok.any(dim=-1)
    return torch.where(bad[..., None, None], torch.full_like(l, float("nan")),
                       l)


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
    in float32."""
    x = x.float()
    b, g, c, n = x.shape
    mean = x.mean(dim=(1, 3))
    xc = (x - mean[:, None, :, None]).transpose(1, 2).reshape(b, c, g * n)
    cov = torch.bmm(xc, xc.transpose(1, 2)) / (g * n - 1)
    return mean, cov


def _factors(x, eps):
    with true_f32_matmul():
        mean, cov = _stats(x)
        return robust_cholesky(cov, eps), mean


def _transfer(x, ls, mu_s, eps, alpha_c=None):
    """Global transfer of x (B, G, C, N) against style factors (ls, mu_s),
    which may have batch 1 to broadcast over x's batch. alpha_c blends the
    content factor in (interpolation): Ls' = Ls (1-a) + Lc a, likewise the
    means."""
    bsz = x.shape[0]
    with true_f32_matmul():
        mean, cov = _stats(x)
        lc = robust_cholesky(cov, eps)
        ls = ls.float().expand(bsz, *ls.shape[1:])
        mu = mu_s.float().expand(bsz, *mu_s.shape[1:])
        if alpha_c is not None:
            a = torch.as_tensor(alpha_c, dtype=torch.float32,
                                device=x.device)
            ls = ls * (1.0 - a) + lc * a
            mu = mu * (1.0 - a) + mean * a
        t = ls @ _inv_lower(lc)
        b = mu - (t @ mean[..., None])[..., 0]
        t = t.to(x.dtype).float()
        y = torch.matmul(t[:, None], x.float()) + b[:, None, :, None]
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

def style_factors(style_feat, eps: float = EPS_DEFAULT):
    """style_feat (B, H, W, C) -> (Ls (B, C, C), mu_s (B, C))."""
    return _factors(_nhwc_as_gcn(style_feat), eps)


def transfer_with_factors(content_feat, ls, mu_s, eps: float = EPS_DEFAULT):
    """Global transfer of an NHWC latent against precomputed factors."""
    y = _transfer(_nhwc_as_gcn(content_feat), ls, mu_s, eps)
    return _gcn_as_nhwc(y, content_feat.shape)


def interp_with_factors(content_feat, mix_ls, mix_mu, alpha_c,
                        eps: float = EPS_DEFAULT):
    """interp_with_factors_packed on an NHWC latent."""
    y = _transfer(_nhwc_as_gcn(content_feat), mix_ls, mix_mu, eps,
                  alpha_c=alpha_c)
    return _gcn_as_nhwc(y, content_feat.shape)


def transfer(content_feat, style_feat, eps: float = EPS_DEFAULT):
    """Global cWCT of content (B, Hc, Wc, C) by style (B or 1, Hs, Ws, C),
    computed in float32 and returned in the content's dtype."""
    ls, mu = style_factors(style_feat.float(), eps)
    return transfer_with_factors(content_feat.float(), ls, mu,
                                 eps).to(content_feat.dtype)
