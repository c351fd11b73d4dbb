"""Plain Cholesky whitening-colouring transfer (cWCT), global and regional.

CAP-VSTNet's cWCT: per sample (or per region) y = T x + b with
T = Ls Lc^-1 and b = mu_s - T mu_c, where L is the lower Cholesky factor
of the latent's covariance (divided by n - 1) and mu its mean. The
statistics are summed in float64 and rounded to float32 once; a factor is
the first finite one of cov + s * eps * I for s = 0, eps, 2 eps, 4 eps, ...
(eight tries, eps = 2e-5) in float32, as the configuration states. The
transform is applied in float64 to the float32 latent. TF32 is off.

A regional transfer takes, for each label of the style's mask, the
content rows and the style rows of that label; a region is transferred
when both sides hold more than 10 rows and neither holds 100 times the
other's; every other row keeps its content.
"""

from __future__ import annotations

import torch

EPS = 2e-5
TRIES = 8
MIN_PIXELS = 10
MAX_RATIO = 100.0


def stats(x):
    """x (N, C) -> mean (C,), covariance (C, C) /(n - 1), float32, summed
    in float64."""
    x = x.double()
    mean = x.mean(dim=0)
    xc = x - mean
    cov = xc.t() @ xc / (x.shape[0] - 1)
    return mean.float(), cov.float()


def cholesky(cov):
    """The first finite float32 factor of cov + s eps I over the ladder;
    NaN when none is."""
    eye = torch.eye(cov.shape[-1], dtype=torch.float32, device=cov.device)
    for s in [0.0] + [2.0 ** i for i in range(TRIES - 1)]:
        lf, info = torch.linalg.cholesky_ex(cov.float() + s * EPS * eye)
        if int(info) == 0 and bool(torch.isfinite(lf).all()):
            return lf
    return torch.full_like(cov, float("nan"))


def transform(mean_c, cov_c, ls, mu_s):
    """(T, b) from the content's statistics and the style's factor."""
    lc = cholesky(cov_c).double()
    t = ls.double() @ torch.linalg.inv(lc)
    return t, mu_s.double() - t @ mean_c.double()


def style_factor(z_s):
    """(Ls, mu_s) of a style latent (H, W, C) or rows (N, C)."""
    rows = z_s.reshape(-1, z_s.shape[-1])
    mean, cov = stats(rows)
    return cholesky(cov), mean


def apply(rows, t, b):
    return (rows.double() @ t.t() + b).float()


def transfer_global(z_c, ls, mu_s):
    """Each sample of z_c (B, H, W, C) against one style factor."""
    out = torch.empty_like(z_c, dtype=torch.float32)
    for i in range(z_c.shape[0]):
        rows = z_c[i].reshape(-1, z_c.shape[-1])
        t, b = transform(*stats(rows), ls, mu_s)
        out[i] = apply(rows, t, b).reshape(z_c.shape[1:])
    return out


def style_regions(z_s, smask):
    """{label: (n, mean, cov)} of a style latent (H, W, C) under its mask
    (H, W), for every label the mask holds."""
    rows = z_s.reshape(-1, z_s.shape[-1])
    m = smask.reshape(-1)
    regions = {}
    for lab in torch.unique(m).tolist():
        sel = rows[m == lab]
        regions[lab] = (sel.shape[0], *stats(sel))
    return regions


def transfer_regional(z_c, cmask, regions):
    """One frame's latent (H, W, C) under its mask (H, W) against the
    style's regions."""
    rows = z_c.reshape(-1, z_c.shape[-1]).float()
    m = cmask.reshape(-1)
    out = rows.clone()
    for lab in torch.unique(m).tolist():
        if lab not in regions:
            continue
        ns, mean_s, cov_s = regions[lab]
        sel = m == lab
        nc = int(sel.sum())
        if not (nc > MIN_PIXELS and ns > MIN_PIXELS and nc < MAX_RATIO * ns
                and ns < MAX_RATIO * nc):
            continue
        part = rows[sel]
        t, b = transform(*stats(part), cholesky(cov_s), mean_s)
        out[sel] = apply(part, t, b)
    return out.reshape(z_c.shape)
