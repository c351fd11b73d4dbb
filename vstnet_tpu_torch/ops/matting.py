"""The matting-Laplacian photorealism regularizer, matrix-free.

Counterpart of vstnet_tpu/ops/matting.py, whose docstring derives the
form. With windows of n = 9 pixels (win_rad 1) around every interior pixel
k, guidance image I (the content crop), window mean mu_k and regularized
covariance inverse V_k, L = D - W never needs building:

    x^T L x = sum_k [ sum_{i in k} (x_i - xbar_k)^2
                      - (1/n) t_k^T V_k t_k ],
    t_k = sum_{i in k} (x_i - xbar_k)(I_i - mu_k).

The form is the CENTRED one: the uncentred E[II^T] - mu mu^T cancels
catastrophically in float32 on flat regions, where V_k is eps-dominated
and amplifies the cancellation ~1e7 times. Everything here runs in float32
whatever the inputs' dtype (float64 on float64 inputs, for reference runs:
ops.at_least_f32), on elementwise products and sums only (no
matmul, so no TF32 can enter), and the gradient 2 L x / HW comes from
autograd of the quadratic form.
"""

from __future__ import annotations

import torch

from vstnet_tpu_torch.ops import at_least_f32

WIN_SIZE = 9.0


def _box3_valid(x):
    """VALID 3x3 box sum over H, W of an NHWC tensor."""
    hc, wc = x.shape[1] - 2, x.shape[2] - 2
    return sum(x[:, dy:dy + hc, dx:dx + wc]
               for dy in range(3) for dx in range(3))


def _inv3x3(m):
    """Closed-form inverse of (..., 3, 3) SPD matrices (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def matting_laplacian_quadform(image, x, eps: float = 1e-7):
    """Per-sample sum over channels of x_c^T L(image) x_c, shape (B,).

    image (B, H, W, 3) in [0,1], the guidance (the content crop); x
    (B, H, W, C), the field L acts on (the stylized RGB). Unnormalized:
    the caller divides by H*W."""
    img = at_least_f32(image)
    xf = at_least_f32(x).to(img.dtype)
    hc, wc = img.shape[1] - 2, img.shape[2] - 2
    mu = _box3_valid(img) / WIN_SIZE
    xbar = _box3_valid(xf) / WIN_SIZE
    cov = q = t = 0.0
    for dy in range(3):
        for dx in range(3):
            di = img[:, dy:dy + hc, dx:dx + wc] - mu
            dxv = xf[:, dy:dy + hc, dx:dx + wc] - xbar
            cov = cov + di[..., :, None] * di[..., None, :]
            q = q + dxv * dxv
            t = t + dxv[..., :, None] * di[..., None, :]
    eye = torch.eye(3, dtype=img.dtype, device=img.device)
    v = _inv3x3(cov / WIN_SIZE + (eps / WIN_SIZE) * eye)
    # tv[c, d] = sum_a t[c, a] v[a, d]; tvt = sum_{c, d} tv[c, d] t[c, d]
    tv = (t[..., :, :, None] * v[..., None, :, :]).sum(-2)
    tvt = (tv * t).sum(dim=(1, 2, 3, 4))
    return q.sum(dim=(1, 2, 3)) - tvt / WIN_SIZE


def matting_loss_and_grad(image, x, eps: float = 1e-7):
    """(per-sample x^T L x / HW (B,), 2 L x / HW (B, H, W, C)), float32
    (float64 for float64 inputs).

    Neither output carries a graph: the gradient is taken of a detached
    copy of x."""
    hw = x.shape[1] * x.shape[2]
    with torch.enable_grad():
        xx = at_least_f32(x.detach()).requires_grad_(True)
        per_sample = matting_laplacian_quadform(image.detach(), xx, eps) / hw
        (grad,) = torch.autograd.grad(per_sample.sum(), xx)
    return per_sample.detach(), grad


def matting_loss_and_grad_rows(images, xs, eps: float = 1e-7):
    """matting_loss_and_grad of the images that the NHWC row shards make
    up (one data row's devices, in row order): (per-sample x^T L x / HW
    (B,) on the first shard's device, [2 L x / HW of each shard]), H*W the
    whole image's.

    Each VALID 3x3 window belongs to the shard that holds its top row, so
    a shard other than the last takes the first 2 rows of the next shard
    (of the image and of x) below its own, and the shards' windows are
    the whole image's, once each. The gradient is autograd of the summed
    forms: the cotangent of a borrowed row goes back through the copy to
    the shard that owns it."""
    hw = sum(x.shape[1] for x in xs) * xs[0].shape[2]
    dev = xs[0].device
    last = len(xs) - 1
    with torch.enable_grad():
        leaves = [at_least_f32(x.detach()).requires_grad_(True) for x in xs]
        total = 0.0
        for k, (img, x) in enumerate(zip(images, leaves)):
            img = img.detach()
            if k < last:
                img = torch.cat([img, images[k + 1][:, :2].detach().to(
                    img.device)], dim=1)
                x = torch.cat([x, leaves[k + 1][:, :2].to(x.device)], dim=1)
            total = total + matting_laplacian_quadform(img, x, eps).to(dev)
        per_sample = total / hw
        grads = torch.autograd.grad(per_sample.sum(), leaves)
    return per_sample.detach(), list(grads)
