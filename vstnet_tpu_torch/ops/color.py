"""sRGB <-> CIE Lab conversions on NHWC tensors, for the luminance-keeping
blend of the photo pipeline.

Counterpart of vstnet_tpu/ops/color.py, with the same constants and
thresholds: sRGB gamma with the 0.04045 / 0.0031308 knees, the D65 white
point, L scaled to [-1, 1] and ab divided by 110. float32 throughout.
"""

from __future__ import annotations

import torch

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)

_XYZ2RGB = (
    (3.24048134, -1.53715152, -0.49853633),
    (-0.96925495, 1.87599, 0.04155593),
    (0.05564664, -0.20404134, 1.05731107),
)

_WHITE = (0.95047, 1.0, 1.08883)


def _const(rows, like):
    return torch.tensor(rows, dtype=torch.float32, device=like.device)


def _mat(x, rows):
    """x (..., 3) @ M^T, summed in true float32 (TF32 off on the card)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ _const(rows, x).T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def rgb2xyz(rgb):
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    return _mat(lin, _RGB2XYZ)


def xyz2rgb(xyz):
    rgb = _mat(xyz, _XYZ2RGB).clamp(min=0.0)   # no NaN in the power
    return torch.where(rgb > 0.0031308, 1.055 * rgb ** (1.0 / 2.4) - 0.055,
                       12.92 * rgb)


def xyz2lab(xyz):
    xyz_scale = xyz / _const(_WHITE, xyz)
    f = torch.where(xyz_scale > 0.008856,
                    xyz_scale.clamp(min=1e-8) ** (1.0 / 3.0),
                    7.787 * xyz_scale + 16.0 / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def lab2xyz(lab):
    y_int = (lab[..., 0] + 16.0) / 116.0
    x_int = lab[..., 1] / 500.0 + y_int
    z_int = (y_int - lab[..., 2] / 200.0).clamp(min=0.0)
    f = torch.stack([x_int, y_int, z_int], dim=-1)
    out = torch.where(f > 0.2068966, f ** 3.0, (f - 16.0 / 116.0) / 7.787)
    return out * _const(_WHITE, out)


def rgb2lab(rgb):
    """rgb in [0, 1] NHWC -> normalised Lab: L in [-1, 1], ab / 110."""
    lab = xyz2lab(rgb2xyz(rgb.float()))
    l_rs = (lab[..., 0:1] - 50.0) / 50.0
    ab_rs = lab[..., 1:3] / 110.0
    return torch.cat([l_rs, ab_rs], dim=-1).clamp(-1.0, 1.0)


def lab2rgb(lab_rs):
    l = lab_rs[..., 0:1] * 50.0 + 50.0
    ab = lab_rs[..., 1:3] * 110.0
    lab = torch.cat([l, ab], dim=-1)
    return xyz2rgb(lab2xyz(lab)).clamp(0.0, 1.0)
