"""Image I/O (PIL on the host, normalisation and packing on the device).

Counterpart of vstnet_tpu/io/image.py. Host arrays are uint8 NHWC; the
device moves one byte a channel each way: `device_put_image` uploads uint8
and scales on the device, `save_image` rounds to uint8 on the device
before the readback.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_image(path: str, max_size: int | None = None,
               down_scale: int | None = None, as_uint8: bool = False):
    """Load an RGB image -> float32 NHWC in [0,1], (1, H, W, 3).

    The longest side is capped at max_size (BICUBIC), then H and W are
    floored to multiples of down_scale. as_uint8=True returns the uint8
    array instead, for device_put_image."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = resize_pil(img, max_size, down_scale)
    arr = np.asarray(img, dtype=np.uint8)
    if as_uint8:
        return arr[None]
    return (arr.astype(np.float32) / 255.0)[None]


def device_put_image(arr, device):
    """NHWC host array -> float32 tensor on `device`; uint8 is uploaded as
    is and scaled to [0,1] there."""
    x = torch.from_numpy(np.array(arr)).to(device)   # a writable copy
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return x


def resize_pil(img, max_size=None, down_scale=None):
    from PIL import Image

    w, h = img.size
    if max_size is not None and max(w, h) > max_size:
        scale = max_size / max(w, h)
        w, h = int(w * scale), int(h * scale)
        img = img.resize((w, h), Image.BICUBIC)
    if down_scale is not None:
        w2, h2 = w // down_scale * down_scale, h // down_scale * down_scale
        if (w2, h2) != (w, h):
            img = img.resize((w2, h2), Image.BICUBIC)
    return img


def save_image(arr, path: str):
    """Save an NHWC/HWC image in [0,1] as PNG, clamped. A tensor is
    rounded to uint8 where it lies, so the readback moves one byte a
    channel; a float numpy array is truncated to uint8 as the JAX package
    does."""
    from PIL import Image

    if isinstance(arr, torch.Tensor):
        arr = torch.round((arr.float() * 255.0).clamp(0, 255)).to(
            torch.uint8).cpu().numpy()
    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(a).save(path)
    return path


def load_segment_image(path: str, size_hw=None):
    """Manual segmentation maps: paletted or grey label PNGs, or the
    9-colour RGB convention (black, white, green, blue, red, yellow, grey,
    light blue, purple -> labels 0-8). Returns (1, H, W) int32."""
    from PIL import Image

    img = Image.open(path)
    if size_hw is not None:
        img = img.resize((size_hw[1], size_hw[0]), Image.NEAREST)
    arr = np.asarray(img)
    if arr.ndim == 2:
        return arr.astype(np.int32)[None]
    colors = np.array(
        [(0, 0, 0), (255, 255, 255), (0, 255, 0), (0, 0, 255), (255, 0, 0),
         (255, 255, 0), (128, 128, 128), (0, 255, 255), (255, 0, 255)],
        dtype=np.int32)
    rgb = arr[..., :3].astype(np.int32)
    dist = np.abs(rgb[:, :, None, :] - colors[None, None, :, :]).sum(-1)
    return dist.argmin(-1).astype(np.int32)[None]
