"""vstnet_tpu_torch — the PyTorch/CUDA port of vstnet_tpu.

The global stylization path of vstnet_tpu in PyTorch: the reversible
RevResNet encoder/decoder, the global cWCT transfer and the video program.
Every conv of the fast path runs in one of two hand-written CUDA kernels
for Hopper (csrc/coupling.cu, csrc/transition.cu); on the CPU the same
functions run their plain PyTorch versions. The package never imports jax
or vstnet_tpu.

    from vstnet_tpu_torch import (
        get_vstnet_encoder_model, get_vstnet_decoder_model,
        get_photo_style_model, get_artist_style_model,
    )

The encoder/decoder factories return `(fn, device)` pairs; `fn` takes and
returns NHWC float tensors on `device`.
"""

__version__ = "0.1.0"

import torch

from vstnet_tpu_torch.config import (  # noqa: F401
    ARTISTIC_CONFIG,
    PHOTO_CONFIG,
    RevResNetConfig,
)


def _model(checkpoint, mode, device):
    from vstnet_tpu_torch.models.pipeline import StyleModel

    if checkpoint:
        return StyleModel.from_checkpoint(checkpoint, mode=mode,
                                          device=device)
    return StyleModel.random_init(mode=mode, device=device)


def get_vstnet_encoder_model(checkpoint=None, mode: str = "photorealistic",
                             device="cpu"):
    """(encode_fn, device). encode_fn: NHWC image in [0,1] -> latent."""
    model = _model(checkpoint, mode, device)
    return model.net.encode, torch.device(device)


def get_vstnet_decoder_model(checkpoint=None, mode: str = "photorealistic",
                             device="cpu"):
    """(decode_fn, device). decode_fn: latent -> NHWC image in [0,1]."""
    model = _model(checkpoint, mode, device)

    def decode(z):
        return model.net.decode(z).clamp(0.0, 1.0)

    return decode, torch.device(device)


def get_photo_style_model(*args, **kwargs):
    from vstnet_tpu_torch.models.pipeline import create_photo_style_model

    return create_photo_style_model(*args, **kwargs)


def get_artist_style_model(*args, **kwargs):
    from vstnet_tpu_torch.models.pipeline import create_artist_style_model

    return create_artist_style_model(*args, **kwargs)
