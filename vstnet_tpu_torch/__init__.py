"""vstnet_tpu_torch — the PyTorch/CUDA port of vstnet_tpu.

Two paths of vstnet_tpu in PyTorch: global video stylization (the
reversible RevResNet encoder/decoder, the global cWCT transfer, the video
program) and masked, auto-seg video stylization (SegFormer-B4/B5 masks per
frame, ADE20K label remapping, the regional cWCT against per-video style
statistics). Hand-written CUDA kernels for Hopper carry them (the coupling
block in csrc/coupling_mma.cu and csrc/coupling.cu, the stride-2 transition
with a full-res and a half-res entry in csrc/transition_mma.cu and
csrc/transition.cu, csrc/attention.cu, csrc/dwconv.cu); on the CPU the same
functions run their plain PyTorch versions. The package never imports jax or vstnet_tpu, and
reads its own copies of the ADE20K tables (data/*.npy).

    from vstnet_tpu_torch import (
        get_vstnet_encoder_model, get_vstnet_decoder_model,
        get_segment_model, get_photo_style_model, get_artist_style_model,
        get_segmenter, image_photo_predict,
    )

Every factory and constructor builds on the current CUDA device when no
device is given and raises when there is none; pass device="cpu" for the
CPU (`resolve_device`). The encoder, decoder and segment factories return
`(fn, device)` pairs; `fn` takes and returns NHWC tensors on `device`.

Images of any size (4K and above) stylize tile by tile in bounded device
memory through `models.ultra.stylize_tiled`, `stylize_tiled_masked` and
`stylize_tiled_interp`; `serve.StyleService` (with `serve.serve`) is the
HTTP style service, with shape buckets (`runtime.buckets`) and request
coalescing. The trainer (`train.trainer.train`, the reference's two-phase
recipe on `RevResNet.forward`/`inverse`, the differentiable pair; every
inference entry point builds no autograd graph) trains new weights. The
command-line entry points are `vstnet_tpu_torch.cli.image_transfer`
(tiling above --ultra_threshold), `vstnet_tpu_torch.cli.video_transfer`,
`vstnet_tpu_torch.cli.serve` and `vstnet_tpu_torch.cli.train`.
"""

__version__ = "0.1.0"

from vstnet_tpu_torch.config import (  # noqa: F401
    ARTISTIC_CONFIG,
    PHOTO_CONFIG,
    RevResNetConfig,
)
from vstnet_tpu_torch.device import resolve_device


def _model(checkpoint, mode, device):
    from vstnet_tpu_torch.models.pipeline import StyleModel

    if checkpoint:
        return StyleModel.from_checkpoint(checkpoint, mode=mode,
                                          device=device)
    return StyleModel.random_init(mode=mode, device=device)


def get_vstnet_encoder_model(checkpoint=None, mode: str = "photorealistic",
                             device=None):
    """(encode_fn, device). encode_fn: NHWC image in [0,1] -> latent."""
    device = resolve_device(device)
    model = _model(checkpoint, mode, device)
    return model.net.encode, device


def get_vstnet_decoder_model(checkpoint=None, mode: str = "photorealistic",
                             device=None):
    """(decode_fn, device). decode_fn: latent -> NHWC image in [0,1]."""
    device = resolve_device(device)
    model = _model(checkpoint, mode, device)

    def decode(z):
        return model.net.decode(z).clamp(0.0, 1.0)

    return decode, device


def get_segment_model(checkpoint=None, device=None):
    """(segment_fn, device). segment_fn: NHWC image in [0,1] -> (B, H, W)
    int32 ADE20K mask with small holes removed."""
    from vstnet_tpu_torch.models.segformer import Segmenter

    device = resolve_device(device)
    return Segmenter.load(checkpoint, device=device).segment, device


def get_photo_style_model(*args, **kwargs):
    from vstnet_tpu_torch.models.pipeline import create_photo_style_model

    return create_photo_style_model(*args, **kwargs)


def get_artist_style_model(*args, **kwargs):
    from vstnet_tpu_torch.models.pipeline import create_artist_style_model

    return create_artist_style_model(*args, **kwargs)


def get_segmenter(*args, **kwargs):
    """Segmenter.load: SegFormer-B4/B5 from a checkpoint, or seeded random
    weights when none is given, with the ADE20K relation table."""
    from vstnet_tpu_torch.models.segformer import Segmenter

    return Segmenter.load(*args, **kwargs)


def image_photo_predict(*args, **kwargs):
    from vstnet_tpu_torch.models.pipeline import image_photo_predict

    return image_photo_predict(*args, **kwargs)
