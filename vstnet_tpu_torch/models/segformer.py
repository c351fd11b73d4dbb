"""SegFormer-B4/B5 semantic segmentation (MiT backbone + all-MLP head).

Counterpart of vstnet_tpu/models/segformer.py: a 4-stage Mix-Transformer
(B4 depths 3/8/27/3, B5 3/6/40/3; dims 64/128/320/512, heads 1/2/5/8,
spatial-reduction ratios 8/4/2/1), the all-MLP decode head with a folded
BatchNorm, 150 ADE20K classes, ImageNet normalisation, bilinear upsample
and argmax mask. Images are NHWC floats in [0, 1]; tokens are (B, N, C).

The modules are laid out so that the reference state-dict keys
(`backbone.patch_embed{s}.proj`, `backbone.block{s}.{i}.attn.{q,kv,sr,norm,
proj}`, `...mlp.{fc1,dwconv.dwconv,fc2}`, `backbone.norm{s}`,
`decode_head.linear_c{i}.proj`, `decode_head.linear_fuse.{conv,bn}`,
`decode_head.linear_pred`) load with a plain `load_state_dict`.

Two hand-written kernels carry the bf16 route: the spatial-reduction
attention where the query count is large (ops/attention.py, K4) and the
MixFFN's depthwise conv + bias + GELU (ops/dwconv.py, K5). The float32
route runs torch ops with TF32 off.

Precision, as in the JAX package: LayerNorm computes in float32 whatever
the activation dtype (eps 1e-6 for block and stage norms, 1e-5 for the
patch-embed and sr norms); every matmul and conv output is rounded to the
activation dtype before its bias, cast to that dtype, is added, so the bf16
route stays bf16 from the first patch embed to the head; the BatchNorm is
folded to a scale and shift in float32; logits are upsampled in float32.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vstnet_tpu_torch.device import resolve_device
from vstnet_tpu_torch.ops.attention import (
    flash_ok,
    sr_attention,
    sr_attention_plain,
)
from vstnet_tpu_torch.ops.dwconv import dwconv3x3_bias_gelu
from vstnet_tpu_torch.ops.resize import (
    pad_to_multiple,
    resize_bilinear,
    resize_nearest,
)

EMBED_DIMS = (64, 128, 320, 512)
NUM_HEADS = (1, 2, 5, 8)
DEPTHS = (3, 8, 27, 3)       # MiT-B4
DEPTHS_B5 = (3, 6, 40, 3)    # MiT-B5: the same widths, deeper stages 2-3
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIO = 4
EMBEDDING_DIM = 768
NUM_CLASSES = 150

EPS_BLOCK = 1e-6     # block and stage norms
EPS_DEFAULT = 1e-5   # patch-embed and attention-sr norms; the BatchNorm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def true_f32():
    """TF32 off for cuDNN convs and matmuls inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _layer_norm(x, ln: nn.LayerNorm):
    """LayerNorm with float32 internals, returned in x's dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def _linear(x, lin):
    """x @ W^T rounded to x's dtype, then the bias cast to that dtype."""
    return F.linear(x, lin.weight.to(x.dtype)) + lin.bias.to(x.dtype)


def _conv_nhwc(x, conv: nn.Conv2d):
    """conv on an NHWC tensor with the module's stride, padding and groups;
    the bias (if any) is added after the rounding to x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), None,
                 conv.stride, conv.padding, 1, conv.groups)
    y = y.permute(0, 2, 3, 1)
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)
    return y


def _pointwise(x, conv: nn.Conv2d):
    """A 1x1 conv on an NHWC tensor as a matmul over the channel axis."""
    y = F.linear(x, conv.weight.to(x.dtype).flatten(1))
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Spatial-reduction attention. x: (B, N, C)."""

    def __init__(self, dim, num_heads, sr_ratio, device):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, device=device)
        self.kv = nn.Linear(dim, 2 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio,
                                device=device)
            self.norm = nn.LayerNorm(dim, eps=EPS_DEFAULT, device=device)

    def forward(self, x, h, w):
        b, n, c = x.shape
        hd = c // self.num_heads
        q = _linear(x, self.q).reshape(b, n, self.num_heads, hd)
        if self.sr_ratio > 1:
            xs = _conv_nhwc(x.reshape(b, h, w, c), self.sr).reshape(b, -1, c)
            xs = _layer_norm(xs, self.norm)
        else:
            xs = x
        m = xs.shape[1]
        kv = _linear(xs, self.kv).reshape(b, m, 2, self.num_heads, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]          # (B, M, heads, hd) views
        if flash_ok(n, m, x.dtype):
            out = sr_attention(q, k, v, hd ** -0.5)
        else:
            out = sr_attention_plain(q, k, v, hd ** -0.5)
        return _linear(out.reshape(b, n, c), self.proj)


class DWConv(nn.Module):
    def __init__(self, dim, device):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim,
                                device=device)


class MixFFN(nn.Module):
    """fc1 -> 3x3 depthwise conv -> GELU -> fc2. bf16 activations whose
    hidden width is a multiple of 128 take the fused kernel (K5)."""

    def __init__(self, dim, device):
        super().__init__()
        hidden = dim * MLP_RATIO
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.dwconv = DWConv(hidden, device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x, h, w):
        b, n, _ = x.shape
        x = _linear(x, self.fc1)
        c = x.shape[-1]
        xs = x.reshape(b, h, w, c)
        dw = self.dwconv.dwconv
        if x.dtype == torch.bfloat16 and c % 128 == 0:
            taps = dw.weight.reshape(c, 3, 3).permute(1, 2, 0)
            xs = dwconv3x3_bias_gelu(xs.contiguous(), taps, dw.bias)
        else:
            xs = F.gelu(_conv_nhwc(xs, dw))
        return _linear(xs.reshape(b, n, c), self.fc2)


class Block(nn.Module):
    def __init__(self, dim, num_heads, sr_ratio, device):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS_BLOCK, device=device)
        self.attn = Attention(dim, num_heads, sr_ratio, device)
        self.norm2 = nn.LayerNorm(dim, eps=EPS_BLOCK, device=device)
        self.mlp = MixFFN(dim, device)

    def forward(self, x, h, w):
        x = x + self.attn(_layer_norm(x, self.norm1), h, w)
        return x + self.mlp(_layer_norm(x, self.norm2), h, w)


class PatchEmbed(nn.Module):
    """Overlapping patch embed: strided conv padded k // 2 on both sides,
    then LayerNorm. NHWC in, tokens (B, N, C) and (h, w) out."""

    def __init__(self, cin, dim, kernel, stride, device):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, kernel, stride=stride,
                              padding=kernel // 2, device=device)
        self.norm = nn.LayerNorm(dim, eps=EPS_DEFAULT, device=device)

    def forward(self, x):
        y = _conv_nhwc(x, self.proj)
        b, h, w, c = y.shape
        return _layer_norm(y.reshape(b, h * w, c), self.norm), h, w


class MixTransformer(nn.Module):
    def __init__(self, depths, device):
        super().__init__()
        for s in range(4):
            cin = 3 if s == 0 else EMBED_DIMS[s - 1]
            setattr(self, f"patch_embed{s + 1}", PatchEmbed(
                cin, EMBED_DIMS[s], 7 if s == 0 else 3, 4 if s == 0 else 2,
                device))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                Block(EMBED_DIMS[s], NUM_HEADS[s], SR_RATIOS[s], device)
                for _ in range(depths[s])))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(
                EMBED_DIMS[s], eps=EPS_BLOCK, device=device))

    def forward(self, x):
        """NHWC image -> 4 NHWC feature maps at 1/4, 1/8, 1/16, 1/32."""
        feats = []
        for s in range(1, 5):
            tokens, h, w = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"block{s}"):
                tokens = block(tokens, h, w)
            tokens = _layer_norm(tokens, getattr(self, f"norm{s}"))
            x = tokens.reshape(tokens.shape[0], h, w, -1)
            feats.append(x)
        return feats


class _Proj(nn.Module):
    def __init__(self, cin, cout, device):
        super().__init__()
        self.proj = nn.Linear(cin, cout, device=device)


class _FrozenBatchNorm(nn.Module):
    """Inference BatchNorm: weight, bias and the running statistics, with
    the reference's key names and nothing else."""

    def __init__(self, dim, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))


class _Fuse(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.conv = nn.Conv2d(4 * EMBEDDING_DIM, EMBEDDING_DIM, 1,
                              bias=False, device=device)
        self.bn = _FrozenBatchNorm(EMBEDDING_DIM, device)


class DecodeHead(nn.Module):
    """All-MLP head: per-level linear to 768, upsample to the 1/4 grid,
    concat [c4, c3, c2, c1], 1x1 conv + BN + ReLU, 1x1 prediction."""

    def __init__(self, device):
        super().__init__()
        for i, dim in enumerate(EMBED_DIMS):
            setattr(self, f"linear_c{i + 1}",
                    _Proj(dim, EMBEDDING_DIM, device))
        self.linear_fuse = _Fuse(device)
        self.linear_pred = nn.Conv2d(EMBEDDING_DIM, NUM_CLASSES, 1,
                                     device=device)

    def forward(self, feats):
        _, h1, w1, _ = feats[0].shape
        ups = []
        for lvl in (3, 2, 1, 0):
            c = _linear(feats[lvl], getattr(self, f"linear_c{lvl + 1}").proj)
            ups.append(resize_bilinear(c, h1, w1))
        x = _pointwise(torch.cat(ups, dim=-1), self.linear_fuse.conv)
        bn = self.linear_fuse.bn
        scale = bn.weight.float() * torch.rsqrt(
            bn.running_var.float() + EPS_DEFAULT)
        shift = bn.bias.float() - bn.running_mean.float() * scale
        x = F.relu(x * scale.to(x.dtype) + shift.to(x.dtype))
        return _pointwise(x, self.linear_pred)      # (B, h1, w1, 150)


class SegFormer(nn.Module):
    """MiT backbone + decode head. Parameters start uninitialized: call
    `init_weights(generator)` or `load_state_dict`. device=None builds on
    the CUDA card (device.resolve_device); pass "cpu" for the CPU."""

    def __init__(self, depths=DEPTHS, device=None):
        super().__init__()
        device = resolve_device(device)
        self.depths = tuple(depths)
        self.backbone = MixTransformer(self.depths, device)
        self.decode_head = DecodeHead(device)
        self._half = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """U(+-1/sqrt(fan_in)) weights and zero biases for every linear and
        conv, identity norms, drawn from `generator` on the CPU."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                bound = mod.weight[0].numel() ** -0.5
                w = torch.rand(mod.weight.shape, generator=generator)
                mod.weight.copy_(w * (2 * bound) - bound)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self._half = None
        return self

    def load_state_dict(self, *args, **kwargs):
        self._half = None
        return super().load_state_dict(*args, **kwargs)

    def half_copy(self):
        """A copy whose linear and conv weights and biases (the depthwise
        taps excepted) are bf16, made once: the bf16 route casts them at
        every use otherwise. Norms, the BatchNorm and the depthwise taps
        stay float32, where the bf16 route uses them."""
        if self._half is None:
            twin = copy.deepcopy(self)
            for mod in twin.modules():
                if (isinstance(mod, (nn.Linear, nn.Conv2d))
                        and not (isinstance(mod, nn.Conv2d)
                                 and mod.groups > 1)):
                    mod.to(torch.bfloat16)
            self._half = (twin,)     # a tuple: not a registered submodule
        return self._half[0]

    def features(self, x):
        return self.backbone(x)

    def head(self, feats):
        return self.decode_head(feats)


def _normalize(image):
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=image.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=image.device)
    return (image.float() - mean) / std


@torch.no_grad()
def segment_logits(net: SegFormer, image, half: bool = False):
    """image: NHWC float in [0, 1], H and W multiples of 4 ->
    (B, H, W, 150) float32 logits.

    half=True runs the backbone and head in bf16 (LayerNorm internals and
    the final logits stay float32)."""
    x = _normalize(image)
    with true_f32():
        if half:
            x = x.to(torch.bfloat16)
            net = net.half_copy()
        logits = net.head(net.features(x)).float()
        return resize_bilinear(logits, image.shape[1], image.shape[2])


@torch.no_grad()
def segment_mask(net: SegFormer, image, half: bool = False):
    """argmax class mask (B, H, W) int32."""
    return segment_logits(net, image, half=half).argmax(dim=-1).to(
        torch.int32)


# ---------------------------------------------------------------------------
# Segmenter-resolution quality gate
# ---------------------------------------------------------------------------

def seg_hw_for(h: int, w: int, seg_size: int):
    """(h, w) capped so that the longer side is seg_size, floored to a
    multiple of 4; None if seg_size does not shrink the frame."""
    if seg_size <= 0 or max(h, w) <= seg_size:
        return None
    ss = seg_size / max(h, w)
    return (max(int(h * ss) // 4 * 4, 4), max(int(w * ss) // 4 * 4, 4))


def mask_quality(masks_ref, masks_test) -> dict:
    """Agreement between two (B, H, W) int mask stacks: pixel_acc (share of
    equal pixels) and mean_iou (mean IoU over labels present in either)."""
    a = np.asarray(torch.as_tensor(masks_ref).cpu())
    b = np.asarray(torch.as_tensor(masks_test).cpu())
    if a.shape != b.shape:
        raise ValueError(f"mask_quality: shapes {a.shape} and {b.shape}")
    ious = []
    for lbl in np.union1d(np.unique(a), np.unique(b)):
        union = np.logical_or(a == lbl, b == lbl).sum()
        if union > 0:
            ious.append(np.logical_and(a == lbl, b == lbl).sum() / union)
    return {"pixel_acc": float((a == b).mean()),
            "mean_iou": float(np.mean(ious)) if ious else 1.0}


def pick_seg_size(net: SegFormer, frames, candidates=(256, 384, 512),
                  min_pixel_acc: float = 0.95, min_iou: float = 0.80,
                  half: bool = True, segment_fn=None) -> int:
    """Smallest candidate seg_size whose nearest-upsampled masks still
    agree with the native-resolution masks on `frames` ((B, H, W, 3) floats
    in [0, 1]); 0 (= native) when no candidate passes."""
    def default_fn(x, hw):
        if hw:
            x = resize_bilinear(x, hw[0], hw[1])
        return segment_mask(net, x, half=half)

    fn = segment_fn or default_fn
    h, w = frames.shape[1], frames.shape[2]
    native = torch.as_tensor(fn(frames, None))
    for cand in sorted(candidates):
        hw = seg_hw_for(h, w, cand)
        if hw is None:
            continue
        up = resize_nearest(torch.as_tensor(fn(frames, hw)), h, w)
        q = mask_quality(native, up)
        if q["pixel_acc"] >= min_pixel_acc and q["mean_iou"] >= min_iou:
            return cand
    return 0


def infer_depths(sd) -> tuple:
    """Per-stage block counts from a checkpoint's backbone.block{s}.{i}.*
    keys: tells MiT-B4 (3, 8, 27, 3) from B5 (3, 6, 40, 3)."""
    depths = []
    for s in range(4):
        n = 0
        while f"backbone.block{s + 1}.{n}.norm1.weight" in sd:
            n += 1
        depths.append(n)
    return tuple(depths)


# ---------------------------------------------------------------------------
# High-level segmenter (pad, mask, hole removal, remapping)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Segmenter:
    """pad -> mask -> hole removal, plus self/cross remapping for the
    auto-seg flow."""

    net: SegFormer
    min_ratio: float = 0.01
    label_mapping: Optional[torch.Tensor] = None
    half: bool = False
    MAX_TIMES = 4

    @classmethod
    def load(cls, checkpoint: Optional[str] = None, min_ratio: float = 0.01,
             label_mapping: Optional[str] = None, seed: int = 0,
             depths=DEPTHS, half: bool = False, device=None):
        """A checkpoint's depths (B4 or B5) are read from its keys;
        `depths` sets the profile of a random-init segmenter (checkpoint
        None, weights from `seed`). device=None is the CUDA card."""
        from vstnet_tpu_torch.io.checkpoint import load_segformer
        from vstnet_tpu_torch.models.remapping import load_label_mapping

        device = resolve_device(device)
        if checkpoint:
            sd = load_segformer(checkpoint)
            got = infer_depths(sd)
            if not all(got):
                raise ValueError("cannot infer MiT stage depths from "
                                 f"checkpoint: {got}")
            net = SegFormer(got, device=device)
            net.load_state_dict(sd)
        else:
            net = SegFormer(depths, device=device)
            net.init_weights(torch.Generator().manual_seed(seed))
        return cls(net=net, min_ratio=min_ratio,
                   label_mapping=load_label_mapping(label_mapping,
                                                    device=device),
                   half=half)

    def segment(self, image, remove_holes: bool = True):
        """image NHWC float in [0, 1] -> (B, H, W) int32 mask."""
        from vstnet_tpu_torch.models.remapping import remove_small_holes

        h, w = image.shape[1], image.shape[2]
        x = pad_to_multiple(image, self.MAX_TIMES)
        mask = segment_mask(self.net, x, half=self.half)[:, :h, :w]
        if remove_holes and self.label_mapping is not None:
            mask = remove_small_holes(mask, self.label_mapping,
                                      min_ratio=self.min_ratio)
        return mask

    def remap(self, cmask, smask, min_ratio: Optional[float] = None):
        """Self-remap both masks, then cross-remap content onto style."""
        from vstnet_tpu_torch.models.remapping import (
            cross_remapping,
            self_remapping,
        )

        r = self.min_ratio if min_ratio is None else min_ratio
        cm = self_remapping(torch.as_tensor(cmask), self.label_mapping, r)
        sm = self_remapping(torch.as_tensor(smask), self.label_mapping, r)
        return cross_remapping(cm, sm, self.label_mapping), sm
