"""Plain SegFormer (MiT backbone and all-MLP head) and its argmax masks.

SegFormer, arXiv:2105.15203, as the configuration file states it: four
stages of overlapping patch embeds (7x7 stride 4, then 3x3 stride 2,
padded k // 2) with LayerNorm (eps 1e-5); blocks of spatial-reduction
attention (a kernel = stride = sr conv and LayerNorm (eps 1e-5) on the
keys' side, softmax(q k^T / sqrt(d)) v per head) and MixFFN (linear,
3x3 depthwise conv, exact GELU, linear), pre-norm (eps 1e-6) with
residuals; a LayerNorm (eps 1e-6) after each stage. The head projects
each stage to `decoder_dim`, upsamples bilinearly (half-pixel) to the
first stage's grid, concatenates [c4, c3, c2, c1], applies a 1x1 conv
without bias, an inference BatchNorm (eps 1e-5) and ReLU, and a 1x1
classifier. Inputs are normalised by ImageNet's mean and deviation;
logits are upsampled bilinearly to the image and argmaxed.

Weights are a dict under the upstream checkpoint's keys
(`weight_shapes`). Frames go through one at a time, so that the float32
logits at full size (H x W x 150) of one frame are what is held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.lowp import Exact
from benchmark.reference.resize import resize_bilinear

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _stage(cfg, s):
    return (cfg["hidden_sizes"][s], cfg["num_attention_heads"][s],
            cfg["sr_ratios"][s], cfg["depths"][s])


def weight_shapes(cfg):
    """{key: shape} of every parameter and buffer of the state dict."""
    shapes = {}
    cin = cfg["num_channels"]
    for s in range(4):
        dim, _, sr, depth = _stage(cfg, s)
        r = cfg["mlp_ratios"][s]
        k = cfg["patch_sizes"][s]
        p = f"backbone.patch_embed{s + 1}"
        shapes[f"{p}.proj.weight"] = (dim, cin, k, k)
        shapes[f"{p}.proj.bias"] = (dim,)
        shapes[f"{p}.norm.weight"] = (dim,)
        shapes[f"{p}.norm.bias"] = (dim,)
        for i in range(depth):
            b = f"backbone.block{s + 1}.{i}"
            for name, shape in (
                    ("norm1", None), ("attn.q", (dim, dim)),
                    ("attn.kv", (2 * dim, dim)), ("attn.proj", (dim, dim)),
                    ("norm2", None), ("mlp.fc1", (r * dim, dim)),
                    ("mlp.dwconv.dwconv", (r * dim, 1, 3, 3)),
                    ("mlp.fc2", (dim, r * dim))):
                rows = shape[0] if shape else dim
                shapes[f"{b}.{name}.weight"] = shape or (dim,)
                shapes[f"{b}.{name}.bias"] = (rows,)
            if sr > 1:
                shapes[f"{b}.attn.sr.weight"] = (dim, dim, sr, sr)
                shapes[f"{b}.attn.sr.bias"] = (dim,)
                shapes[f"{b}.attn.norm.weight"] = (dim,)
                shapes[f"{b}.attn.norm.bias"] = (dim,)
        shapes[f"backbone.norm{s + 1}.weight"] = (dim,)
        shapes[f"backbone.norm{s + 1}.bias"] = (dim,)
        cin = dim
    e = cfg["decoder_hidden_size"]
    for s in range(4):
        shapes[f"decode_head.linear_c{s + 1}.proj.weight"] = (
            e, cfg["hidden_sizes"][s])
        shapes[f"decode_head.linear_c{s + 1}.proj.bias"] = (e,)
    shapes["decode_head.linear_fuse.conv.weight"] = (e, 4 * e, 1, 1)
    for name in ("weight", "bias", "running_mean", "running_var"):
        shapes[f"decode_head.linear_fuse.bn.{name}"] = (e,)
    shapes["decode_head.linear_pred.weight"] = (cfg["num_labels"], e, 1, 1)
    shapes["decode_head.linear_pred.bias"] = (cfg["num_labels"],)
    return shapes


class _Net:
    def __init__(self, weights, cfg, lp):
        self.w = weights
        self.cfg = cfg
        self.lp = lp

    def g(self, key):
        return self.w[key].float()

    def ln(self, x, key, eps):
        return F.layer_norm(x, x.shape[-1:], self.g(f"{key}.weight"),
                            self.g(f"{key}.bias"), eps)

    def linear(self, x, key):
        return F.linear(self.lp(x), self.lp(self.g(f"{key}.weight")),
                        self.g(f"{key}.bias"))

    def conv(self, x_nhwc, key, stride=1, padding=0, groups=1, bias=True):
        y = F.conv2d(self.lp(x_nhwc.permute(0, 3, 1, 2)),
                     self.lp(self.g(f"{key}.weight")),
                     self.g(f"{key}.bias") if bias else None,
                     stride, padding, 1, groups)
        return y.permute(0, 2, 3, 1)

    def attention(self, x, key, h, w, heads, sr):
        b, n, c = x.shape
        d = c // heads
        q = self.linear(x, f"{key}.q").reshape(b, n, heads, d)
        xs = x
        if sr > 1:
            xs = self.conv(x.reshape(b, h, w, c), f"{key}.sr", stride=sr)
            xs = self.ln(xs.reshape(b, -1, c), f"{key}.norm", 1e-5)
        m = xs.shape[1]
        kv = self.linear(xs, f"{key}.kv").reshape(b, m, 2, heads, d)
        k, v = kv[:, :, 0], kv[:, :, 1]
        s = torch.einsum("bnhd,bmhd->bhnm", self.lp(q),
                         self.lp(k)) * d ** -0.5
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhnm,bmhd->bnhd", self.lp(p), self.lp(v))
        return self.linear(o.reshape(b, n, c), f"{key}.proj")

    def mixffn(self, x, key, h, w):
        b, n, _ = x.shape
        x = self.linear(x, f"{key}.fc1")
        c = x.shape[-1]
        x = self.conv(x.reshape(b, h, w, c), f"{key}.dwconv.dwconv",
                      padding=1, groups=c)
        return self.linear(F.gelu(x).reshape(b, n, c), f"{key}.fc2")

    def logits(self, img):
        """img (B, H, W, 3) in [0, 1] -> (B, H/4, W/4, classes) logits."""
        cfg = self.cfg
        mean = torch.tensor(MEAN, dtype=torch.float32, device=img.device)
        std = torch.tensor(STD, dtype=torch.float32, device=img.device)
        x = (img.float() - mean) / std
        feats = []
        for s in range(4):
            dim, heads, sr, depth = _stage(cfg, s)
            k = cfg["patch_sizes"][s]
            p = f"backbone.patch_embed{s + 1}"
            y = self.conv(x, f"{p}.proj", stride=cfg["strides"][s],
                          padding=k // 2)
            b, h, w, _ = y.shape
            t = self.ln(y.reshape(b, h * w, dim), f"{p}.norm", 1e-5)
            for i in range(depth):
                key = f"backbone.block{s + 1}.{i}"
                t = self.lp.store(t + self.attention(
                    self.ln(t, f"{key}.norm1", 1e-6), f"{key}.attn", h, w,
                    heads, sr))
                t = self.lp.store(t + self.mixffn(
                    self.ln(t, f"{key}.norm2", 1e-6), f"{key}.mlp", h, w))
            t = self.ln(t, f"backbone.norm{s + 1}", 1e-6)
            x = t.reshape(b, h, w, dim)
            feats.append(x)
        h1, w1 = feats[0].shape[1:3]
        ups = [resize_bilinear(
            self.linear(feats[s], f"decode_head.linear_c{s + 1}.proj"), h1,
            w1) for s in (3, 2, 1, 0)]
        x = self.conv(torch.cat(ups, dim=-1), "decode_head.linear_fuse.conv",
                      bias=False)
        bn = "decode_head.linear_fuse.bn"
        scale = self.g(f"{bn}.weight") * torch.rsqrt(
            self.g(f"{bn}.running_var") + 1e-5)
        x = F.relu(x * scale + self.g(f"{bn}.bias")
                   - self.g(f"{bn}.running_mean") * scale)
        return self.conv(x, "decode_head.linear_pred")


# a pixel is decided clearly when its best logit leads the second by at
# least this share of the frame's logit deviation
CLEAR = 0.05


@torch.no_grad()
def segment(weights, cfg, images, lp=Exact()):
    """images (B, H, W, 3) in [0, 1] -> ((B, H, W) int64 argmax masks,
    (B, H, W) bool: decided clearly), one frame at a time."""
    net = _Net(weights, cfg, lp)
    masks, clear = [], []
    for i in range(images.shape[0]):
        img = images[i:i + 1]
        lg = resize_bilinear(net.logits(img), img.shape[1], img.shape[2])
        top = lg.topk(2, dim=-1).values
        clear.append(top[..., 0] - top[..., 1] >= CLEAR * lg.std())
        masks.append(lg.argmax(dim=-1))
        del lg, top
    return torch.cat(masks), torch.cat(clear)
