"""Training losses and the step's forward and backward.

Counterpart of vstnet_tpu/train/losses.py (the reference trainer's loss):

  total = content * L_content + style * L_style + rec * L_cycle
        + temporal * L_temporal

plus the matting-Laplacian gradient injected into d(stylized): scaled by
the lap weight, clamped to +-lap_clamp. The JAX package expresses that as
a second cotangent of one vjp; here it is one torch.autograd.backward with
two roots, (total, stylized), and two gradients, (1, the clamped term).

Five reversible passes a step: encode a, encode b, decode the cWCT, then
re-encode the stylized image and decode its cWCT against z_c for the cycle
loss. The temporal phase adds a warped, noised second frame.

precision="bf16" is the mixed-precision route of the JAX package's
loss_and_grads_flat: the master weights stay float32 and get float32
gradients; the network's and VGG's convs run on bf16 casts of the weights
and images (RevResNet.forward); the cWCT statistics and Cholesky, the VGG
statistics, the losses' means and the matting term stay float32.

The row form (loss_and_grads_rows) is the same step over an image batch
split by rows onto one data row's devices of a ("data", "spatial") mesh,
the counterpart of the JAX package's spatial=True steps, where GSPMD
partitions the whole program: the reversible passes walk the shards with
a halo exchange before each conv (parallel/halo.forward_rows,
inverse_rows), VGG likewise (models/vgg.features_rows), the cWCT and the
VGG statistics and every mean are reduced over the shards on the row's
first device, the matting windows are split by their top row
(ops/matting.matting_loss_and_grad_rows), and each shard warps from the
whole frame gathered to its device. Both forms run one body
(_forward_losses) over lists of shards: one shard, the whole image, with
the whole-image functions, or S shards with their row forms.
"""

from __future__ import annotations

import dataclasses

import torch

from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import VGG, vgg_losses, vgg_losses_rows
from vstnet_tpu_torch.ops import at_least_f32
from vstnet_tpu_torch.ops.matting import (
    matting_loss_and_grad,
    matting_loss_and_grad_rows,
)
from vstnet_tpu_torch.ops.warp import flow_warp_nearest
from vstnet_tpu_torch.parallel.halo import forward_rows, inverse_rows

AUX_KEYS = ("loss_c", "loss_s", "loss_rec", "loss_tmp", "loss_tmp_gt",
            "loss_lap", "loss_total")
# "f64" is for reference runs: a float64 net, VGG and images
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The reference trainer's defaults."""

    style: float = 1.0
    content: float = 0.0
    lap: float = 1500.0
    rec: float = 10.0
    temporal: float = 60.0
    lap_clamp: float = 0.05
    noise_level: float = 0.001


def _l1(a, b):
    return (at_least_f32(a) - at_least_f32(b)).abs().mean()


class _Whole:
    """The step's terms on the whole image: every list holds one shard."""

    def __init__(self, net: RevResNet, vgg: VGG):
        self.net, self.vgg = net, vgg

    def encode(self, xs):
        return [self.net(xs[0])]

    def decode(self, zs):
        return [self.net.inverse(zs[0])]

    def transfer(self, zc, zs):
        return [cwct.transfer(zc[0], zs[0])]

    def vgg_losses(self, a, b, stylized, content_weight):
        return vgg_losses(self.vgg, a[0], b[0], stylized[0], n_layer=4,
                          content_weight=content_weight)

    def l1(self, xs, ys):
        return _l1(xs[0], ys[0])

    def warp(self, xs, flow):
        return [flow_warp_nearest(xs[0], flow[0])]

    def matting(self, images, xs):
        per_sample, grad = matting_loss_and_grad(images[0], xs[0])
        return per_sample, [grad]


class _Rows:
    """The step's terms on an image batch split by rows over one data
    row's devices: lists of row shards in row order; losses on the first
    shard's device."""

    def __init__(self, net: RevResNet, vgg: VGG):
        self.net, self.vgg = net, vgg

    def encode(self, xs):
        return forward_rows(self.net, xs)

    def decode(self, zs):
        return inverse_rows(self.net, zs)

    def transfer(self, zc, zs):
        return cwct.transfer_rows(zc, *cwct.style_factors_rows(zs))

    def vgg_losses(self, a, b, stylized, content_weight):
        return vgg_losses_rows(self.vgg, a, b, stylized, n_layer=4,
                               content_weight=content_weight)

    def l1(self, xs, ys):
        dev = xs[0].device
        total = sum((at_least_f32(x) - at_least_f32(y)).abs().sum().to(dev)
                    for x, y in zip(xs, ys))
        return total / sum(x.numel() for x in xs)

    def warp(self, xs, flow):
        """Each shard's output rows, read from the whole frame gathered
        to its device (the flow may reach any row); the gather carries
        the gradient back to the shards."""
        out, row0, wholes = [], 0, {}
        for f in flow:
            if f.device not in wholes:
                wholes[f.device] = torch.cat(
                    [x.to(f.device, non_blocking=True) for x in xs], dim=1)
            out.append(flow_warp_nearest(wholes[f.device], f, row0))
            row0 += f.shape[1]
        return out

    def matting(self, images, xs):
        return matting_loss_and_grad_rows(images, xs)


def _forward_losses(o, images_a, images_b, weights: LossWeights, flow,
                    noise, temporal_phase: bool):
    """((total, stylized shards), aux dict) through the terms `o` (_Whole
    or _Rows); images, flow and noise are lists of shards."""
    z_c = o.encode(images_a)
    z_s = o.encode(images_b)
    stylized = o.decode(o.transfer(z_c, z_s))
    loss_c, loss_s = o.vgg_losses(images_a, images_b, stylized,
                                  weights.content)
    zero = torch.zeros((), device=stylized[0].device)

    loss_rec = zero
    if weights.rec > 0:
        rec = o.decode(o.transfer(o.encode(stylized), z_c))
        loss_rec = o.l1(rec, images_a)

    loss_tmp = loss_tmp_gt = zero
    if temporal_phase:
        # the fake second frame: the content warped by the flow plus noise
        warped_a = o.warp(images_a, flow)
        second = [(at_least_f32(w) + n).to(w.dtype)
                  for w, n in zip(warped_a, noise)]
        stylized2 = o.decode(o.transfer(o.encode(second), z_s))
        loss_tmp = o.l1(o.warp(stylized, flow), stylized2)
        loss_tmp_gt = o.l1(warped_a, second)

    total = (weights.content * loss_c + weights.style * loss_s
             + weights.rec * loss_rec + weights.temporal * loss_tmp)
    aux = {"loss_c": loss_c, "loss_s": loss_s, "loss_rec": loss_rec,
           "loss_tmp": loss_tmp, "loss_tmp_gt": loss_tmp_gt}
    return (total, stylized), aux


def forward_losses(net: RevResNet, vgg: VGG, images_a, images_b,
                   weights: LossWeights, flow=None, noise=None,
                   temporal_phase: bool = False):
    """((total, stylized), aux dict) with the autograd graph to the
    network's weights. Images in the working dtype; flow (B, H, W, 2) and
    noise (B, H, W, 3) are used in the temporal phase only."""
    (total, stylized), aux = _forward_losses(
        _Whole(net, vgg), [images_a], [images_b], weights, [flow],
        [noise], temporal_phase)
    return (total, stylized[0]), aux


def _loss_and_grads(o, net, images_a, images_b, weights, flow, noise,
                    temporal_phase, precision, shards):
    dt = DTYPES[precision]
    for p in net.parameters():
        p.grad = None
    (total, stylized), aux = _forward_losses(
        o, [x.to(dt) for x in images_a], [x.to(dt) for x in images_b],
        weights, flow, noise, temporal_phase)

    if weights.lap > 0:
        lap_per_sample, lap_grads = o.matting(images_a, stylized)
        cotangents = []
        for g, st in zip(lap_grads, stylized):
            c = (g * weights.lap).clamp(-weights.lap_clamp,
                                        weights.lap_clamp)
            if shards != 1:
                c = c * shards
            cotangents.append(c.to(st.dtype))
        aux["loss_lap"] = lap_per_sample.mean()
    else:
        cotangents = [torch.zeros_like(st) for st in stylized]
        aux["loss_lap"] = torch.zeros((), device=total.device)

    torch.autograd.backward((total, *stylized),
                            (torch.ones_like(total), *cotangents))
    aux["loss_total"] = total
    grads = {n: p.grad for n, p in net.named_parameters()}
    return grads, {k: at_least_f32(aux[k].detach()) for k in AUX_KEYS}


def loss_and_grads(net: RevResNet, vgg: VGG, images_a, images_b,
                   weights: LossWeights, flow=None, noise=None,
                   temporal_phase: bool = False, precision: str = "f32",
                   shards: int = 1):
    """One forward and one backward: (grads {name: tensor}, aux {AUX_KEYS:
    float32 scalar}). The gradients are also left in each parameter's
    .grad, replacing what was there. images_a, images_b (B, H, W, 3)
    float32 in [0,1].

    shards > 1: this batch is one of `shards` equal parts of a global
    batch, whose gradient is the mean of the parts' gradients
    (parallel/sharding.parallel_train_step). Every loss term is a mean
    over the batch except the matting term, whose cotangent is one
    per-sample gradient per image, a sum over the batch: it is scaled by
    `shards` here so that the mean holds for it too. The aux losses are
    this part's means."""
    return _loss_and_grads(_Whole(net, vgg), net, [images_a], [images_b],
                           weights, [flow], [noise], temporal_phase,
                           precision, shards)


def loss_and_grads_rows(net: RevResNet, vgg: VGG, images_a, images_b,
                        weights: LossWeights, flow=None, noise=None,
                        temporal_phase: bool = False,
                        precision: str = "f32", shards: int = 1):
    """loss_and_grads of the image batch whose rows are split over one
    data row's devices: images_a, images_b (and flow, noise in the
    temporal phase) are lists of NHWC row shards in row order, shard k on
    the row's k-th device (parallel/sharding.shard_batch(spatial=True)
    gives them). net and vgg lie on the first device, where the gradients
    (every shard's part summed into the parameters' .grad) and the aux
    losses, the whole batch's means, land.

    The image height over the S shards must divide into rows that are a
    multiple of 8 with at least 16 a shard (VGG's three pools before
    relu4_1; the image's height a multiple of 8 * S), and of the net's
    down_scale with 2 rows a shard at 1/down_scale; ValueError otherwise.
    shards: the number of data rows, whose batches make up the global
    batch (the matting cotangent's scale, as in loss_and_grads): a row
    shard's matting cotangent is part of its sample's gradient, not a
    further sample."""
    return _loss_and_grads(_Rows(net, vgg), net, list(images_a),
                           list(images_b), weights, flow, noise,
                           temporal_phase, precision, shards)
