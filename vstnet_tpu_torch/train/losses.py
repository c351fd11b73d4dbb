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
"""

from __future__ import annotations

import dataclasses

import torch

from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.vgg import VGG, vgg_losses
from vstnet_tpu_torch.ops import at_least_f32
from vstnet_tpu_torch.ops.matting import matting_loss_and_grad
from vstnet_tpu_torch.ops.warp import flow_warp_nearest

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


def forward_losses(net: RevResNet, vgg: VGG, images_a, images_b,
                   weights: LossWeights, flow=None, noise=None,
                   temporal_phase: bool = False):
    """((total, stylized), aux dict) with the autograd graph to the
    network's weights. Images in the working dtype; flow (B, H, W, 2) and
    noise (B, H, W, 3) are used in the temporal phase only."""
    z_c = net(images_a)
    z_s = net(images_b)
    stylized = net.inverse(cwct.transfer(z_c, z_s))
    loss_c, loss_s = vgg_losses(vgg, images_a, images_b, stylized,
                                n_layer=4, content_weight=weights.content)
    zero = torch.zeros((), device=stylized.device)

    loss_rec = zero
    if weights.rec > 0:
        z_cs2 = net(stylized)
        rec = net.inverse(cwct.transfer(z_cs2, z_c))
        loss_rec = _l1(rec, images_a)

    loss_tmp = loss_tmp_gt = zero
    if temporal_phase:
        # the fake second frame: the content warped by the flow plus noise
        warped_a = flow_warp_nearest(images_a, flow)
        second = (at_least_f32(warped_a) + noise).to(images_a.dtype)
        stylized2 = net.inverse(cwct.transfer(net(second), z_s))
        loss_tmp = _l1(flow_warp_nearest(stylized, flow), stylized2)
        loss_tmp_gt = _l1(warped_a, second)

    total = (weights.content * loss_c + weights.style * loss_s
             + weights.rec * loss_rec + weights.temporal * loss_tmp)
    aux = {"loss_c": loss_c, "loss_s": loss_s, "loss_rec": loss_rec,
           "loss_tmp": loss_tmp, "loss_tmp_gt": loss_tmp_gt}
    return (total, stylized), aux


def loss_and_grads(net: RevResNet, vgg: VGG, images_a, images_b,
                   weights: LossWeights, flow=None, noise=None,
                   temporal_phase: bool = False, precision: str = "f32"):
    """One forward and one backward: (grads {name: tensor}, aux {AUX_KEYS:
    float32 scalar}). The gradients are also left in each parameter's
    .grad, replacing what was there. images_a, images_b (B, H, W, 3)
    float32 in [0,1]."""
    dt = DTYPES[precision]
    for p in net.parameters():
        p.grad = None
    (total, stylized), aux = forward_losses(
        net, vgg, images_a.to(dt), images_b.to(dt), weights, flow, noise,
        temporal_phase)

    if weights.lap > 0:
        lap_per_sample, lap_grad = matting_loss_and_grad(images_a, stylized)
        lap_cotangent = (lap_grad * weights.lap).clamp(
            -weights.lap_clamp, weights.lap_clamp).to(stylized.dtype)
        aux["loss_lap"] = lap_per_sample.mean()
    else:
        lap_cotangent = torch.zeros_like(stylized)
        aux["loss_lap"] = torch.zeros((), device=stylized.device)

    torch.autograd.backward((total, stylized),
                            (torch.ones_like(total), lap_cotangent))
    aux["loss_total"] = total
    grads = {n: p.grad for n, p in net.named_parameters()}
    return grads, {k: at_least_f32(aux[k].detach()) for k in AUX_KEYS}
