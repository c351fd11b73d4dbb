"""The port's objects, built as its CLIs build them, from a configuration
file and the weights the harness made (never the port's own initialiser,
so that the reference gets the same weights without taking any from the
program)."""

from __future__ import annotations

import os

from benchmark.reference import revresnet as ref_rn
from benchmark.reference import segformer as ref_seg
from benchmark.core import synth

LABEL_TABLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference", "ade20k_semantic_rel.npy")


def revresnet_config(cfg: dict):
    from vstnet_tpu_torch.config import RevResNetConfig

    return RevResNetConfig(
        n_blocks=tuple(cfg["nBlocks"]), strides=tuple(cfg["nStrides"]),
        channels=tuple(cfg["nChannels"]), in_channel=cfg["in_channel"],
        mult=cfg["mult"], hidden_dim=cfg["hidden_dim"],
        sp_steps=cfg["sp_steps"], kernel=cfg["kernel"],
        reduction_blocks=cfg["reduction_blocks"])


def style_model(cfg: dict, seed: int, device):
    """(StyleModel with the seed's weights, the weights)."""
    from vstnet_tpu_torch.models.pipeline import StyleModel
    from vstnet_tpu_torch.models.revresnet import RevResNet

    weights = synth.weights(ref_rn.weight_shapes(cfg), seed, "revresnet",
                            device)
    rcfg = revresnet_config(cfg)
    net = RevResNet(rcfg, device=device)
    net.load_state_dict(weights)
    return StyleModel(cfg=rcfg, net=net, mode=cfg["mode"]), weights


def segmenter(cfg: dict, seed: int, device, min_ratio: float):
    """(Segmenter as the video CLI loads one from a checkpoint: float32
    weights, the bundled relation table, half=False for its own segment
    calls; the weights)."""
    from vstnet_tpu_torch.models.remapping import load_label_mapping
    from vstnet_tpu_torch.models.segformer import SegFormer, Segmenter

    weights = synth.weights(ref_seg.weight_shapes(cfg), seed, "segformer",
                            device)
    net = SegFormer(tuple(cfg["depths"]), device=device)
    net.load_state_dict(weights)
    seg = Segmenter(net=net, min_ratio=min_ratio,
                    label_mapping=load_label_mapping(LABEL_TABLE,
                                                     device=device),
                    half=False)
    return seg, weights
