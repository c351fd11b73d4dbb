"""Checkpoint interop for the port.

Counterpart of vstnet_tpu/io/checkpoint.py. The reference checkpoints are
torch state_dicts with the key schema

    stack.{i}.conv.{1,4,7}.{weight,bias}                        i in 0..29
    channel_reduction.block_list.{i}.conv.{1,4,7}.{weight,bias}  i in 0..1

which models/revresnet.RevResNet reproduces, so they load with a plain
`load_state_dict`. Two loaders:

  * load_revresnet(path): a reference .pt/.pth file, bare or wrapped in
    {"state_dict": ...};
  * params_from_jax(tree): the JAX package's params pytree as numpy arrays
    (HWIO weights) -> the same state dict (OIHW weights).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_SEQ_IDX = {"conv1": 1, "conv2": 4, "conv3": 7}


def load_revresnet(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference-format checkpoint into a RevResNet state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def _branch(out, branch, prefix: str):
    for name, idx in _SEQ_IDX.items():
        w = np.asarray(branch[name]["w"], dtype=np.float32)  # HWIO
        out[f"{prefix}.conv.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))     # OIHW
        out[f"{prefix}.conv.{idx}.bias"] = torch.from_numpy(
            np.array(branch[name]["b"], dtype=np.float32))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX params {"stack": [...], "reduction": [...]} (numpy arrays or
    anything np.asarray takes) -> RevResNet state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i, bp in enumerate(tree["stack"]):
        _branch(out, bp, f"stack.{i}")
    for i, bp in enumerate(tree["reduction"]):
        _branch(out, bp, f"channel_reduction.block_list.{i}")
    return out
