"""Checkpoint interop for the port.

Counterpart of vstnet_tpu/io/checkpoint.py. The reference checkpoints are
torch state_dicts with the key schema

    stack.{i}.conv.{1,4,7}.{weight,bias}                        i in 0..29
    channel_reduction.block_list.{i}.conv.{1,4,7}.{weight,bias}  i in 0..1

which models/revresnet.RevResNet reproduces, so they load with a plain
`load_state_dict`; save_revresnet writes them. Two loaders:

  * load_revresnet(path): a reference .pt/.pth file, bare or wrapped in
    {"state_dict": ...}; strict=False fills what a foreign file lacks
    (tolerant_state_dict);
  * params_from_jax(tree): the JAX package's params pytree as numpy arrays
    (HWIO weights) -> the same state dict (OIHW weights).

The segmenter's checkpoints carry the reference SegFormer keys
(`backbone.*`, `decode_head.*`), which models/segformer.SegFormer
reproduces. Its two loaders are load_segformer(path) and
segformer_params_from_jax(tree): the JAX package's init_segformer pytree
(per-stage blocks stacked on a leading axis, (in, out) linear weights, HWIO
convs) -> that state dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_SEQ_IDX = {"conv1": 1, "conv2": 4, "conv3": 7}


def tolerant_state_dict(sd: Dict[str, torch.Tensor],
                        expected: Dict[str, torch.Tensor],
                        label: str = "checkpoint") -> Dict[str, torch.Tensor]:
    """A complete state dict from a foreign checkpoint: every expected
    tensor that is missing from `sd`, or present with another shape, keeps
    its `expected` value with a warning; tensors of `sd` that nothing
    expects are ignored with one summary warning."""
    import warnings

    out = {}
    for k, want in expected.items():
        if k not in sd:
            warnings.warn(f"{label}: missing tensor {k} — "
                          "keeping initialized value")
            out[k] = want
        elif tuple(sd[k].shape) != tuple(want.shape):
            warnings.warn(
                f"{label}: tensor {k} shape {tuple(sd[k].shape)} != "
                f"expected {tuple(want.shape)} — keeping initialized value")
            out[k] = want
        else:
            out[k] = sd[k]
    extra = sorted(set(sd) - set(expected))
    if extra:
        warnings.warn(f"{label}: {len(extra)} unused tensor(s) ignored "
                      f"(e.g. {extra[:3]})")
    return out


def load_revresnet(path: str, strict: bool = True, cfg=None,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """Read a reference-format checkpoint into a RevResNet state dict.

    strict=False loads a foreign checkpoint through tolerant_state_dict:
    missing and misshapen tensors keep the values of a RevResNet(cfg)
    initialised from `seed`, with warnings; cfg is then required."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = dict(sd)
    if strict:
        return sd
    if cfg is None:
        raise ValueError("strict=False needs cfg= to size the expected "
                         "weights")
    from vstnet_tpu_torch.models.revresnet import RevResNet

    net = RevResNet(cfg, device="cpu")
    net.init_weights(torch.Generator().manual_seed(seed))
    return tolerant_state_dict(sd, net.state_dict(), label=path)


def save_revresnet(model, path: str, wrap: bool = True):
    """Write a RevResNet's weights as a reference-format checkpoint:
    {"state_dict": ...} (bare with wrap=False), float32 CPU tensors in the
    reference key schema, which both packages' load_revresnet read."""
    sd = {k: v.detach().float().cpu().clone()
          for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd} if wrap else sd, path)


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


def load_segformer(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference-format SegFormer checkpoint into a state dict for
    models/segformer.SegFormer; BatchNorm's num_batches_tracked, which the
    port's frozen BatchNorm does not hold, is dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _f32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(out, p, prefix: str):
    out[f"{prefix}.weight"] = _f32(np.asarray(p["w"]).T)       # (out, in)
    out[f"{prefix}.bias"] = _f32(p["b"])


def _conv(out, p, prefix: str):
    out[f"{prefix}.weight"] = _f32(
        np.asarray(p["w"]).transpose(3, 2, 0, 1))             # HWIO -> OIHW
    if "b" in p:
        out[f"{prefix}.bias"] = _f32(p["b"])


def _ln(out, p, prefix: str):
    out[f"{prefix}.weight"] = _f32(p["g"])
    out[f"{prefix}.bias"] = _f32(p["b"])


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def segformer_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX params {"patch_embed": [...], "stages": [{"blocks": stacked,
    "norm": ...}, ...], "head": ...} (numpy arrays or anything np.asarray
    takes) -> SegFormer state dict. The stacked blocks of each stage are
    unstacked along their leading axis."""
    out: Dict[str, torch.Tensor] = {}
    for s, pe in enumerate(tree["patch_embed"]):
        _conv(out, pe["proj"], f"backbone.patch_embed{s + 1}.proj")
        _ln(out, pe["norm"], f"backbone.patch_embed{s + 1}.norm")
    for s, st in enumerate(tree["stages"]):
        depth = int(np.asarray(st["blocks"]["norm1"]["g"]).shape[0])
        for i in range(depth):
            blk = _index(st["blocks"], i)
            bp = f"backbone.block{s + 1}.{i}"
            _ln(out, blk["norm1"], f"{bp}.norm1")
            for name in ("q", "kv", "proj"):
                _lin(out, blk["attn"][name], f"{bp}.attn.{name}")
            if "sr" in blk["attn"]:
                _conv(out, blk["attn"]["sr"], f"{bp}.attn.sr")
                _ln(out, blk["attn"]["norm"], f"{bp}.attn.norm")
            _ln(out, blk["norm2"], f"{bp}.norm2")
            _lin(out, blk["mlp"]["fc1"], f"{bp}.mlp.fc1")
            _conv(out, blk["mlp"]["dw"], f"{bp}.mlp.dwconv.dwconv")
            _lin(out, blk["mlp"]["fc2"], f"{bp}.mlp.fc2")
        _ln(out, st["norm"], f"backbone.norm{s + 1}")
    head = tree["head"]
    for i, lc in enumerate(head["linear_c"]):
        _lin(out, lc, f"decode_head.linear_c{i + 1}.proj")
    _conv(out, {"w": head["fuse"]["w"]}, "decode_head.linear_fuse.conv")
    bn = head["fuse"]["bn"]
    for key, name in (("g", "weight"), ("b", "bias"),
                      ("mean", "running_mean"), ("var", "running_var")):
        out[f"decode_head.linear_fuse.bn.{name}"] = _f32(bn[key])
    _conv(out, head["pred"], "decode_head.linear_pred")
    return out
