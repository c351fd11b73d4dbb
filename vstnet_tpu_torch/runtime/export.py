"""Ahead-of-time export of fixed-shape programs (torch.export).

Counterpart of vstnet_tpu/runtime/export.py, the analogue of the
reference's ONNX export path: the encoder, the decoder and the segmenter,
each held to its live twin by an output-equivalence gate (rtol = atol =
0.01), plus the whole stylize program and the segment-and-render program.
Each exports the same function as the JAX package, in float32 at a fixed
shape: encode, cwct.transfer, decode; and segment_mask, then self-remap,
palette and blend. The float32 route reaches none of the port's kernels,
so the artifacts hold only PyTorch operators.

`device` takes the place of the JAX package's `platforms`: the program is
traced with its weights and example inputs on that device (None: the CUDA
card, device.resolve_device). `serialized=True` returns the bytes of
torch.export.save (a `.pt2` file); False returns the ExportedProgram.
Unlike a JAX artifact, a program is not bound to the device it was traced
on: load_exported and native.package_program move it. Its cWCT statistics
do not depend on that device either: they are summed in float64 in every
exported program (cwct._accumulate's export rule), as the card's eager
code sums them, so a program traced on the CPU and run on the card
computes what one traced on the card computes (the stylize program at
512x512: tests/test_torch_cuda.py::
test_program_exported_off_the_card_matches_the_card_export). Run on the
CPU, such a program sums in float64 where the eager CPU code sums in
float32.

An ExportedProgram does not carry torch.backends flags, and on a card
cuDNN's convs default to TF32 (the stylize artifact at 512x512 then lies
8.8e-4 to 1.2e-3 from true float32 on an H100 80GB HBM3 at 700 W). The
programs are traced with no TF32 context of their own, so `load_exported`
clears TF32 around each call.

The saved programs hold no example inputs. A compile needs them
(torch._inductor.aoti_compile_and_package), so `signature_inputs`
rebuilds zeros of the program's input signature, shapes and dtypes as it
was traced; runtime/native.py:package_program compiles from those.
"""

from __future__ import annotations

import copy
import io
import os

import numpy as np
import torch
from torch import nn
from torch.export.graph_signature import InputKind
from torch.utils import _pytree as pytree

from vstnet_tpu_torch.device import resolve_device
from vstnet_tpu_torch.models.pipeline import stylize
from vstnet_tpu_torch.models.remapping import (
    ade20k_palette,
    load_label_mapping,
    self_remapping,
)
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.models.segformer import segment_mask, true_f32


def _on(module: nn.Module, device: torch.device) -> nn.Module:
    """`module` in eval mode on `device` (a copy if it lies elsewhere)."""
    p = next(module.parameters(), None)
    if p is not None and p.device != device:
        module = copy.deepcopy(module).to(device)
    return module.eval()


def _export(module: nn.Module, args, serialized: bool):
    with torch.no_grad():
        ep = torch.export.export(module, args)
    # the example inputs (zeros) would be saved with the program;
    # signature_inputs rebuilds them where a compile needs them
    ep.example_inputs = None
    if not serialized:
        return ep
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def signature_inputs(ep, device=None):
    """(args, kwargs) of zeros that match the program's user inputs, in the
    shapes and dtypes it was traced with, on `device` (None: where the
    program's signature says)."""
    user = {s.arg.name for s in ep.graph_signature.input_specs
            if s.kind == InputKind.USER_INPUT}
    leaves = [torch.zeros(tuple(n.meta["val"].shape),
                          dtype=n.meta["val"].dtype,
                          device=device or n.meta["val"].device)
              for n in ep.graph.nodes
              if n.op == "placeholder" and n.name in user]
    return pytree.tree_unflatten(leaves, ep.call_spec.in_spec)


def _image(batch, h, w, device):
    return torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device)


class _Call(nn.Module):
    """forward(*args) = fn(net, *args), with `net` a submodule, so that its
    weights are the program's parameters."""

    def __init__(self, net, fn):
        super().__init__()
        self.net = net
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.net, *args)


class _WeightsAsInputs(nn.Module):
    """forward(params, *args): `inner` (a _Call) run with its network's
    weights taken from `params` (a RevResNet state dict) by
    torch.func.functional_call. The module holds `inner` on the meta
    device, outside its own parameters, so the program stores no
    weights."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self._inner = (inner,)

    def forward(self, params, *args):
        inner = self._inner[0]
        return torch.func.functional_call(
            inner, {f"net.{k}": v for k, v in params.items()}, args)


class _SegmentRender(nn.Module):
    def __init__(self, seg_net, mapping, palette, blend, min_ratio):
        super().__init__()
        self.net = seg_net
        self.register_buffer("mapping", mapping)
        self.register_buffer("palette", palette)
        self.blend = float(blend)
        self.min_ratio = float(min_ratio)

    def forward(self, x):
        m = self_remapping(segment_mask(self.net, x), self.mapping,
                           self.min_ratio)
        color = self.palette[m.long().clamp(0, self.palette.shape[0] - 1)]
        return (self.blend * color + (1.0 - self.blend) * x).clamp(0.0, 1.0)


def export_stylize(net, cfg, h: int, w: int, batch: int = 1,
                   bake_weights: bool = True, device=None,
                   serialized: bool = False):
    """-> (artifact, out_shape). The whole stylize program, encode(c),
    encode(s), cWCT, decode, at a fixed shape. bake_weights=False exports
    fn(params, content, style), params a RevResNet state dict (reference
    key names), so that one artifact serves any weights of cfg."""
    device = resolve_device(device)
    # two tensors: given one tensor twice, torch.export would alias the
    # content and the style into one input
    images = (_image(batch, h, w, device), _image(batch, h, w, device))
    if bake_weights:
        artifact = _export(_Call(_on(net, device), stylize), images,
                           serialized)
    else:
        params = {k: v.detach().to(device, torch.float32)
                  for k, v in net.state_dict().items()}
        inner = _Call(RevResNet(cfg, device="meta"), stylize)
        artifact = _export(_WeightsAsInputs(inner), (params, *images),
                           serialized)
    return artifact, (batch, h, w, 3)


def _latent_shape(cfg, h: int, w: int):
    ls = cfg.latent_scale
    return h // ls, w // ls, cfg.latent_channels


def export_encoder(net, cfg, h: int, w: int, batch: int = 1, device=None,
                   serialized: bool = False):
    """Encoder artifact: image (batch, h, w, 3) -> latent."""
    device = resolve_device(device)
    artifact = _export(_Call(_on(net, device), RevResNet.encode),
                       (_image(batch, h, w, device),), serialized)
    return artifact, (batch, *_latent_shape(cfg, h, w))


def export_decoder(net, cfg, h: int, w: int, batch: int = 1, device=None,
                   serialized: bool = False):
    """Decoder artifact. h, w are IMAGE dims; the input is the matching
    latent."""
    device = resolve_device(device)
    z = torch.zeros((batch, *_latent_shape(cfg, h, w)), dtype=torch.float32,
                    device=device)
    artifact = _export(_Call(_on(net, device), RevResNet.decode), (z,),
                       serialized)
    return artifact, (batch, h, w, 3)


def export_segmenter(seg_net, h: int, w: int, batch: int = 1, device=None,
                     serialized: bool = False):
    """SegFormer mask artifact: image -> the int32 ADE20K label mask
    (batch, h, w), float32 backbone and head."""
    device = resolve_device(device)
    artifact = _export(_Call(_on(seg_net, device), segment_mask),
                       (_image(batch, h, w, device),), serialized)
    return artifact, (batch, h, w)


def export_segment_render(seg_net, h: int, w: int, blend: float = 0.5,
                          min_ratio: float = 0.02, device=None,
                          serialized: bool = False, label_mapping=None,
                          palette=None):
    """Segment-and-render artifact, the reference native binary's whole
    job in one program: segment -> self-remap (hole removal) -> palette
    colour -> blend, with the ADE20K relation table and palette held in
    the program. Output (1, h, w, 3) float32 in [0, 1]: blend * colour +
    (1 - blend) * input; blend=1.0 gives the pure label-colour render."""
    device = resolve_device(device)
    mapping = (load_label_mapping() if label_mapping is None
               else torch.as_tensor(label_mapping, dtype=torch.int64))
    pal = torch.from_numpy(np.asarray(
        ade20k_palette() if palette is None else palette, np.float32)) / 255.0
    module = _SegmentRender(_on(seg_net, device), mapping.to(device),
                            pal.to(device), blend, min_ratio)
    artifact = _export(module, (_image(1, h, w, device),), serialized)
    return artifact, (1, h, w, 3)


def save_exported(path: str, artifact: bytes):
    """Write an artifact's bytes (serialized=True) to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(artifact)
    return path


def load_exported(path_or_bytes, device=None):
    """A `.pt2` file (path or bytes) -> fn(*args): the program moved to
    `device` (None: the CUDA card) and called without autograd, with TF32
    cleared for cuDNN and matmuls during the call."""
    from torch.export.passes import move_to_device_pass

    src = path_or_bytes
    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(src)
    ep = move_to_device_pass(torch.export.load(src), resolve_device(device))
    module = ep.module()

    def call(*args):
        with torch.no_grad(), true_f32():
            return module(*args)

    return call
