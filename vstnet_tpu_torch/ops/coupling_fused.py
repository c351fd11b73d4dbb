"""The coupling block (K1) and the stride-2 transition (K2) as kernels.

Counterpart of vstnet_tpu/ops/coupling_flat.py (fused_coupling_flat and
fused_transition_full). The kernels are CUDA C++ for Hopper in
`csrc/coupling.cu` and `csrc/transition.cu`, built at first use by
`ops/_build.py`. Beside each kernel is its plain PyTorch version, built
from ops/pad_conv.py with the same rounding points.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back from one to the other.
Each wrapper counts its kernel launches in a plain int attribute
(`fused_coupling.launches`, `fused_transition.launches`).
"""

from __future__ import annotations

import torch

from vstnet_tpu_torch.ops import _build
from vstnet_tpu_torch.ops.coupling import pixel_shuffle, pixel_unshuffle
from vstnet_tpu_torch.ops.pad_conv import residual_branch_nchw

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _pack(weights, dtype):
    """((w1, b1), (w2, b2), (w3, b3)) OIHW -> packed dict.

    "w": the same tuple as float32 tensors holding `dtype`-rounded values
    (the plain version's weights); "flat": the kernels' layout, one float32
    vector w1 [Cin][3][3][M], b1, w2 [M][3][3][M], b2, w3 [M][3][3][Cout],
    b3."""
    rounded = tuple(
        (w.detach().to(dtype).float(), b.detach().to(dtype).float())
        for w, b in weights)
    flat = torch.cat([t for w, b in rounded
                      for t in (w.permute(1, 2, 3, 0).reshape(-1), b)])
    (w1, _), (w2, _), (w3, _) = rounded
    return {"w": rounded, "flat": flat.contiguous(), "dtype": dtype,
            "cin": w1.shape[1], "mid": w1.shape[0], "cout": w3.shape[0]}


def pack_coupling_weights(weights, dtype=torch.float32):
    """Stride-1 branch weights (C -> C/4 -> C/4 -> C) in the K1 layout."""
    packed = _pack(weights, dtype)
    if packed["cin"] != packed["cout"]:
        raise ValueError(f"coupling branch must map C -> C, got "
                         f"{packed['cin']} -> {packed['cout']}")
    return packed


def pack_transition_weights(weights, dtype=torch.float32):
    """Stride-2 branch weights (C -> M -> M -> 4C) in the K2 layout."""
    packed = _pack(weights, dtype)
    if packed["cout"] != 4 * packed["cin"]:
        raise ValueError(f"transition branch must map C -> 4C, got "
                         f"{packed['cin']} -> {packed['cout']}")
    return packed


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the kernels' test oracle
# ---------------------------------------------------------------------------

def coupling_block_plain(x1, x2, w, inverse: bool = False):
    """x1 + F(x2) (or x1 - F(x2)), summed in float32 and rounded once."""
    fx = residual_branch_nchw(x2, w["w"], 1)
    y = x1.float() - fx if inverse else x1.float() + fx
    return y.to(x1.dtype)


def transition_block_plain(a, b, w, inverse: bool = False):
    """Forward: (a, b) = (x1, x2) full-res -> (u(x2), F(x2) + u(x1)).
    Inverse: (a, b) = (y2, y1) half-res -> (s(y2 - F(s(y1))), s(y1)).
    u/s are pixel_unshuffle/pixel_shuffle; F's conv1 has stride 2."""
    if not inverse:
        fx = residual_branch_nchw(b, w["w"], 2)
        return (pixel_unshuffle(b),
                (fx + pixel_unshuffle(a).float()).to(a.dtype))
    x2 = pixel_shuffle(b)
    fx = residual_branch_nchw(x2, w["w"], 2)
    return pixel_shuffle((a.float() - fx).to(a.dtype)), x2


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, tensors, w):
    ref = tensors[0]
    if not ref.is_cuda:
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got "
                         f"{ref.device}")
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {ref.dtype} not in {_KERNEL_DTYPES}")
    for t in tensors:
        if (t.device != ref.device or t.dtype != ref.dtype
                or t.shape != ref.shape or t.dim() != 4
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: inputs must be contiguous 4-d tensors of one "
                f"shape, dtype and device; got {t.shape} {t.dtype} "
                f"{t.device} contiguous={t.is_contiguous()}")
    flat = w["flat"]
    if flat.device != ref.device or flat.dtype != torch.float32:
        raise ValueError(f"{name}: packed weights must be float32 on "
                         f"{ref.device}, got {flat.dtype} on {flat.device}")
    if w["dtype"] != ref.dtype:
        raise ValueError(f"{name}: weights packed for {w['dtype']}, "
                         f"activations are {ref.dtype}")


def fused_coupling(x1, x2, w, inverse: bool = False):
    """One coupling block: x1 + F(x2), or x1 - F(x2) with inverse=True.

    x1, x2: NCHW (B, C, H, W); w from pack_coupling_weights."""
    if x2.device.type == "cpu":
        return coupling_block_plain(x1, x2, w, inverse)
    _check("fused_coupling", (x1, x2), w)
    b, c, h, wd = x1.shape
    if c != w["cin"]:
        raise ValueError(f"fused_coupling: {c} channels, weights for "
                         f"{w['cin']}")
    out = torch.empty_like(x1)
    lib = _build.load()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vst_coupling(
            x1.data_ptr(), x2.data_ptr(), w["flat"].data_ptr(),
            out.data_ptr(), b, c, w["mid"], h, wd, int(inverse),
            int(x1.dtype == torch.bfloat16), stream)
    _build.check(err, "fused_coupling")
    fused_coupling.launches += 1
    return out


fused_coupling.launches = 0


def fused_transition(a, b, w, inverse: bool = False):
    """The stride-2 transition with the pixel (un)shuffle in the kernel.

    Forward: a = x1, b = x2, NCHW (B, C, 2h, 2w) -> (u(x2), F(x2) + u(x1)),
    each (B, 4C, h, w). Inverse: a = y2, b = y1, (B, 4C, h, w) ->
    (x1, x2) at (B, C, 2h, 2w). w from pack_transition_weights."""
    if b.device.type == "cpu":
        return transition_block_plain(a, b, w, inverse)
    _check("fused_transition", (a, b), w)
    bsz = a.shape[0]
    c = w["cin"]
    if inverse:
        if a.shape[1] != 4 * c:
            raise ValueError(f"fused_transition: {a.shape[1]} channels, "
                             f"weights for {4 * c}")
        h, wd = a.shape[2], a.shape[3]
        out_shape = (bsz, c, 2 * h, 2 * wd)
    else:
        if a.shape[1] != c or a.shape[2] % 2 or a.shape[3] % 2:
            raise ValueError(f"fused_transition: need {c} channels and even "
                             f"H, W; got {tuple(a.shape)}")
        h, wd = a.shape[2] // 2, a.shape[3] // 2
        out_shape = (bsz, 4 * c, h, wd)
    out0 = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    out1 = torch.empty_like(out0)
    lib = _build.load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vst_transition(
            a.data_ptr(), b.data_ptr(), w["flat"].data_ptr(),
            out0.data_ptr(), out1.data_ptr(), bsz, c, w["mid"], h, wd,
            int(inverse), int(a.dtype == torch.bfloat16), stream)
    _build.check(err, "fused_transition")
    fused_transition.launches += 1
    return out0, out1


fused_transition.launches = 0


def reset_launches() -> None:
    fused_coupling.launches = 0
    fused_transition.launches = 0
