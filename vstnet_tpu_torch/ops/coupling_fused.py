"""The coupling block (K1) and the stride-2 transition (K2, K3) as kernels.

Counterpart of vstnet_tpu/ops/coupling_flat.py (fused_coupling_flat,
fused_transition_full and fused_transition_flat). The kernels are CUDA C++
for Hopper in `csrc/coupling.cu`, `csrc/coupling_mma.cu`,
`csrc/transition.cu` and `csrc/transition_mma.cu`, built at first use by
`ops/_build.py`. Beside each
kernel is its plain PyTorch version, built from ops/pad_conv.py with the
same rounding points. K2 takes and returns full-resolution streams and does
the pixel (un)shuffle inside; K3 (`fused_transition_half`) is the same
block on streams the caller has already unshuffled to half resolution.

K1 has two routes, chosen by `coupling_route(dtype, C, M)` alone: bf16 at
the widths C=256/M=64, C=64/M=16 and C=16/M=4 runs on the tensor cores
(`csrc/coupling_mma.cu`, weights as bf16 pieces or fragments from
`pack_coupling_mma`); float32 at every width, and bf16 at any other width,
run on the CUDA cores (`csrc/coupling.cu`). float32 stays off the tensor
cores because a float32 product there would be TF32. K2 and K3 have the
same two routes, chosen by `transition_route(dtype, C, M)`: bf16 at
C=M=64 and C=M=16 on the tensor cores (`csrc/transition_mma.cu`, pieces
from `pack_transition_mma`), everything else on the CUDA cores
(`csrc/transition.cu`).

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel or raises. Nothing falls back from one to the other.
Each kernel's launches are counted in a plain int attribute of its wrapper,
raised where that kernel is launched and nowhere else: K1's two kernels
apart (`fused_coupling.fma_launches` for `csrc/coupling.cu`,
`fused_coupling.mma_launches` for `csrc/coupling_mma.cu`;
`coupling_launches()` is their sum; of the latter, `fused_coupling.
wg_launches` counts those at C=256/M=64, which run on the warpgroup
products, `coupling_mma_wg_kernel`), and the same pair of attributes on
`fused_transition` and on `fused_transition_half` for `csrc/transition.cu`
and `csrc/transition_mma.cu`.
"""

from __future__ import annotations

import collections
import contextlib

import torch

from vstnet_tpu_torch.ops import _build, count_launch
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


# (C, M) widths the tensor-core coupling kernels are built for. C=64/M=16
# runs on coupling_mma_kernel (mma.sync) with pieces of _MMA_KC1 input
# channels of conv1, of at most _MMA_KC of conv2 and conv3, and of
# _MMA_NC3 output channels of conv3 (csrc/coupling_mma.cu: MmaCfg); the
# narrow width, whose weights are packed as fragments; and the widest,
# which runs on the warpgroup products (coupling_mma_wg_kernel) with
# pieces of 16 input channels (_WG_KC) laid out as wgmma's B operand
MMA_WIDTHS = ((256, 64), (64, 16), (16, 4))
MMA_NARROW = (16, 4)
MMA_WG = (256, 64)
_MMA_KC1 = 32
_MMA_KC = 32
_MMA_NC3 = 64
_WG_KC = 16


def coupling_route(dtype, c: int, m: int) -> str:
    """Which K1 kernel takes (dtype, C, M): "mma" (tensor cores, bf16 at the
    widths of MMA_WIDTHS) or "fma" (CUDA cores: float32, and bf16 at every
    other width). A function of its arguments only, the same for every
    call."""
    if dtype == torch.bfloat16 and (c, m) in MMA_WIDTHS:
        return "mma"
    return "fma"


# (C, M) widths the tensor-core transition kernel is built for, and its
# piece sizes: input channels per piece of every conv, output channels per
# piece of conv3 (csrc/transition_mma.cu: kTKC, kTNC3)
TRANSITION_MMA_WIDTHS = ((64, 64), (16, 16))
_TR_KC = 16
_TR_NC3 = 64


def transition_route(dtype, c: int, m: int) -> str:
    """Which K2/K3 kernel takes (dtype, C, M): "mma" (tensor cores, bf16 at
    the widths of TRANSITION_MMA_WIDTHS) or "fma" (CUDA cores: float32, and
    bf16 at every other width). A function of its arguments only."""
    if dtype == torch.bfloat16 and (c, m) in TRANSITION_MMA_WIDTHS:
        return "mma"
    return "fma"


def _mma_piece_shapes(c: int, m: int):
    """(ci per piece, co per piece) of conv1, conv2, conv3."""
    if (c, m) == MMA_WG:
        return (_WG_KC, m), (_WG_KC, m), (_WG_KC, _MMA_NC3)
    kc = min(_MMA_KC, m)
    return (_MMA_KC1, m), (kc, m), (kc, _MMA_NC3)


def _to_pieces(w, kc: int, nc: int):
    """OIHW (Cout, Cin, 3, 3) -> [co chunk][ci chunk][tap][ci][co], flat."""
    cout, cin = w.shape[:2]
    t = w.permute(2, 3, 1, 0).reshape(9, cin // kc, kc, cout // nc, nc)
    return t.permute(3, 1, 0, 2, 4).reshape(-1)


def _from_pieces(flat, cout: int, cin: int, kc: int, nc: int):
    """Inverse of _to_pieces: flat -> OIHW (Cout, Cin, 3, 3)."""
    t = flat.reshape(cout // nc, cin // kc, 9, kc, nc).permute(2, 1, 3, 0, 4)
    return t.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def _to_wg_pieces(w, kc: int, nc: int):
    """OIHW -> coupling_mma_wg_kernel's pieces, flat: [co chunk][ci chunk]
    [tap][k-step of 16 ci][co / 8][ci / 8 of the k-step][co % 8][ci % 8].
    A (tap, k-step) is one k-block of wgmma's B, K-major core matrices of
    8 output x 8 input channels, 128 contiguous bytes each
    (csrc/wgmma.cuh)."""
    cout, cin = w.shape[:2]
    t = w.permute(2, 3, 1, 0).reshape(9, cin // kc, kc // 16, 2, 8,
                                      cout // nc, nc // 8, 8)
    return t.permute(5, 1, 0, 2, 6, 3, 7, 4).reshape(-1)


def _from_wg_pieces(flat, cout: int, cin: int, kc: int, nc: int):
    """Inverse of _to_wg_pieces: flat -> OIHW (Cout, Cin, 3, 3)."""
    t = flat.reshape(cout // nc, cin // kc, 9, kc // 16, nc // 8, 2, 8, 8)
    t = t.permute(2, 1, 3, 5, 7, 0, 4, 6)
    return t.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def _narrow_matrix(w, ci_pad: int, co_pad: int, taps: int):
    """OIHW -> the narrow kernel's B matrix [taps * ci_pad][co_pad], row
    tap * ci_pad + ci, zero where ci, co or the tap is padding."""
    cout, cin = w.shape[:2]
    b = w.new_zeros((taps, ci_pad, co_pad))
    b[:9, :cin, :cout] = w.permute(2, 3, 1, 0).reshape(9, cin, cout)
    return b.reshape(taps * ci_pad, co_pad)


def _from_narrow_matrix(b, cout: int, cin: int, ci_pad: int):
    t = b.reshape(-1, ci_pad, b.shape[1])[:9, :cin, :cout]
    return t.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def _to_fragments(b):
    """B (K, N) -> mma.sync.m16n8k16 B fragments, [k-step][n-tile][lane]
    [register][element]: lane 4g + t holds rows 2t, 2t+1 (register 0) and
    2t+8, 2t+9 (register 1) of column g of its 16 x 8 block."""
    k, n = b.shape
    t = b.reshape(k // 16, 2, 4, 2, n // 8, 8)     # ks, reg, t, elem, nt, g
    return t.permute(0, 4, 5, 2, 1, 3).reshape(-1)


def _from_fragments(flat, k: int, n: int):
    t = flat.reshape(k // 16, n // 8, 8, 4, 2, 2)  # ks, nt, g, t, reg, elem
    return t.permute(0, 4, 3, 5, 1, 2).reshape(k, n)


# the narrow kernel's B matrices: (ci padded to, co padded to, taps padded
# to) of conv1, conv2, conv3; conv2 and conv3 take two taps of 8 padded
# channels per k-step, so their nine taps are padded to ten
_NARROW_PADS = ((16, 8, 9), (8, 8, 10), (8, 16, 10))


def pack_coupling_mma(rounded):
    """The tensor-core kernel's weights as one bf16 vector. At the wide
    widths: pieces, each [tap][ci][co] for a chunk of input and output
    channels, in the order the kernel streams them (conv1 by input chunk;
    conv2 by input chunk; conv3 by output chunk, then input chunk). At the
    narrow width: every conv's zero-padded B matrix as per-lane fragments.
    At MMA_WG the same pieces, each as wgmma's B (_to_wg_pieces). `rounded`
    holds bf16-rounded values as float32 (_pack's "w"), so the bf16 copy is
    exact."""
    (w1, _), (w2, _), (w3, _) = rounded
    width = (w1.shape[1], w1.shape[0])
    if width == MMA_NARROW:
        return torch.cat([
            _to_fragments(_narrow_matrix(w, *pads))
            for w, pads in zip((w1, w2, w3), _NARROW_PADS)]).to(
                torch.bfloat16).contiguous()
    to_pieces = _to_wg_pieces if width == MMA_WG else _to_pieces
    shapes = _mma_piece_shapes(*width)
    return torch.cat([to_pieces(w, kc, nc) for w, (kc, nc)
                      in zip((w1, w2, w3), shapes)]).to(
                          torch.bfloat16).contiguous()


def unpack_coupling_mma(pieces, c: int, m: int):
    """pack_coupling_mma's vector -> (w1, w2, w3) OIHW as float32."""
    out, at = [], 0
    if (c, m) == MMA_NARROW:
        for (cout, cin), (ci_pad, co_pad, taps) in zip(
                ((m, c), (m, m), (c, m)), _NARROW_PADS):
            k = taps * ci_pad
            b = _from_fragments(pieces[at:at + k * co_pad].float(), k, co_pad)
            out.append(_from_narrow_matrix(b, cout, cin, ci_pad))
            at += k * co_pad
        return tuple(out)
    from_pieces = _from_wg_pieces if (c, m) == MMA_WG else _from_pieces
    for (cout, cin), (kc, nc) in zip(((m, c), (m, m), (c, m)),
                                     _mma_piece_shapes(c, m)):
        n = cout * cin * 9
        out.append(from_pieces(pieces[at:at + n].float(), cout, cin, kc, nc))
        at += n
    return tuple(out)


def _transition_piece_shapes(m: int):
    """(ci per piece, co per piece) of conv1, conv2, conv3."""
    return (_TR_KC, m), (_TR_KC, m), (_TR_KC, _TR_NC3)


def pack_transition_mma(rounded):
    """The tensor-core transition kernel's weights as one bf16 vector of
    pieces, each [tap][ci][co] for 16 input channels, in the order the
    kernel streams them (conv1 and conv2 by input chunk; conv3 by output
    chunk of 64, then input chunk). `rounded` holds bf16-rounded values as
    float32 (_pack's "w"), so the bf16 copy is exact."""
    (w1, _), (w2, _), (w3, _) = rounded
    return torch.cat([_to_pieces(w, kc, nc) for w, (kc, nc) in zip(
        (w1, w2, w3), _transition_piece_shapes(w1.shape[0]))]).to(
            torch.bfloat16).contiguous()


def unpack_transition_mma(pieces, c: int, m: int):
    """pack_transition_mma's vector -> (w1, w2, w3) OIHW as float32."""
    out, at = [], 0
    for (cout, cin), (kc, nc) in zip(((m, c), (m, m), (4 * c, m)),
                                     _transition_piece_shapes(m)):
        n = cout * cin * 9
        out.append(_from_pieces(pieces[at:at + n].float(), cout, cin, kc, nc))
        at += n
    return tuple(out)


def pack_coupling_weights(weights, dtype=torch.float32):
    """Stride-1 branch weights (C -> C/4 -> C/4 -> C) in the K1 layouts:
    "flat" for the CUDA-core kernel (and the biases of both), and "mma",
    the bf16 pieces, where coupling_route sends this block to the
    tensor-core kernel."""
    packed = _pack(weights, dtype)
    if packed["cin"] != packed["cout"]:
        raise ValueError(f"coupling branch must map C -> C, got "
                         f"{packed['cin']} -> {packed['cout']}")
    if coupling_route(dtype, packed["cin"], packed["mid"]) == "mma":
        packed["mma"] = pack_coupling_mma(packed["w"])
    return packed


def pack_transition_weights(weights, dtype=torch.float32):
    """Stride-2 branch weights (C -> M -> M -> 4C) in the K2/K3 layouts:
    "flat" for the CUDA-core kernel (and the biases of both), and "mma",
    the bf16 pieces, where transition_route sends this block to the
    tensor-core kernel."""
    packed = _pack(weights, dtype)
    if packed["cout"] != 4 * packed["cin"]:
        raise ValueError(f"transition branch must map C -> 4C, got "
                         f"{packed['cin']} -> {packed['cout']}")
    if transition_route(dtype, packed["cin"], packed["mid"]) == "mma":
        packed["mma"] = pack_transition_mma(packed["w"])
    return packed


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the kernels' test oracle
# ---------------------------------------------------------------------------

def coupling_block_plain(x1, x2, w, inverse: bool = False):
    """x1 + F(x2) (or x1 - F(x2)), summed in float32 and rounded once."""
    fx = residual_branch_nchw(x2, w["w"], 1)
    y = x1.float() - fx if inverse else x1.float() + fx
    return y.to(x1.dtype)


@contextlib.contextmanager
def _kernel_sum_order(x):
    """cuDNN off for the block when x is a float32 CUDA tensor.

    The float32 transition kernel sums every output over (ci, ky, kx), one
    fmaf each, in that order. So does PyTorch's own im2col + GEMM conv, at
    every frame size of the video paths. cuDNN picks its algorithm by
    shape: at the 640x360 T2 shape it takes an FFT for conv2, whose sums
    differ in the last bit. With cuDNN off, the float32 plain version
    equals the kernel bit for bit (scripts/torch_k2k3_f32_order.py)."""
    saved = torch.backends.cudnn.enabled
    if x.is_cuda and x.dtype == torch.float32:
        torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def transition_block_plain(a, b, w, inverse: bool = False):
    """Forward: (a, b) = (x1, x2) full-res -> (u(x2), F(x2) + u(x1)).
    Inverse: (a, b) = (y2, y1) half-res -> (s(y2 - F(s(y1))), s(y1)).
    u/s are pixel_unshuffle/pixel_shuffle; F's conv1 has stride 2. float32
    on a CUDA tensor sums in the kernel's order (_kernel_sum_order)."""
    x2 = pixel_shuffle(b) if inverse else b
    with _kernel_sum_order(x2):
        fx = residual_branch_nchw(x2, w["w"], 2)
    if not inverse:
        return (pixel_unshuffle(b),
                (fx + pixel_unshuffle(a).float()).to(a.dtype))
    return pixel_shuffle((a.float() - fx).to(a.dtype)), x2


def transition_half_plain(a_u, b_u, w, inverse: bool = False):
    """The transition on half-res unshuffled streams ([p][q][ci] channel
    order). Forward: (u(x1), u(x2)) -> (u(x2), F(x2) + u(x1)). Inverse:
    (y2, y1) -> (y2 - F(s(y1)), y1), still unshuffled. The same sums as
    transition_block_plain: transition_block_plain(x1, x2) ==
    transition_half_plain(u(x1), u(x2)) exactly."""
    x2 = pixel_shuffle(b_u)
    with _kernel_sum_order(x2):
        fx = residual_branch_nchw(x2, w["w"], 2)
    if not inverse:
        return b_u, (fx + a_u.float()).to(a_u.dtype)
    return (a_u.float() - fx).to(a_u.dtype), b_u


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


def _mma_args(name, w, ref):
    """(bf16 pieces, b1 inside the float32 buffer) of a block routed to a
    tensor-core kernel: the biases are read from "flat", where b1 follows
    w1."""
    pieces = w["mma"]
    if pieces.device != ref.device:
        raise ValueError(f"{name}: bf16 weight pieces on {pieces.device}, "
                         f"inputs on {ref.device}")
    return (pieces.data_ptr(),
            w["flat"].data_ptr() + 4 * w["cin"] * 9 * w["mid"])


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
    m = w["mid"]
    mma = coupling_route(x1.dtype, c, m) == "mma"
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mma:
            pieces, b1 = _mma_args("fused_coupling", w, x1)
            err = lib.vst_coupling_mma(
                x1.data_ptr(), x2.data_ptr(), pieces, b1,
                out.data_ptr(), b, c, m, h, wd, int(inverse), stream)
            _build.check(err, "fused_coupling (tensor cores)")
            count_launch(fused_coupling, "mma_launches", x1.device)
            if (c, m) == MMA_WG:
                count_launch(fused_coupling, "wg_launches", x1.device)
        else:
            err = lib.vst_coupling(
                x1.data_ptr(), x2.data_ptr(), w["flat"].data_ptr(),
                out.data_ptr(), b, c, m, h, wd, int(inverse),
                int(x1.dtype == torch.bfloat16), stream)
            _build.check(err, "fused_coupling (CUDA cores)")
            count_launch(fused_coupling, "fma_launches", x1.device)
    return out


fused_coupling.fma_launches = 0
fused_coupling.mma_launches = 0
fused_coupling.wg_launches = 0
fused_coupling.device_launches = collections.Counter()


def coupling_launches() -> int:
    """Launches of fused_coupling's two kernels together."""
    return fused_coupling.fma_launches + fused_coupling.mma_launches


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
    m = w["mid"]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if transition_route(a.dtype, c, m) == "mma":
            pieces, b1 = _mma_args("fused_transition", w, a)
            err = lib.vst_transition_mma(
                a.data_ptr(), b.data_ptr(), pieces, b1, out0.data_ptr(),
                out1.data_ptr(), bsz, c, m, h, wd, int(inverse), stream)
            _build.check(err, "fused_transition (tensor cores)")
            count_launch(fused_transition, "mma_launches", a.device)
        else:
            err = lib.vst_transition(
                a.data_ptr(), b.data_ptr(), w["flat"].data_ptr(),
                out0.data_ptr(), out1.data_ptr(), bsz, c, m, h, wd,
                int(inverse), int(a.dtype == torch.bfloat16), stream)
            _build.check(err, "fused_transition (CUDA cores)")
            count_launch(fused_transition, "fma_launches", a.device)
    return out0, out1


fused_transition.fma_launches = 0
fused_transition.mma_launches = 0
fused_transition.device_launches = collections.Counter()


def fused_transition_half(a_u, b_u, w, inverse: bool = False):
    """The stride-2 transition on streams already unshuffled to half
    resolution, NCHW (B, 4C, h, w) in the [p][q][ci] channel order.

    Forward: a_u = u(x1), b_u = u(x2) -> (b_u, F(x2) + a_u). Inverse:
    a_u = y2, b_u = y1 -> (y2 - F(s(y1)), y1); the caller pixel-shuffles
    both. One stream of each pair passes through untouched. w from
    pack_transition_weights."""
    if b_u.device.type == "cpu":
        return transition_half_plain(a_u, b_u, w, inverse)
    _check("fused_transition_half", (a_u, b_u), w)
    bsz, c4, h, wd = a_u.shape
    c = w["cin"]
    if c4 != 4 * c:
        raise ValueError(f"fused_transition_half: {c4} channels, weights "
                         f"for {4 * c}")
    out = torch.empty_like(a_u)
    lib = _build.load()
    m = w["mid"]
    with torch.cuda.device(a_u.device):
        stream = torch.cuda.current_stream().cuda_stream
        if transition_route(a_u.dtype, c, m) == "mma":
            pieces, b1 = _mma_args("fused_transition_half", w, a_u)
            err = lib.vst_transition_half_mma(
                a_u.data_ptr(), b_u.data_ptr(), pieces, b1, out.data_ptr(),
                bsz, c, m, h, wd, int(inverse), stream)
            _build.check(err, "fused_transition_half (tensor cores)")
            count_launch(fused_transition_half, "mma_launches", a_u.device)
        else:
            err = lib.vst_transition_half(
                a_u.data_ptr(), b_u.data_ptr(), w["flat"].data_ptr(),
                out.data_ptr(), bsz, c, m, h, wd, int(inverse),
                int(a_u.dtype == torch.bfloat16), stream)
            _build.check(err, "fused_transition_half (CUDA cores)")
            count_launch(fused_transition_half, "fma_launches", a_u.device)
    return (out, b_u) if inverse else (b_u, out)


fused_transition_half.fma_launches = 0
fused_transition_half.mma_launches = 0
fused_transition_half.device_launches = collections.Counter()


def reset_launches() -> None:
    for fn in (fused_coupling, fused_transition, fused_transition_half):
        fn.fma_launches = 0
        fn.mma_launches = 0
        fn.device_launches.clear()
    fused_coupling.wg_launches = 0
