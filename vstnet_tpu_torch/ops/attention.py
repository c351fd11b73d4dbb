"""Attention for SegFormer's spatial-reduction attention (K4).

Counterpart of vstnet_tpu/ops/attention.py (sr_attention_flash, flash_ok).
The kernel is CUDA C++ for Hopper in `csrc/attention.cu` (bf16 operands on
the tensor cores, two passes over K so that no score tile is stored), built
at first use by `ops/_build.py`; beside it is its plain PyTorch version
with the same dtype chain: float32 scores, softmax in float32,
probabilities rounded to the input's dtype before P.V, float32 sums, one
rounding at the output. The kernel sums in another order than the plain
version, so the two agree within bf16 rounding, not bit for bit.

Layouts: q (G, N, D) with k, v (G, M, D), G = batch * heads, as in the JAX
package; or q (B, N, heads, D) with k, v (B, M, heads, D), the views the
model has after its q and kv projections. The kernel addresses both by
strides and reads them in place, so no (G, N, D) copy is made; the output
is contiguous in the input's layout.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel or raises. `sr_attention.launches` counts the kernel
launches.

Where the model does not route a stage to the kernel (`flash_ok` False:
fewer than MIN_Q queries), a bf16 CUDA tensor outside a torch.export trace
takes `sr_attention_sdpa`: PyTorch's scaled_dot_product_attention held to
its flash backend, which raises where flash cannot run rather than fall
back to the math path. It reads the (B, N, heads, D) views in place and
keeps the dtype chain in all but one point: float32 scores, a float32
(online) softmax, probabilities rounded to bf16 before P.V, float32 sums,
one rounding at the output; the probabilities it rounds are not yet
divided by their row's sum, which flash divides out of the float32 sums at
the end. `sr_attention_sdpa.launches` counts its calls. Everything else
(the CPU, float32, an exported program) takes the plain version. `route`
names the choice.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from vstnet_tpu_torch.ops import _build, count_launch

# Largest K/V token count the wrapper takes (the kernel itself has no limit
# from M) and the smallest query count it is routed for: the JAX package's
# routing, kept so that both packages run their kernel on the same shapes.
MAX_KV = 8192
MIN_Q = 8192
HEAD_DIM = 64


def flash_ok(n: int, m: int, dtype) -> bool:
    """Whether the model routes (N=n queries, M=m keys, dtype) to the
    kernel: bf16 activations, M <= MAX_KV, N >= MIN_Q."""
    return dtype == torch.bfloat16 and m <= MAX_KV and n >= MIN_Q


def route(n: int, m: int, q) -> str:
    """The model's attention for N=n queries, M=m keys and queries q:
    "k4" (`sr_attention`), "sdpa" (`sr_attention_sdpa`) or "plain"."""
    if flash_ok(n, m, q.dtype):
        return "k4"
    if (q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] == HEAD_DIM
            and not torch.compiler.is_exporting()):
        return "sdpa"
    return "plain"


def _as_bnhd(t):
    """(G, N, D) -> a (G, N, 1, D) view; (B, N, H, D) as it is."""
    if t.dim() == 3:
        return t.unsqueeze(2)
    if t.dim() == 4:
        return t
    raise ValueError(f"sr_attention: expected (G, N, D) or (B, N, heads, D),"
                     f" got {tuple(t.shape)}")


def sr_attention_plain(q, k, v, scale: float):
    """softmax(q k^T * scale) v per batch and head, the plain version."""
    q4, k4, v4 = _as_bnhd(q), _as_bnhd(k), _as_bnhd(v)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = torch.einsum("bnhd,bmhd->bhnm", q4.float(), k4.float()) * scale
        p = torch.softmax(s, dim=-1, dtype=torch.float32).to(q.dtype)
        o = torch.einsum("bhnm,bmhd->bnhd", p.float(), v4.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return o.to(q.dtype).reshape(q.shape)


def sr_attention_sdpa(q, k, v, scale: float):
    """sr_attention's layouts and result by PyTorch's flash SDPA: bf16
    CUDA tensors, D = 64."""
    q4, k4, v4 = _as_bnhd(q), _as_bnhd(k), _as_bnhd(v)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        o = F.scaled_dot_product_attention(
            q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2),
            scale=scale)
    count_launch(sr_attention_sdpa, "launches", q.device)
    return o.transpose(1, 2).reshape(q.shape)


sr_attention_sdpa.launches = 0
sr_attention_sdpa.device_launches = collections.Counter()


def _strides(t4, what):
    """Element strides (batch, head, row) of a (B, N, H, D) view whose rows
    the kernel reads as 16-byte loads."""
    sb, sn, sh, sd = t4.stride()
    if t4.shape[0] == 1:
        sb = 0
    if t4.shape[2] == 1:
        sh = 0
    if (sd != 1 or sb % 8 or sn % 8 or sh % 8
            or t4.data_ptr() % 16):
        raise ValueError(
            f"sr_attention: {what} needs unit stride on D and rows aligned "
            f"to 16 bytes; got strides {t4.stride()}")
    return sb, sh, sn


def sr_attention(q, k, v, scale: float):
    """q (G, N, D), k/v (G, M, D) -> (G, N, D); or q (B, N, heads, D),
    k/v (B, M, heads, D) -> (B, N, heads, D). D = 64, bf16 on a CUDA
    device, M <= MAX_KV."""
    if q.device.type == "cpu":
        return sr_attention_plain(q, k, v, scale)
    q4, k4, v4 = _as_bnhd(q), _as_bnhd(k), _as_bnhd(v)
    b, n, h, d = q4.shape
    m = k4.shape[1]
    for t in (q4, k4, v4):
        if (not t.is_cuda or t.device != q.device
                or t.dtype != torch.bfloat16):
            raise ValueError("sr_attention: needs bf16 tensors on one CUDA "
                             f"device; got {t.dtype} on {t.device}")
    if (d != HEAD_DIM or m > MAX_KV or b * h > 65535
            or tuple(k4.shape) != (b, m, h, d) or v4.shape != k4.shape):
        raise ValueError(
            f"sr_attention: needs D == {HEAD_DIM}, M <= {MAX_KV} and k, v "
            f"of one shape matching q; got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vst_attention(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
            b, h, n, m, d, float(scale), *_strides(q4, "q"),
            *_strides(k4, "k"), *_strides(v4, "v"), *_strides(out, "out"),
            stream)
    _build.check(err, "sr_attention")
    count_launch(sr_attention, "launches", q.device)
    return out.reshape(q.shape)


sr_attention.launches = 0
sr_attention.device_launches = collections.Counter()
