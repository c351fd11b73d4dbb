"""The regional cWCT's two row passes on a CUDA card (csrc/regions.cu).

`region_moments` sums each frame's per-label counts, sums and Gram in
float64; `apply_regions` gives each row its region's transform. Both take
a batch of frames in one launch and never form the one-hot product. They
replace no TPU kernel: their plain versions are models/cwct.py's
region_moments_plain and apply_regions_plain, the torch loops that the
JAX package's one-hot scans became, which cwct runs on the CPU and which
the card tests hold these kernels to. cwct decides which runs (`takes`):
a bf16 or float32 latent on a CUDA card, 32 or 128 channels wide (the
photo and the artistic latents; WIDTHS), outside a torch.export trace.

Each wrapper counts its launches (`launches`, and by device
`device_launches`; ops.launch_counts names them "region_moments" and
"region_apply"): one a call, the moments' fixed-order reduction of its
chunk partials included.
"""

from __future__ import annotations

import collections
import functools

import torch

from vstnet_tpu_torch.ops import _build, count_launch

WIDTHS = (32, 128)
# chunks of rows in all (a group of threads walks each): the moments aim
# at 16 an SM, the apply at 32; and device memory for the moments' chunk
# partials, P chunks x K slots x (C*C + C + 1) float64 a frame: the number
# of chunks is cut to fit
PARTIAL_BYTES = 256 << 20
# rows a chunk at the least, and the tile the kernels stage rows by
MIN_ROWS = 1024
TILE_ROWS = 32


def takes(x) -> bool:
    """Whether cwct sends the rows x (..., C) to these kernels."""
    return (x.is_cuda and x.dtype in (torch.float32, torch.bfloat16)
            and x.shape[-1] in WIDTHS
            and not torch.compiler.is_exporting())


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunking(n: int, b: int, groups: int, rows: int | None = None):
    """(chunks a frame, rows a chunk) that cut b frames of n rows into
    about `groups` chunks in all, each a multiple of TILE_ROWS and at
    least MIN_ROWS long where the frame has them; `rows` fixes the
    length."""
    if rows is None:
        chunks = max(1, min(groups // b, -(-n // MIN_ROWS)))
        rows = -(-n // chunks)
    rows = -(-rows // TILE_ROWS) * TILE_ROWS
    return -(-n // rows), rows


def _check(x, m, what):
    if (x.dim() != 3 or not x.is_cuda or x.dtype not in (torch.float32,
                                                         torch.bfloat16)
            or x.shape[-1] not in WIDTHS or tuple(m.shape) != x.shape[:2]
            or m.device != x.device):
        raise ValueError(
            f"{what}: needs bf16 or float32 rows (B, N, C) on a CUDA device "
            f"with C in {WIDTHS} and labels (B, N) beside them; got "
            f"{tuple(x.shape)} {x.dtype} {x.device}, labels "
            f"{tuple(m.shape)} {m.device}")


def _aligned(x):
    """x contiguous from a 16-byte boundary (the kernels load 16 bytes at
    a time)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _labels(labels, b, device):
    """int32 labels, contiguous, and their stride a frame (0: shared)."""
    if labels.dim() not in (1, 2) or (labels.dim() == 2
                                      and labels.shape[0] != b):
        raise ValueError(f"labels {tuple(labels.shape)}: want (K,) or "
                         f"({b}, K)")
    if labels.device != device:
        raise ValueError(f"labels on {labels.device}, rows on {device}")
    lab = labels.to(torch.int32).contiguous()
    return lab, (lab.shape[1] if lab.dim() == 2 else 0)


def region_moments(x, m, labels, rows: int | None = None):
    """Per-frame, per-slot raw moments of x (B, N, C) under labels m
    (B, N): counts (B, K), sums (B, K, C), Gram (B, K, C, C), float64.
    labels (K,) serves every frame, (B, K) gives each its own. A row adds
    to every slot whose label equals its own; a label in no slot adds
    nothing. rows fixes the rows a chunk (tests)."""
    _check(x, m, "region_moments")
    b, n, c = x.shape
    lab, stride = _labels(labels, b, x.device)
    k = lab.shape[-1]
    e = c * c + c + 1
    if not (n and k):
        out = torch.zeros((b, k, e), dtype=torch.float64, device=x.device)
    else:
        x, m = _aligned(x), m.to(torch.int32).contiguous()
        groups = min(16 * _sms(x.device.index),
                     max(b, PARTIAL_BYTES // (k * e * 8)))
        chunks, rows = chunking(n, b, groups, rows)
        partial = torch.empty(b * chunks * k * e, dtype=torch.float64,
                              device=x.device)
        touched = torch.empty(b * chunks * k, dtype=torch.uint8,
                              device=x.device)
        out = torch.empty((b, k, e), dtype=torch.float64, device=x.device)
        lib = _build.load()
        with torch.cuda.device(x.device):
            err = lib.vst_region_moments(
                x.data_ptr(), m.data_ptr(), lab.data_ptr(), stride,
                partial.data_ptr(), touched.data_ptr(), out.data_ptr(), b, n,
                c, k, chunks, rows, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "region_moments")
        count_launch(region_moments, "launches", x.device)
    return (out[..., -1], out[..., c * c:c * c + c],
            out[..., :c * c].view(b, k, c, c))


def apply_regions(x, m, labels, ts, bs, valids, rows: int | None = None):
    """y = T x + b for each row of x (B, N, C) with the first valid slot
    of its label in m (B, N), T rounded to x's dtype, summed in float32
    and rounded once to x's dtype; a row with no valid slot keeps its
    content. ts (B, K, C, C), bs (B, K, C), valids (B, K); labels (K,) or
    (B, K). rows fixes the rows a chunk (tests)."""
    _check(x, m, "apply_regions")
    b, n, c = x.shape
    lab, stride = _labels(labels, b, x.device)
    k = lab.shape[-1]
    if (tuple(ts.shape) != (b, k, c, c) or tuple(bs.shape) != (b, k, c)
            or tuple(valids.shape) != (b, k)):
        raise ValueError(f"apply_regions: transforms {tuple(ts.shape)}, "
                         f"{tuple(bs.shape)}, {tuple(valids.shape)} for "
                         f"rows {tuple(x.shape)} and {k} slots")
    if not (n and k):
        return x.clone()
    # every operand held by a name until the launch is enqueued
    x, m = _aligned(x), m.to(torch.int32).contiguous()
    ts = ts.to(x.dtype).contiguous()          # T rounded to x's dtype
    bs = bs.float().contiguous()
    ok = valids.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    chunks, rows = chunking(n, b, 32 * _sms(x.device.index), rows)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.vst_region_apply(
            x.data_ptr(), m.data_ptr(), lab.data_ptr(), stride, ts.data_ptr(),
            bs.data_ptr(), ok.data_ptr(), out.data_ptr(), b, n, c, k, chunks,
            rows, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "apply_regions")
    count_launch(apply_regions, "launches", x.device)
    return out


for _fn in (region_moments, apply_regions):
    _fn.launches = 0
    _fn.device_launches = collections.Counter()
