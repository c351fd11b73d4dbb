"""The regional cWCT's batch-wide form on the CPU (models/cwct.py,
ops/regions.py).

On a CUDA card the regional transfers take one launch of each regional
kernel a batch (tests/test_torch_cuda.py holds the kernels to the plain
loops there). Here, on the CPU, the same functions take the plain loops,
frame by frame, and the batch-wide code around them (stacked statistics,
one batched region_transforms, one apply call) must give the bits that
one frame at a time gives.
"""

import numpy as np
import pytest
import torch

from vstnet_tpu_torch import ops
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.ops import regions


def _case(seed, b=3, h=24, w=40, c=32, labels=(3, 52, 76, 90), cell=8,
          dtype=torch.float32):
    """A skewed latent (b, h, w, c), block label maps (b, h, w) over
    `labels` with a -2 block (in no slot), and a style latent and map that
    hold every label."""
    gen = np.random.default_rng(seed)
    mix = gen.standard_normal((c, c)) / np.sqrt(c)
    z = gen.standard_normal((b, h, w, c)) @ mix + gen.standard_normal(c)
    zs = gen.standard_normal((1, h, w, c)) @ mix * 1.5 + 0.3
    pick = gen.choice(np.asarray(labels), size=(b + 1, h // cell, w // cell))
    m = np.repeat(np.repeat(pick, cell, 1), cell, 2).astype(np.int32)
    m[:b, :cell, :cell] = -2
    for i, lab in enumerate(labels):                # every label in the style
        m[b, :cell, i * cell:(i + 1) * cell] = lab
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    return t(z), torch.from_numpy(m[:b]), t(zs), torch.from_numpy(m[b:])


def test_batched_region_transforms_equal_the_frame_loop():
    """region_transforms on (B, K, ...) content statistics against one
    style's (K, ...) gives, bit for bit, what B calls on one frame's give:
    an empty slot and a one-row region (whose covariances take the jitter
    ladder) included."""
    z, m, zs, sm = _case(0)
    m[0, 0, 0] = 90                       # one row of 90 in frame 0
    m[1][m[1] == 90] = 3                  # no 90 in frame 1
    labels = cwct._padded_labels(sm, 8)
    xc, mc = cwct._rows(z), m.reshape(3, -1)
    stats = cwct._frame_stats(xc, mc, labels)
    style = cwct._region_stats(cwct._rows(zs)[0], sm.reshape(-1), labels)
    got = cwct.region_transforms(labels, *stats, *style)
    assert got[0].shape == (3, 8, 32, 32) and got[2].shape == (3, 8)
    for i in range(3):
        want = cwct.region_transforms(labels, *(s[i] for s in stats),
                                      *style)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    assert not got[2][1][labels == 90].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transfer_masked_factored_batch_equals_single_frames(dtype):
    """transfer_masked_factored on a batch of 3 frames equals three calls
    of one frame each, bit for bit."""
    z, m, zs, sm = _case(1, dtype=dtype)
    region = cwct.style_region_factors(zs, sm, 8)
    got = cwct.transfer_masked_factored(z, m, *region)
    assert got.dtype == dtype and got.shape == z.shape
    for i in range(3):
        assert torch.equal(got[i:i + 1], cwct.transfer_masked_factored(
            z[i:i + 1], m[i:i + 1], *region))
    assert not torch.equal(got, z)


def test_transfer_masked_batch_equals_single_frames():
    """transfer_masked takes each frame's own label table, (B, K): a batch
    of 3 equals three calls of one frame each, bit for bit."""
    z, m, zs, sm = _case(2)
    m[2][m[2] == 52] = 76                 # frame 2 holds one label fewer
    zs3, sm3 = zs.expand(3, -1, -1, -1), sm.expand(3, -1, -1)
    got = cwct.transfer_masked(z, zs3, m, sm3, max_labels=8)
    for i in range(3):
        assert torch.equal(got[i:i + 1], cwct.transfer_masked(
            z[i:i + 1], zs, m[i:i + 1], sm, max_labels=8))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_frame"])
def test_frame_moments_stack_region_moments(shared):
    """frame_moments on the CPU: each frame's region_moments, stacked bit
    for bit, with one label table or one a frame."""
    z, m, _, _ = _case(3)
    x, mr = cwct._rows(z), m.reshape(3, -1)
    one = cwct._padded_labels(m, 8)
    labels = one if shared else torch.stack([one, one.roll(2), one])
    got = cwct.frame_moments(x, mr, labels)
    assert [g.shape for g in got] == [(3, 8), (3, 8, 32), (3, 8, 32, 32)]
    for i in range(3):
        want = cwct.region_moments(x[i], mr[i],
                                   labels if shared else labels[i])
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


def test_apply_regions_batch_equals_frames():
    """apply_regions on (B, N, C) rows with (B, K, ...) transforms equals
    the one-frame form, (N, C) with (K, ...), frame by frame."""
    z, m, zs, sm = _case(4)
    labels = cwct._padded_labels(sm, 8)
    x, mr = cwct._rows(z), m.reshape(3, -1)
    tsb = cwct.region_transforms(
        labels, *cwct._frame_stats(x, mr, labels),
        *cwct._region_stats(cwct._rows(zs)[0], sm.reshape(-1), labels))
    got = cwct.apply_regions(x, mr, labels, *tsb)
    for i in range(3):
        want = cwct.apply_regions(x[i], mr[i], labels,
                                  *(t[i] for t in tsb))
        assert torch.equal(got[i], want)
        assert torch.equal(want, cwct.apply_regions_plain(
            x[i], mr[i], labels, *(t[i] for t in tsb)))
    keep = (mr == -2)
    assert torch.equal(got[keep], x[keep])


def test_regional_transfers_take_the_plain_loops_on_the_cpu(monkeypatch):
    """On CPU tensors regions.takes is False and no regional kernel is
    called or counted: the masked transfers, the style factors and the
    tiler's row functions run region_moments_plain and
    apply_regions_plain."""
    def refuse(*args, **kw):
        raise AssertionError("a regional kernel was called on the CPU")

    ops.reset_launch_counts()
    kernels = (regions.region_moments, regions.apply_regions)
    monkeypatch.setattr(regions, "region_moments", refuse)
    monkeypatch.setattr(regions, "apply_regions", refuse)
    calls = {"moments": 0, "apply": 0}
    moments, apply = cwct.region_moments_plain, cwct.apply_regions_plain

    def count_moments(*args, **kw):
        calls["moments"] += 1
        return moments(*args, **kw)

    def count_apply(*args, **kw):
        calls["apply"] += 1
        return apply(*args, **kw)

    monkeypatch.setattr(cwct, "region_moments_plain", count_moments)
    monkeypatch.setattr(cwct, "apply_regions_plain", count_apply)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        z, m, zs, sm = _case(5, dtype=dtype)
        assert not regions.takes(cwct._rows(z))
        region = cwct.style_region_factors(zs, sm, 8)
        cwct.transfer_masked_factored(z, m, *region)
        cwct.transfer_masked(z, zs.expand(3, -1, -1, -1), m,
                             sm.expand(3, -1, -1), max_labels=8)
        cwct.region_moments(z, m, region[0])
    # a style, 3 frames, then 3 + 3 frames; an apply a frame twice; one sum
    assert calls == {"moments": 3 * (1 + 3 + 6 + 1), "apply": 3 * 6}
    assert not any(k.launches or k.device_launches for k in kernels)


def test_region_wrappers_reject_rows_off_the_card():
    """ops.regions' wrappers take CUDA rows only, and say so."""
    z, m, _, _ = _case(6)
    x, mr = cwct._rows(z), m.reshape(3, -1)
    labels = cwct._padded_labels(m, 8)
    with pytest.raises(ValueError, match="CUDA"):
        regions.region_moments(x, mr, labels)
    ts, bs = torch.zeros(3, 8, 32, 32), torch.zeros(3, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        regions.apply_regions(x, mr, labels, ts, bs,
                              torch.ones(3, 8, dtype=torch.bool))


@pytest.mark.parametrize("n,b,groups,rows", [
    (921600, 8, 2112, None), (921600, 8, 990, None), (4194304, 1, 2112, None),
    (5000, 3, 2112, None), (100, 1, 2112, None), (5000, 3, 2112, 32),
    (4097, 2, 7, None), (33, 1, 4, 40)])
def test_region_chunking_covers_the_rows(n, b, groups, rows):
    """regions.chunking: chunks of a multiple of 32 rows that cover the
    frame, none empty, at most `groups` in all over the frames (one a
    frame at the least) and MIN_ROWS long where the frame has them."""
    chunks, r = regions.chunking(n, b, groups, rows)
    assert r % regions.TILE_ROWS == 0 and r >= 1
    assert chunks * r >= n and (chunks - 1) * r < n
    if rows is None:
        assert chunks <= max(1, groups // b)
        assert r >= min(n, regions.MIN_ROWS)
    else:
        assert r == -(-rows // 32) * 32


def test_launch_counts_name_the_region_kernels():
    """ops.launch_counts names both regional kernels, counts each apart
    and reset clears them."""
    assert {"region_moments", "region_apply"} <= set(ops.launch_counts())
    regions.region_moments.launches += 1
    regions.apply_regions.launches += 2
    try:
        counts = ops.launch_counts()
        assert (counts["region_moments"], counts["region_apply"]) == (1, 2)
    finally:
        ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())
