"""ADE20K label remapping on integer label maps.

Counterpart of vstnet_tpu/models/remapping.py:

  * self_remapping:   labels covering < min_ratio of the image are replaced
    by the semantically closest label that IS well represented, using the
    150x150 ADE20K relation table (column l ranks the labels by closeness
    to l).
  * cross_remapping:  content labels absent from the style mask are
    replaced by the closest label the style has.
  * video_remap_plan / video_remap: both composed into one 150-entry table
    and one per-pixel gather per frame, against a fixed style mask.

For all 150 labels at once: gather the relation table's candidates, mark
which qualify, take the first qualifying row. Everything is integer
arithmetic on the masks' device, batched over frames, with no host sync.
The two tables are the package's own copies under vstnet_tpu_torch/data/.
"""

from __future__ import annotations

import os

import numpy as np
import torch

NUM_CLASSES = 150
_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "data")


def load_label_mapping(path: str | None = None, device="cpu"):
    """(150, 150) int64 semantic-relation table; mapping[j, l] is the j-th
    closest label to l."""
    p = path or os.path.join(_DATA_DIR, "ade20k_semantic_rel.npy")
    return torch.from_numpy(np.load(p).astype(np.int64)).to(device)


def ade20k_palette(path: str | None = None) -> np.ndarray:
    p = path or os.path.join(_DATA_DIR, "ade20k_palette.npy")
    return np.load(p).astype(np.uint8)


def _first_qualifying(mapping, qualifies, fallback):
    """For each label l: the first candidate in mapping[:, l] for which
    qualifies[..., candidate] is True; else fallback[l].

    mapping (J, L) int; qualifies (..., NUM_CLASSES) bool; fallback (L,)."""
    q = qualifies[..., mapping]                       # (..., J, L) bool
    found = q.any(dim=-2)
    # the first True row of each column: argmax returns the first maximum
    first = q.to(torch.int32).argmax(dim=-2, keepdim=True)
    cand = mapping.expand(q.shape)
    chosen = torch.take_along_dim(cand, first, dim=-2).squeeze(-2)
    return torch.where(found, chosen, fallback)


def label_counts(seg, num_classes: int = NUM_CLASSES):
    """Pixel count per label over the whole of seg (any shape); labels
    outside [0, num_classes) are not counted. Exact integer counts."""
    flat = seg.reshape(-1).long()
    inside = (flat >= 0) & (flat < num_classes)
    flat = torch.where(inside, flat, torch.full_like(flat, num_classes))
    return _count(flat, num_classes + 1)[:num_classes]


def _count(flat, length: int):
    """Occurrences of each value of an int64 vector with values in [0,
    length): torch.bincount with a fixed output length, so that the shape
    does not depend on the data (torch.export); exact integer sums."""
    return torch.zeros(length, dtype=torch.int64,
                       device=flat.device).scatter_add_(
                           0, flat, torch.ones_like(flat))


def _frame_counts(seg):
    """seg (B, H, W) -> (B, NUM_CLASSES) per-frame counts, one count over
    all frames."""
    b = seg.shape[0]
    flat = seg.reshape(b, -1).long()
    inside = (flat >= 0) & (flat < NUM_CLASSES)
    flat = torch.where(inside, flat, torch.full_like(flat, NUM_CLASSES))
    flat = flat + (NUM_CLASSES + 1) * torch.arange(
        b, device=seg.device)[:, None]
    counts = _count(flat.reshape(-1), b * (NUM_CLASSES + 1))
    return counts.reshape(b, NUM_CLASSES + 1)[:, :NUM_CLASSES]


def _gather_labels(table, seg):
    """table (B, NUM_CLASSES) applied to seg (B, H, W), in seg's dtype."""
    b = seg.shape[0]
    out = torch.take_along_dim(table, seg.reshape(b, -1).long(), dim=1)
    return out.reshape(seg.shape).to(seg.dtype)


def _batched(seg):
    return (seg, False) if seg.dim() == 3 else (seg[None], True)


def _identity(device):
    return torch.arange(NUM_CLASSES, device=device)


def _self_map(seg, mapping, min_ratio, min_pixels_floor):
    """(B, NUM_CLASSES) table of self_remapping for each frame of seg."""
    n_pixels = seg.shape[1] * seg.shape[2]
    min_pixels = max(int(n_pixels * min_ratio), min_pixels_floor)
    counts = _frame_counts(seg)
    present = counts > 0
    big = counts >= min_pixels
    identity = _identity(seg.device)
    remapped = _first_qualifying(mapping, big, identity)
    # only small-but-present labels move; everything else keeps itself
    return torch.where(present & ~big, remapped, identity)


def self_remapping(seg, mapping, min_ratio: float = 0.02,
                   min_pixels_floor: int = 10):
    """Merge under-represented labels into their closest well-represented
    neighbour, per frame. seg: (H, W) or (B, H, W) int."""
    seg3, squeeze = _batched(seg)
    out = _gather_labels(
        _self_map(seg3, mapping, min_ratio, min_pixels_floor), seg3)
    return out[0] if squeeze else out


def cross_remapping(content_seg, style_seg, mapping):
    """Map content labels that the style lacks onto the closest label the
    style has, per (content, style) pair."""
    c3, squeeze = _batched(content_seg)
    s3, _ = _batched(style_seg)
    in_style = _frame_counts(s3) > 0
    missing = (_frame_counts(c3) > 0) & ~in_style
    identity = _identity(c3.device)
    remapped = _first_qualifying(mapping, in_style, identity)
    out = _gather_labels(torch.where(missing, remapped, identity), c3)
    return out[0] if squeeze else out


def video_remap_plan(smask, mapping):
    """Per-video precompute for the masked video path: the style mask is
    fixed, so the style presence vector and the cross-remap table do not
    depend on the frame. smask: (H, W) or (1, H, W) int.

    Returns (in_style (150,) bool, cross_tab (150,) int) where cross_tab[l]
    is the label a style-missing content label l moves to."""
    in_style = label_counts(smask) > 0
    cross_tab = _first_qualifying(mapping, in_style,
                                  _identity(in_style.device))
    return in_style, cross_tab


def video_remap(seg, in_style, cross_tab, mapping, min_ratio: float = 0.02,
                min_pixels_floor: int = 10):
    """self_remapping then cross_remapping, composed into one 150-entry
    table and one per-pixel gather per frame: for a pixel with label l,
    self_map[l] is by construction present in the self-remapped frame, so
    the cross step is a table lookup. Equal to
    cross_remapping(self_remapping(seg, ...), smask, ...).

    seg: (H, W) or (B, H, W); in_style, cross_tab from video_remap_plan."""
    seg3, squeeze = _batched(seg)
    self_map = _self_map(seg3, mapping, min_ratio, min_pixels_floor)
    composed = torch.where(in_style[self_map], self_map, cross_tab[self_map])
    out = _gather_labels(composed, seg3)
    return out[0] if squeeze else out


def remove_small_holes(seg, mapping, min_ratio: float = 0.01):
    """Hole removal of the package tier: self_remapping at its ratio."""
    return self_remapping(seg, mapping, min_ratio=min_ratio)
