"""Plain ADE20K label remaps of the auto-seg route (CAP-VSTNet's
`SegReMapping`), one frame at a time.

The relation table R (150 x 150) ranks, in column l, the labels by
closeness to l. Self remap: a label present on fewer than
max(int(H W min_ratio), 10) pixels moves to the first label of its
column that is present on at least that many; it stays when there is
none. Cross remap: a content label that the style's mask lacks moves to
the first label of its column that the style has; it stays when there is
none.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_CLASSES = 150


def _counts(mask):
    m = mask.reshape(-1).long()
    m = m[(m >= 0) & (m < NUM_CLASSES)]
    return torch.bincount(m, minlength=NUM_CLASSES).cpu().numpy()


def _first(table, column: int, ok) -> int:
    for cand in table[:, column]:
        if ok[cand]:
            return int(cand)
    return column


def _apply(mask, lut):
    return torch.as_tensor(lut, device=mask.device)[mask.long()].to(
        mask.dtype)


def self_remap(mask, table, min_ratio: float, floor: int = 10):
    """One frame (H, W)."""
    counts = _counts(mask)
    need = max(int(mask.shape[0] * mask.shape[1] * min_ratio), floor)
    big = counts >= need
    lut = np.arange(NUM_CLASSES)
    for lab in np.nonzero((counts > 0) & ~big)[0]:
        lut[lab] = _first(table, lab, big)
    return _apply(mask, lut)


def cross_remap(mask, style_present, table):
    """One frame (H, W) against the style's label presence (150,) bool."""
    counts = _counts(mask)
    lut = np.arange(NUM_CLASSES)
    for lab in np.nonzero((counts > 0) & ~style_present)[0]:
        lut[lab] = _first(table, lab, style_present)
    return _apply(mask, lut)


def present(mask):
    return _counts(mask) > 0
