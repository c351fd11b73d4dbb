"""Training data pipeline: recursive image folder -> resize -> random crop
-> infinite shuffled batches, with background prefetch.

A copy of vstnet_tpu/train/data.py (numpy and PIL only), so that the port
imports nothing of the JAX package: for one seed and num_workers=1 both
give the same crops bit for bit. The matting Laplacian that the
reference's workers precomputed on the host is computed on the device
(ops/matting.py). Prefetching uses threads (PIL decode drops the GIL for
the heavy work).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp",
                  ".JPG", ".JPEG", ".PNG", ".PPM", ".BMP")


def make_dataset(root) -> List[str]:
    roots = root if isinstance(root, (list, tuple)) else [root]
    images: List[str] = []
    for r in roots:
        if not os.path.isdir(r):
            raise RuntimeError(f"{r} is not a valid directory")
        for base, _, fnames in sorted(os.walk(r)):
            images.extend(
                os.path.join(base, f) for f in sorted(fnames)
                if f.endswith(IMG_EXTENSIONS)
            )
    if not images:
        raise RuntimeError(f"Found 0 images in {root}")
    return images


def _load_crop(path: str, new_size: int, crop_hw, rng: np.random.Generator):
    """Resize shorter side to new_size (torchvision Resize semantics), then
    random-crop crop_hw. Returns HWC float32 [0,1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = new_size / min(w, h)
    if scale != 1.0:
        img = img.resize(
            (max(round(w * scale), crop_hw[1]), max(round(h * scale), crop_hw[0])),
            Image.BILINEAR,
        )
    w, h = img.size
    ch, cw = crop_hw
    x0 = int(rng.integers(0, max(w - cw, 0) + 1))
    y0 = int(rng.integers(0, max(h - ch, 0) + 1))
    img = img.crop((x0, y0, x0 + cw, y0 + ch))
    return np.asarray(img, np.float32) / 255.0


class InfiniteLoader:
    """Infinite shuffled batch iterator with threaded prefetch.

    Retries a random other image on decode errors, like
    ImageFolder.__getitem__ (utils/dataset.py:62-68).
    """

    def __init__(self, root, batch_size: int, new_size: int = 512,
                 crop: int = 256, num_workers: int = 4, seed: int = 0,
                 prefetch: int = 4):
        self.files = make_dataset(root)
        self.batch_size = batch_size
        self.new_size = new_size
        self.crop = (crop, crop)
        self.rng = np.random.default_rng(seed)
        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(seed + i,), daemon=True)
            for i in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self, seed):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            idx = rng.permutation(len(self.files))
            if len(idx) < self.batch_size:
                # dataset smaller than a batch (the reference's
                # InfiniteSampler also wraps): draw with replacement
                idx = rng.integers(0, len(self.files),
                                   size=self.batch_size)
            for start in range(0, len(idx) - self.batch_size + 1,
                               self.batch_size):
                if self._stop.is_set():
                    return
                batch = []
                for i in idx[start:start + self.batch_size]:
                    path = self.files[i]
                    for _ in range(5):
                        try:
                            batch.append(
                                _load_crop(path, self.new_size, self.crop, rng))
                            break
                        except OSError:
                            path = self.files[int(rng.integers(len(self.files)))]
                self._q.put(np.stack(batch))

    def sample(self, n: int) -> np.ndarray:
        """n random dataset crops, loaded synchronously — the reference
        draws `--display_size` fresh random images for its sample grids
        (train.py:222-224) rather than reusing the current batch."""
        batch = []
        for i in self.rng.integers(0, len(self.files), size=n):
            path = self.files[int(i)]
            for _ in range(5):
                try:
                    batch.append(
                        _load_crop(path, self.new_size, self.crop, self.rng))
                    break
                except OSError:
                    path = self.files[int(self.rng.integers(len(self.files)))]
        return np.stack(batch)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
