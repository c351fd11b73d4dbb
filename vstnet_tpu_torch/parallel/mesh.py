"""The devices a parallel program runs over.

Counterpart of vstnet_tpu/parallel/mesh.py. The JAX package lays a Mesh
over its devices and lets GSPMD place the shards; here the "mesh" is the
plain tuple of devices, one replica of the program on each, and
parallel/sharding.py places the shards itself:

  * ("data",): a tuple of devices; frames, or a training batch, split
    over them;
  * ("data", "spatial"): the JAX grid's layout, a tuple of n // S data
    rows, each a tuple of S devices in row order; the batch is split over
    the data rows and each image's rows over a data row's devices
    (parallel/halo.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",), spatial: int = 1,
              device_type: str = "cuda") -> Tuple:
    """The first n devices (all visible cards by default) as a tuple, or,
    for axes ("data", "spatial"), as n // spatial rows of `spatial`
    devices (np.asarray(devices).reshape(n // spatial, spatial) as nested
    tuples). spatial is ignored on the 1-D mesh, as in the JAX package.

    device_type="cpu" gives n replicas on the CPU (one without n, or
    `spatial` on the 2-D mesh), which the tests use in place of cards.
    Raises RuntimeError when no card is visible, and ValueError for more
    cards than are visible, for other axes and when spatial does not
    divide n."""
    axes = tuple(axes)
    if axes not in (("data",), ("data", "spatial")):
        raise ValueError(f"mesh axes {axes}: use ('data',) or ('data', "
                         "'spatial')")
    grid = len(axes) == 2
    if device_type == "cpu":
        devices = (torch.device("cpu"),) * (n_devices
                                             or (spatial if grid else 1))
    elif device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: use cuda or cpu")
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "device_type=\"cpu\" for CPU replicas")
        n = n_devices or count
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} "
                             "visible")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    if not grid:
        return devices
    n = len(devices)
    if spatial < 1 or n % spatial:
        raise ValueError(f"make_mesh: {n} devices not divisible by "
                         f"spatial={spatial}")
    return tuple(devices[r:r + spatial] for r in range(0, n, spatial))
