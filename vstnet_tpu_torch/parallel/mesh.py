"""The devices a data-parallel program runs over.

Counterpart of vstnet_tpu/parallel/mesh.py. The JAX package lays a Mesh
over its devices and lets GSPMD place the shards; here the "mesh" is the
plain tuple of devices, one replica of the program on each, and
parallel/sharding.py places the shards itself. Only the 1-D ("data",)
mesh exists: frames, or a training batch, split over the devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """The first n devices (all visible cards by default) as a tuple.

    device_type="cpu" gives n replicas on the CPU (one without n), which
    the tests use in place of cards. Raises RuntimeError when no card is
    visible, ValueError for more cards than are visible, and
    NotImplementedError for the 2-D ("data", "spatial") mesh, whose row
    sharding with a halo exchange is a later item of ROADMAP.md."""
    if tuple(axes) != ("data",):
        raise NotImplementedError(
            f"mesh axes {tuple(axes)}: only the ('data',) axis is ported; "
            "row (spatial) sharding with a halo exchange is a later item of "
            "ROADMAP.md")
    if device_type == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: use cuda or cpu")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                           "device_type=\"cpu\" for CPU replicas")
    n = n_devices or count
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} devices asked for, {count} "
                         "visible")
    return tuple(torch.device("cuda", i) for i in range(n))
