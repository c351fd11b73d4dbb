"""Model/architecture configuration (counterpart of vstnet_tpu/config.py).

Architecture constants reproduce the checkpoint-compatible shapes of the
reference RevResNet:

  - blocks [10, 10, 10], strides [1, 2, 2], channels [16, 64, 256]
  - injective pad 2*16 - 3 = 29 zero channels -> 32ch input, split 16/16
  - photorealistic: hidden_dim=16, sp_steps=2 -> latent 32ch @ full res
  - artistic:       hidden_dim=64, sp_steps=1 -> latent 128ch @ 1/2 res
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RevResNetConfig:
    n_blocks: Tuple[int, ...] = (10, 10, 10)
    strides: Tuple[int, ...] = (1, 2, 2)
    channels: Tuple[int, ...] = (16, 64, 256)
    in_channel: int = 3
    mult: int = 4
    hidden_dim: int = 16
    sp_steps: int = 2
    kernel: int = 3
    # n_blocks in the channel-reduction tail
    reduction_blocks: int = 2
    # Recompute each coupling block in the backward pass
    # (torch.utils.checkpoint) instead of keeping its activations: the
    # training step holds only the inter-block stream states. Off for
    # inference, which builds no graph.
    remat: bool = False

    def with_remat(self) -> "RevResNetConfig":
        return dataclasses.replace(self, remat=True)

    @property
    def inj_pad(self) -> int:
        # 2 * channels[0] - in_channel (= 29 for the default config)
        return 2 * self.channels[0] - self.in_channel

    @property
    def down_scale(self) -> int:
        p = 1
        for s in self.strides:
            p *= s
        return p

    @property
    def latent_channels(self) -> int:
        return 2 * self.hidden_dim

    @property
    def latent_scale(self) -> int:
        """Spatial downscale factor of the latent relative to the input."""
        return self.down_scale // (2 ** self.sp_steps)

    @property
    def reduction_channels(self) -> int:
        """Stream channel count of the channel-reduction blocks."""
        return self.hidden_dim * 4 ** self.sp_steps

    def block_plan(self):
        """Flat (channel, stride) list for the block stack."""
        plan = []
        for channel, depth, stride in zip(self.channels, self.n_blocks,
                                          self.strides):
            plan.append((channel, stride))
            plan.extend((channel, 1) for _ in range(depth - 1))
        return plan


PHOTO_CONFIG = RevResNetConfig(hidden_dim=16, sp_steps=2)
ARTISTIC_CONFIG = RevResNetConfig(hidden_dim=64, sp_steps=1)
