"""Precision hooks of the references: the operands of every convolution
and matrix product pass through one before the product.

`Exact` leaves them float32 (the reference). The controls: `Fp8` rounds
each operand to float8 e4m3 with a per-tensor scale (amax / 448), the
usual way fp8 inference stores activations and weights, and also the
tensors the network keeps between layers (`store`: the RevResNet's
streams, SegFormer's residual tokens), as a bf16 program keeps them in
bf16: the step below bfloat16. `Tf32` rounds the operands of products
to TF32 and keeps the rest float32, as TF32 tensor cores do: the step
below float32 with TF32 off. CONTROL maps a cell's precision to its
control.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


class Exact:
    streams = False

    def __call__(self, t):
        return t

    def store(self, t):
        """A tensor the network keeps between its layers (a stream, a
        latent, a token residual) as the precision holds it."""
        return self(t) if self.streams else t


class Fp8(Exact):
    streams = True

    def __call__(self, t):
        t = t.float()
        scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Tf32(Exact):
    """Each operand rounded to TF32 (10 mantissa bits, to nearest), as the
    card's TF32 tensor cores take float32 operands: the step below
    float32 with TF32 off."""

    def __call__(self, t):
        i = t.float().contiguous().view(torch.int32)
        i = (i + 0x1000) & ~0x1FFF
        return i.view(torch.float32)


CONTROL = {"bf16": Fp8, "float32": Tf32}
