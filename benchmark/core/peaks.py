"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the denominators of every roofline and mfu share."""

FLOPS = {
    "bf16": 989e12,      # tensor cores, bf16 and fp16
    "tf32": 495e12,
    "float32": 67e12,    # CUDA cores, TF32 off
}
BYTES_PER_S = 3.35e12    # HBM3


def bound_s(flop: float, nbytes: float, precision: str = "bf16") -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flop / FLOPS[precision], nbytes / BYTES_PER_S)
