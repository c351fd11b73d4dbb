"""ops of the PyTorch port (see the package docstring).

Each kernel's launches are counted where it is launched, in a plain int
attribute of its wrapper; `launch_counts` reads all eight by kernel name
and `reset_launch_counts` clears them, so a run can show which kernels its
path went through. The counts are disjoint: "coupling" is the CUDA-core K1
kernel (csrc/coupling.cu) and "coupling_mma" the tensor-core one
(csrc/coupling_mma.cu), both launched by `fused_coupling`; "transition" /
"transition_mma" and "transition_half" / "transition_half_mma" are
csrc/transition.cu and csrc/transition_mma.cu behind `fused_transition`
and `fused_transition_half`.

`at_least_f32` is the dtype rule of every float32 statistic (cWCT, VGG
statistics, the matting term, the training losses): bf16 and float32
compute in float32, float64 (a reference run) stays float64.
"""

import torch


def at_least_f32(x):
    """x in float32, or in float64 when it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _counters():
    """kernel name -> (wrapper, name of its count attribute)."""
    from vstnet_tpu_torch.ops import attention, coupling_fused, dwconv

    return {"coupling": (coupling_fused.fused_coupling, "fma_launches"),
            "coupling_mma": (coupling_fused.fused_coupling, "mma_launches"),
            "transition": (coupling_fused.fused_transition, "fma_launches"),
            "transition_mma": (coupling_fused.fused_transition,
                               "mma_launches"),
            "transition_half": (coupling_fused.fused_transition_half,
                                "fma_launches"),
            "transition_half_mma": (coupling_fused.fused_transition_half,
                                    "mma_launches"),
            "attention": (attention.sr_attention, "launches"),
            "dwconv_gelu": (dwconv.dwconv3x3_bias_gelu, "launches")}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
