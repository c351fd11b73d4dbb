"""ops of the PyTorch port (see the package docstring).

Each kernel's launches are counted where it is launched (`count_launch`),
in a plain int attribute of its wrapper and, by device, in the wrapper's
`device_launches` counter; `launch_counts` reads all twelve by name
(for one device when given one) and `reset_launch_counts` clears them, so
a run can show which kernels its path went through, and on which card. The counts are disjoint: "coupling" is the CUDA-core K1
kernel (csrc/coupling.cu) and "coupling_mma" the tensor-core one
(csrc/coupling_mma.cu), both launched by `fused_coupling`; "transition" /
"transition_mma" and "transition_half" / "transition_half_mma" are
csrc/transition.cu and csrc/transition_mma.cu behind `fused_transition`
and `fused_transition_half`; "region_moments" and "region_apply" are
csrc/regions.cu behind the regional cWCT (ops/regions.py);
"attention_sdpa" is the segmenter's attention on PyTorch's flash SDPA where
K4 ("attention") is not routed (ops/attention.py), and "upsample_argmax"
csrc/upsample_argmax.cu behind the segmenter's mask (ops/upsample_argmax.py).

`at_least_f32` is the dtype rule of every float32 statistic (cWCT, VGG
statistics, the matting term, the training losses): bf16 and float32
compute in float32, float64 (a reference run) stays float64.
"""

import threading

import torch

# the counts are read-modify-writes from whichever thread launches
_COUNT_LOCK = threading.Lock()


def at_least_f32(x):
    """x in float32, or in float64 when it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def count_launch(fn, attr: str, device) -> None:
    """One launch of wrapper `fn`'s kernel counted by `attr`, on CUDA
    `device`. Called where the kernel is launched, and nowhere else."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
        fn.device_launches[(attr, device.index)] += 1


def _counters():
    """kernel name -> (wrapper, name of its count attribute)."""
    from vstnet_tpu_torch.ops import (
        attention,
        coupling_fused,
        dwconv,
        regions,
        upsample_argmax,
    )

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
            "dwconv_gelu": (dwconv.dwconv3x3_bias_gelu, "launches"),
            "region_moments": (regions.region_moments, "launches"),
            "region_apply": (regions.apply_regions, "launches"),
            "attention_sdpa": (attention.sr_attention_sdpa, "launches"),
            "upsample_argmax": (upsample_argmax.upsample_argmax,
                                "launches")}


def launch_counts(device=None) -> dict:
    """Kernel launches since the last reset, by kernel name: all of them,
    or those on CUDA `device` alone."""
    if device is None:
        return {name: getattr(fn, attr)
                for name, (fn, attr) in _counters().items()}
    index = torch.device(device).index
    return {name: fn.device_launches[(attr, index)]
            for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    from vstnet_tpu_torch.ops import coupling_fused

    with _COUNT_LOCK:
        for fn, attr in _counters().values():
            setattr(fn, attr, 0)
            fn.device_launches.clear()
        # the share of "coupling_mma" at C=256 (csrc/coupling_mma.cu:
        # coupling_mma_wg_kernel), not a kernel count of its own
        coupling_fused.fused_coupling.wg_launches = 0
