"""ops of the PyTorch port (see the package docstring).

Each kernel wrapper counts its launches in a plain int attribute;
`launch_counts` reads all five and `reset_launch_counts` clears them, so a
run can show which kernels its path went through.
"""


def _wrappers():
    from vstnet_tpu_torch.ops import attention, coupling_fused, dwconv

    return {"coupling": coupling_fused.fused_coupling,
            "transition": coupling_fused.fused_transition,
            "transition_half": coupling_fused.fused_transition_half,
            "attention": attention.sr_attention,
            "dwconv_gelu": dwconv.dwconv3x3_bias_gelu}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
