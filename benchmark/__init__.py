"""The benchmark of vstnet_tpu_torch on one NVIDIA H100 (see run.py)."""
