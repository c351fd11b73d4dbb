"""Run-time helpers of the PyTorch port (shape buckets)."""
