"""The data-parallel layer of the PyTorch port (counterpart of
vstnet_tpu/parallel): one replica per device for inference, one process
per device for training. The JAX package's NamedSharding helpers
(`replicated`, `batch_sharded`, `spatial_sharded`) have no counterpart:
`replicate` and `shard_batch` place the data themselves, and
`parallel_train_step` stands for `make_parallel_train_step` and
`make_parallel_flat_step`. Row (spatial) sharding of the standard path
(`spatial=True` on a ("data", "spatial") mesh) places its halo exchanges
itself (parallel/halo.py); the training step's row form, their
`spatial=True`, is `parallel_train_step(..., rows=...)`, one rank a data
row, over `forward_rows` / `inverse_rows`."""

from vstnet_tpu_torch.parallel.halo import (  # noqa: F401
    decode_rows,
    encode_rows,
    forward_rows,
    inverse_rows,
)
from vstnet_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from vstnet_tpu_torch.parallel.sharding import (  # noqa: F401
    Replicated,
    gather,
    map_shards,
    parallel_stylize,
    parallel_stylize_factored,
    parallel_stylize_fused,
    parallel_stylize_masked_fused,
    parallel_train_step,
    replicate,
    shard_batch,
)
