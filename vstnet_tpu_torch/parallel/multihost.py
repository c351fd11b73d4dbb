"""Several processes, one per card, over torch.distributed.

Counterpart of vstnet_tpu/parallel/multihost.py. The JAX package runs one
process per host and sees every chip of the job through one mesh; the
port runs one process per card, each driving its own device, and joins
them in one torch.distributed group:

  * `init_distributed()` — environment-gated `init_process_group`. It
    reads the JAX package's variables
        VSTNET_COORDINATOR    host:port of process 0
        VSTNET_NUM_PROCESSES  total process count
        VSTNET_PROCESS_ID     this process's index
    and torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT. None set: single-process mode, returns False.
  * `process_batch_bounds()` — which rows of the global batch this
    process feeds: a copy of the JAX package's arithmetic, which imports
    nothing of JAX.
  * `local_device()` — the card of this process: cuda:LOCAL_RANK.
  * `spawn_ranks()` — start one process per rank on this host and join
    them in a group on 127.0.0.1 (the trainer's data_parallel="auto").

`host_local_to_global` and `global_mesh` have no counterpart: no tensor
spans processes. Each rank keeps its own rows of the batch, and the
training step all-reduces its gradient (parallel/sharding.py).
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _env_int(*names) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def local_device() -> torch.device:
    """cuda:LOCAL_RANK; without LOCAL_RANK, this process's rank modulo the
    visible cards (0 outside a group). RuntimeError without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: no CUDA device is visible")
    index = _env_int("LOCAL_RANK")
    if index is None:
        rank = (dist.get_rank() if dist.is_initialized()
                else _env_int("VSTNET_PROCESS_ID", "RANK") or 0)
        index = rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group the environment describes; no-op otherwise.
    Idempotent. Returns True iff a group is (now) live.

    backend: "nccl" where a card is visible (the process's card, from
    local_device(), becomes its current device), "gloo" on the CPU. Call
    it first, before any model is built (the trainer and its CLI do)."""
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("VSTNET_COORDINATOR")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("VSTNET_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("VSTNET_PROCESS_ID", "RANK")
    if coordinator is None and num_processes is None and process_id is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed: the coordinator (VSTNET_COORDINATOR or "
            "MASTER_ADDR), the process count (VSTNET_NUM_PROCESSES or "
            "WORLD_SIZE) and the process index (VSTNET_PROCESS_ID or RANK) "
            f"are all needed; got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def process_batch_bounds(global_batch: int,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None
                         ) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this process feeds: equal
    contiguous slices in rank order. The defaults are the live group's
    size and rank (1 and 0 outside a group)."""
    live = dist.is_available() and dist.is_initialized()
    n = (dist.get_world_size() if live else 1) if num_processes is None \
        else num_processes
    pid = (dist.get_rank() if live else 0) if process_id is None \
        else process_id
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} outside [0, {n})")
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return pid * per, (pid + 1) * per


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_backend(world: int, device_type: str) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (on the
    CPU, or ranks that share a card: NCCL refuses two ranks on one)."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, world, port, backend, device_type, args):
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), device_type: str = "cuda",
                backend: Optional[str] = None) -> str:
    """Run fn(rank, *args) in `world` new processes of this host (spawned,
    so fn must be importable), joined in one group on 127.0.0.1 at a free
    port. Rank r drives cuda:(r % cards) when device_type is "cuda".
    Builds the kernel library first, in this process, so that no rank runs
    nvcc. Returns the backend (default: rank_backend). Raises when a rank
    fails; the others are then stopped."""
    import torch.multiprocessing as mp

    if device_type == "cuda":
        from vstnet_tpu_torch.ops import _build

        _build.build()
    backend = backend or rank_backend(world, device_type)
    mp.start_processes(_rank_main, nprocs=world, join=True,
                       start_method="spawn",
                       args=(fn, world, _free_port(), backend, device_type,
                             tuple(args)))
    return backend
