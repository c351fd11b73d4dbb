"""Data-parallel entry points: stylization over several devices, and the
training step over a torch.distributed group.

Counterpart of vstnet_tpu/parallel/sharding.py. The JAX package
annotates shardings and lets GSPMD (or shard_map, around the Pallas
programs) place the work; here it is placed by hand, in PyTorch's idiom:

  * inference runs in one process with one replica per device. The batch
    is split into contiguous equal shards, one per device in the mesh's
    order (GSPMD's layout of a batch-sharded array); every other argument
    (weights, style factors, tables) is replicated to each device; each
    device runs the single-device program on its shard; the results stay
    per device, in order (`gather` joins them). Frames are independent,
    so there is no collective. Every shard is enqueued before anything is
    read back, from one thread, device after device: kernels launch
    asynchronously, so the devices overlap as far as the host's enqueue
    is shorter than a shard's device time and the program makes the host
    wait for no device (chip_smoke.py phase 12 measures both).
  * training runs one process per device (parallel/multihost.py): each
    rank runs `loss_and_grads` on its rows, then one all-reduce of one
    flat buffer holding every gradient and the aux losses, as the JAX
    package's flat step reduces one raveled vector. DDP's wrapper does
    not fit: `loss_and_grads` runs 5-7 passes of the same parameters
    before its single backward.

  * row (spatial) sharding, on a 2-D ("data", "spatial") mesh, runs the
    standard float32 path of parallel_stylize and
    parallel_stylize_factored with spatial=True: the batch split over the
    data rows, each image's rows over a data row's devices, a halo
    exchange before each conv (parallel/halo.py) and the cWCT statistics
    reduced over the row shards on the row's first device
    (models/cwct.row_stats). The fused programs run on a 1-D mesh only:
    the JAX package shard_maps them over "data" alone, since XLA cannot
    partition a Pallas call, and would only repeat their work along
    "spatial".
  * row-sharded training (parallel_train_step(..., rows=...), JAX's
    spatial=True steps) runs one process per data row, driving that
    row's devices: the rank's images split by rows over them, the step's
    whole forward and backward one autograd graph across them
    (train/losses.loss_and_grads_rows; a halo or a reduction is a copy
    inside the graph, whose backward autograd carries back), then the
    flat all-reduce over the data rows' ranks as above.

The programs are the single-device ones of models/pipeline.py, looked up
when a parallel function is made, not copies of them. A mesh is the tuple
of devices of mesh.make_mesh, or its tuple of data rows; two entries may
name one device (replicas on one card).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import itertools
from typing import Sequence

import torch

from vstnet_tpu_torch.config import RevResNetConfig


class Replicated(tuple):
    """One object's copies, one per device of a mesh, in its order
    (`replicate`'s result). Passed to a parallel function in place of the
    object, it is used as it is."""


def _on(device):
    """The device's context: the kernels' wrappers and torch's ops launch
    on its current stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _module_on(module, device) -> bool:
    return all(t.device == device for t in itertools.chain(
        module.parameters(), module.buffers()))


def _to(obj, device):
    """obj on `device`: tensors moved, modules copied there, containers
    walked; objects already there are returned as they are."""
    from vstnet_tpu_torch.models.segformer import Segmenter

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, Segmenter):
        return dataclasses.replace(obj, net=_to(obj.net, device),
                                   label_mapping=_to(obj.label_mapping,
                                                     device))
    if isinstance(obj, torch.nn.Module):
        if _module_on(obj, device):
            return obj
        # a SegFormer drops its bf16 twin here (SegFormer._apply) and
        # makes it anew on the device, taps included
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def replicate(devices: Sequence[torch.device], obj) -> Replicated:
    """obj's copies on each device: tensors, nn.Modules (RevResNet,
    SegFormer), a Segmenter, and dicts, tuples and lists of them (the
    pack_revresnet dict, style factors, style_region, a remap plan). One
    copy per distinct device, shared by the replicas that device holds;
    the object itself stands for the device it lies on. A Replicated is
    returned as it is."""
    if isinstance(obj, Replicated):
        if len(obj) != len(devices):
            raise ValueError(f"replicate: {len(obj)} replicas for "
                             f"{len(devices)} devices")
        return obj
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = _to(obj, d)
    return Replicated(copies[d] for d in devices)


class _ReplicaCache:
    """replicate() with the copies kept per object, so that a parallel
    function called again with the same weights copies nothing; the
    CACHED most recent objects are kept."""

    CACHED = 8

    def __init__(self, devices):
        self.devices = devices
        self._copies = collections.OrderedDict()

    def __call__(self, obj) -> Replicated:
        if isinstance(obj, Replicated) or isinstance(
                obj, (int, float, bool, str, type(None))):
            return replicate(self.devices, obj)
        hit = self._copies.get(id(obj))
        if hit is not None and hit[0] is obj:
            self._copies.move_to_end(id(obj))
            return hit[1]
        reps = replicate(self.devices, obj)
        # the object is kept with its copies, so that its id stays its own
        self._copies[id(obj)] = (obj, reps)
        while len(self._copies) > self.CACHED:
            self._copies.popitem(last=False)
        return reps


def _is_grid(mesh) -> bool:
    return bool(mesh) and isinstance(mesh[0], (tuple, list))


def _split(x, dim: int, n: int, what: str):
    if x.shape[dim] % n:
        raise ValueError(f"shard_batch: {what} {x.shape[dim]} not "
                         f"divisible by {n} devices")
    return x.split(x.shape[dim] // n, dim=dim)


def shard_batch(mesh, x, spatial: bool = False):
    """x (B, ...) split on its first axis into len(mesh) contiguous equal
    shards, shard i copied to mesh[i] (asynchronously from pinned memory).
    A list or tuple of shards, one per device, is returned as a list.

    spatial=True, on a 2-D mesh: x (B, H, W, C) split on B over the data
    rows, then each part on H over its row's devices; returns a list of
    data rows, each a list of row shards (a nested list of shards is
    returned as such). Raises when B or H does not divide."""
    grid = _is_grid(mesh)
    if spatial != grid:
        raise ValueError("shard_batch: spatial=True goes with a 2-D "
                         "('data', 'spatial') mesh, and only with one")
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh) or (grid and any(
                len(r) != len(row) for r, row in zip(x, mesh))):
            raise ValueError(f"shard_batch: shards {x} do not match the "
                             f"mesh {mesh}")
        return [list(r) for r in x] if grid else list(x)
    parts = _split(x, 0, len(mesh), "batch")
    if not grid:
        return [s.to(d, non_blocking=True) for s, d in zip(parts, mesh)]
    return [[s.to(d, non_blocking=True)
             for s, d in zip(_split(p, 1, len(row), "height"), row)]
            for p, row in zip(parts, mesh)]


def gather(shards, device=None):
    """The shards joined in order on `device` (default: the first shard's)
    into one batch; a 2-D mesh's result (data rows of row shards) is
    joined on H within each data row, then on B."""
    if isinstance(shards[0], (list, tuple)):
        device = shards[0][0].device if device is None else device
        return torch.cat([torch.cat([s.to(device) for s in row], dim=1)
                          for row in shards])
    device = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(device) for s in shards])


def map_shards(devices: Sequence[torch.device], local_fn,
               sharded: Sequence[int] = (1,)):
    """fn(*args) running local_fn once per device: the arguments at the
    positions in `sharded` split by shard_batch (or given as shards), the
    others replicated (copies cached per object). Returns the per-device
    results in the devices' order: a list, or a tuple of lists when
    local_fn returns a tuple. Every shard is enqueued before the next
    device's; nothing is read back."""
    if _is_grid(devices):
        raise ValueError(
            "a 2-D ('data', 'spatial') mesh shards rows, which only "
            "parallel_stylize and parallel_stylize_factored do, with "
            "spatial=True, and parallel_train_step, with rows= (a data "
            "row of the mesh); the other parallel programs take a 1-D "
            "mesh")
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("map_shards: no devices")
    cache = _ReplicaCache(devices)

    def fn(*args):
        per_arg = [shard_batch(devices, a) if i in sharded else cache(a)
                   for i, a in enumerate(args)]
        outs = []
        for i, d in enumerate(devices):
            with _on(d):
                outs.append(local_fn(*(a[i] for a in per_arg)))
        if isinstance(outs[0], tuple):
            return tuple(list(o) for o in zip(*outs))
        return outs

    return fn


# ---------------------------------------------------------------------------
# Data-parallel inference
# ---------------------------------------------------------------------------

def _map_rows(mesh, local_fn, sharded: Sequence[int] = (1,)):
    """fn(*args) running local_fn once per data row of a 2-D mesh: the
    arguments at the positions in `sharded` split by
    shard_batch(spatial=True) (or given as its nested shards), the others
    replicated (copies cached per object); local_fn gets, for each
    argument, the list of its row shards or of its copies beside them.
    Returns the data rows' results in order; nothing is read back."""
    if not _is_grid(mesh):
        raise ValueError("spatial=True needs a 2-D ('data', 'spatial') "
                         "mesh: make_mesh(n, ('data', 'spatial'), "
                         "spatial=S)")
    grid = tuple(tuple(torch.device(d) for d in row) for row in mesh)
    cache = _ReplicaCache(tuple(itertools.chain(*grid)))

    def fn(*args):
        per_arg = []
        for i, a in enumerate(args):
            if i in sharded:
                per_arg.append(shard_batch(grid, a, spatial=True))
            else:
                reps = iter(cache(a))
                per_arg.append([[next(reps) for _ in row] for row in grid])
        return [local_fn(*(a[r] for a in per_arg))
                for r in range(len(grid))]

    return fn


def parallel_stylize(mesh, cfg: RevResNetConfig, spatial: bool = False):
    """fn(net, content, style) -> shards of decode(cWCT(encode(content),
    encode(style))) on the float32 standard path, content and style both
    split over the devices (their batches match), the RevResNet
    replicated. cfg is the net's own (kept for the JAX signature).

    spatial=True, on a 2-D mesh: the batches split over the data rows and
    each image's rows over a row's devices (parallel/halo.py); the style's
    and the content's cWCT statistics reduced over the row shards
    (cwct.row_stats). Returns data rows of row shards (`gather` joins
    them)."""
    from vstnet_tpu_torch.models import cwct, pipeline
    from vstnet_tpu_torch.parallel.halo import decode_rows, encode_rows

    if not spatial:
        return map_shards(mesh, pipeline.stylize, sharded=(1, 2))

    def local(nets, content, style):
        z_c = encode_rows(nets, content)
        ls, mu = cwct.style_factors_rows(encode_rows(nets, style))
        return decode_rows(nets, cwct.transfer_rows(z_c, ls, mu))

    return _map_rows(mesh, local, sharded=(1, 2))


def parallel_stylize_factored(mesh, cfg: RevResNetConfig,
                              spatial: bool = False):
    """fn(net, frames, ls, mu_s) -> shards of the standard path's frames
    clamped to [0,1], stylized against one style's factors
    (cwct.style_factors), which are replicated with the net. spatial=True
    shards rows on a 2-D mesh, as parallel_stylize does."""
    from vstnet_tpu_torch.models import cwct
    from vstnet_tpu_torch.parallel.halo import decode_rows, encode_rows

    @torch.no_grad()
    def local(net, frames, ls, mu_s):
        z_cs = cwct.transfer_with_factors(net.encode(frames), ls, mu_s)
        return net.decode(z_cs).clamp(0.0, 1.0)

    def local_rows(nets, frames, ls, mu_s):
        z_cs = cwct.transfer_rows(encode_rows(nets, frames), ls[0], mu_s[0])
        return [x.clamp(0.0, 1.0) for x in decode_rows(nets, z_cs)]

    if spatial:
        return _map_rows(mesh, local_rows)
    return map_shards(mesh, local)


def parallel_stylize_fused(devices, cfg: RevResNetConfig,
                           out_u8: bool = False, interp: bool = False):
    """fn(fast_params, frames, ls, mu_s[, alpha_c]) -> shards of
    pipeline.make_fused_video_fn's program (the global bf16 kernel path
    with the packed latent), frames split over the devices; the packed
    weights, the packed style factors and alpha_c replicated. out_u8 and
    interp as in make_fused_video_fn."""
    from vstnet_tpu_torch.models import pipeline

    return map_shards(devices, pipeline.make_fused_video_fn(
        cfg, out_u8=out_u8, interp=interp))


def parallel_stylize_masked_fused(devices, cfg: RevResNetConfig,
                                  min_ratio: float = 0.02,
                                  out_u8: bool = False, seg_hw=None,
                                  seg_half: bool = True):
    """fn(fast_params, seg_net, mapping, style_region, remap_plan, frames)
    -> (frame shards, mask shards) of pipeline.make_masked_fused_video_fn's
    program (segment, remap, fused encode, regional cWCT, fused decode),
    frames split over the devices; the packed weights, the SegFormer (each
    copy lays out its own bf16 twin and K5 taps on its device), the
    mapping and the per-video style state (prepare_masked_style)
    replicated."""
    from vstnet_tpu_torch.models import pipeline

    return map_shards(devices, pipeline.make_masked_fused_video_fn(
        cfg, min_ratio=min_ratio, out_u8=out_u8, seg_hw=seg_hw,
        seg_half=seg_half), sharded=(5,))


# ---------------------------------------------------------------------------
# Data-parallel training
# ---------------------------------------------------------------------------

def parallel_train_step(state, vgg, a, b, tc, flow=None, noise=None,
                        temporal_phase: bool = False, group=None,
                        rows=None):
    """One optimizer step of a rank in place; returns the aux losses of
    the global batch. The counterpart of make_parallel_train_step and
    make_parallel_flat_step; rows= is their spatial=True.

    a, b (and flow, noise in the temporal phase) are this rank's rows of
    the global batch, every rank holding as many. In order: the local
    loss_and_grads (its matting cotangent scaled by the number of ranks,
    see train/losses.py); one all_reduce (sum) of a flat buffer of every
    gradient and the aux vector; the division by the number of ranks,
    after which the gradient is the global batch's and the aux losses its
    means; then the trainer's global-norm clip, Adam step and schedule
    (train/trainer.apply_gradients). Every rank applies the same reduced
    buffer, so the parameters stay bit-identical across ranks. Outside a
    process group the rank is the whole batch (nothing to reduce).

    rows: this rank's data row of a ("data", "spatial") mesh (make_mesh's
    grid, one rank a data row), a tuple of S devices whose first holds
    state.net and vgg. The rank's images are split by rows over them
    (shard_batch(spatial=True) on the one-row mesh (rows,)), or given as
    lists of S row shards, and the local step is loss_and_grads_rows: one
    autograd graph
    over the row's devices, the halos and reductions copies within it.
    The image height must be a multiple of 8 * S (VGG's pools) and of
    S * the net's down_scale; ValueError otherwise."""
    import torch.distributed as dist

    from vstnet_tpu_torch.train.losses import (
        AUX_KEYS,
        loss_and_grads,
        loss_and_grads_rows,
    )
    from vstnet_tpu_torch.train.trainer import apply_gradients

    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if rows is None:
        _, aux = loss_and_grads(state.net, vgg, a, b, tc.weights, flow,
                                noise, temporal_phase, tc.precision,
                                shards=world)
    else:
        grid = (tuple(torch.device(d) for d in rows),)
        a, b, flow, noise = (
            None if x is None else shard_batch(
                grid, [x] if isinstance(x, (list, tuple)) else x,
                spatial=True)[0]
            for x in (a, b, flow, noise))
        _, aux = loss_and_grads_rows(state.net, vgg, a, b, tc.weights,
                                     flow, noise, temporal_phase,
                                     tc.precision, shards=world)
    grads = [p.grad for p in state.net.parameters()]
    dt = grads[0].dtype
    flat = torch.cat([g.reshape(-1).to(dt) for g in grads]
                     + [torch.stack([aux[k] for k in AUX_KEYS]).to(dt)])
    if world > 1:
        dist.all_reduce(flat, group=group)
        flat.div_(world)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    aux = dict(zip(AUX_KEYS, flat[off:].float()))
    apply_gradients(state, tc)
    return aux
