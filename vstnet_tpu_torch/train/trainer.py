"""Trainer: Adam with a 1/(1+decay*t) learning rate after a global-norm
clip, two phases (image, then video fine-tune), checkpoints, the loss log
and an HTML sample gallery.

Counterpart of vstnet_tpu/train/trainer.py: the same defaults,
checkpoint names (last.pt, model_image.pt, model_video.pt) and loss.log
line format, on one device or data-parallel over a torch.distributed
group of one process per device (`train`'s data_parallel). Model weights are written in the reference key
schema and load in either package; Adam's state, the schedule's count and
the step go to `<checkpoint>.opt.msgpack` in the JAX trainer's flat layout
(flax msgpack: Adam's int32 count, mu and nu as float32 vectors in
ravel_pytree's order, the schedule's int32 count, and the step), so a run
resumes in either package. load_checkpoint reads that file, the JAX
package's tree layout (a TrainState's: count, the L mu and L nu leaves in
tree order, the schedule's count), or, where neither exists, an
`.opt.pt` that earlier versions of this module wrote (torch.save).

The optimizer is optax's chain rebuilt in torch: the clip to a global norm
of 5 follows optax's formula, g / norm * max_norm where norm >= max_norm
(torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm); Adam with betas
0.9/0.999 and eps 1e-8 (fused on a CUDA device); a LambdaLR of
lr0 / (1 + decay * t), stepped after each optimizer step so that the first
update uses t = 0, as optax counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from vstnet_tpu_torch.config import (
    ARTISTIC_CONFIG,
    PHOTO_CONFIG,
    RevResNetConfig,
)
from vstnet_tpu_torch.device import resolve_device
from vstnet_tpu_torch.io.checkpoint import (
    jax_tree_leaves,
    load_native,
    load_revresnet,
    params_from_jax,
    params_to_jax,
    ravel_jax_tree,
    save_native,
    save_revresnet,
    unravel_jax_tree,
)
from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models.revresnet import RevResNet
from vstnet_tpu_torch.train.losses import DTYPES, LossWeights, loss_and_grads


@dataclasses.dataclass
class TrainConfig:
    mode: str = "photorealistic"
    lr: float = 1e-4
    lr_decay: float = 5e-5
    batch_size: int = 2
    new_size: int = 512
    crop_size: int = 256
    training_iterations: int = 160_000
    fine_tuning_iterations: int = 10_000
    grad_clip: float = 5.0
    weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    logs_directory: str = "logs"
    base_name: str = "run"
    log_every: int = 10
    display_size: int = 16
    image_display_iter: int = 1000
    image_save_iter: int = 10_000
    model_save_interval: int = 10_000
    seed: int = 0
    # "f32": true float32 (TF32 off); "bf16": float32 master weights, bf16
    # convs (cWCT, VGG statistics and matting stay float32)
    precision: str = "f32"

    @property
    def model_cfg(self) -> RevResNetConfig:
        cfg = (PHOTO_CONFIG if self.mode.lower() == "photorealistic"
               else ARTISTIC_CONFIG)
        return cfg.with_remat()  # the 5-pass step keeps only block states

    @property
    def total_iterations(self) -> int:
        return self.training_iterations + self.fine_tuning_iterations


@dataclasses.dataclass
class TrainState:
    net: RevResNet
    opt: torch.optim.Adam
    sched: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def make_optimizer(tc: TrainConfig, params):
    """(Adam, LambdaLR) over `params`."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=tc.lr, betas=(0.9, 0.999), eps=1e-8,
                           fused=params[0].is_cuda)
    return opt, make_schedule(tc, opt)


def make_schedule(tc: TrainConfig, opt, count: int = 0):
    """The LambdaLR of lr0 / (1 + decay * t) on `opt`, after `count`
    updates: its next learning rate is lr0 / (1 + decay * count)."""
    for g in opt.param_groups:
        g["initial_lr"] = tc.lr
    decay = tc.lr_decay
    return torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 1.0 / (1.0 + decay * t), last_epoch=count - 1)


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm in place on a list of gradients: where
    the global norm is at least max_norm, every g becomes
    (g / norm) * max_norm. No host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    div = torch.where(clip, norm, one)
    mul = torch.where(clip, one * max_norm, one)
    for g in grads:
        g.div_(div).mul_(mul)


def init_train_state(tc: TrainConfig, device=None,
                     net: Optional[RevResNet] = None) -> TrainState:
    """A fresh state: `net`, or a RevResNet(tc.model_cfg) initialized from
    tc.seed, with a new optimizer and schedule."""
    if net is None:
        net = RevResNet(tc.model_cfg, device=resolve_device(device))
        net.init_weights(torch.Generator().manual_seed(tc.seed))
    opt, sched = make_optimizer(tc, net.parameters())
    return TrainState(net, opt, sched)


def apply_gradients(state: TrainState, tc: TrainConfig) -> None:
    """The clip to tc.grad_clip's global norm, one Adam step and one
    schedule step, on the gradients in the parameters' .grad."""
    clip_by_global_norm([p.grad for p in state.net.parameters()],
                        tc.grad_clip)
    state.opt.step()
    state.sched.step()
    state.step += 1


def train_step(state: TrainState, vgg, images_a, images_b, tc: TrainConfig,
               flow=None, noise=None, temporal_phase: bool = False):
    """One optimizer step in place; returns the aux losses."""
    _, aux = loss_and_grads(state.net, vgg, images_a, images_b, tc.weights,
                            flow, noise, temporal_phase, tc.precision)
    apply_gradients(state, tc)
    return aux


# ---------------------------------------------------------------------------
# Checkpoints (reference names; weights and optimizer readable by both
# packages)
# ---------------------------------------------------------------------------

def save_checkpoint(state: TrainState, ckpt_dir: str, name: str = "last.pt",
                    with_optimizer: bool = True):
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name)
    save_revresnet(state.net, path)
    if with_optimizer:
        save_native(native_opt_state(state), path + ".opt.msgpack")
    return path


def native_opt_state(state: TrainState) -> dict:
    """{"opt_state": {"leaves": [count, mu, nu, schedule count]}, "step"}:
    the optimizer in the JAX trainer's flat layout, with its dtypes (int32
    counts, float32 moments raveled in ravel_pytree's order of the JAX
    params); a parameter Adam has not stepped has zero moments."""
    count, mu, nu = 0, {}, {}
    for k, p in state.net.named_parameters():
        st = state.opt.state.get(p)
        if st:
            count = st["step"]
            mu[k], nu[k] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[k] = nu[k] = torch.zeros_like(p)
    return {"opt_state": {"leaves": [
        np.asarray(int(count), np.int32),
        ravel_jax_tree(params_to_jax(mu)),
        ravel_jax_tree(params_to_jax(nu)),
        np.asarray(state.sched.last_epoch, np.int32)]},
        "step": np.asarray(state.step)}


def _count(leaf, what: str, path: str) -> int:
    if np.ndim(leaf) != 0 or np.asarray(leaf).dtype.kind not in "iu":
        raise ValueError(f"{path}: {what} is not an integer scalar")
    return int(leaf)


def load_native_opt_state(state: TrainState, tc: TrainConfig,
                          path: str) -> int:
    """Adam's moments and count and the schedule's count from a native
    optimizer file, in the flat or the tree layout, into `state`'s
    optimizer and schedule (exp_avg = mu, exp_avg_sq = nu, transposed
    HWIO -> OIHW; step = Adam's count; the schedule after its count).
    Returns the file's step. Raises when the file does not fit the model."""
    blob = load_native(path)
    leaves = blob["opt_state"]["leaves"]
    named = dict(state.net.named_parameters())
    like = params_to_jax(named)
    shapes = [x.shape for x in jax_tree_leaves(like)]
    n_leaf, n_val = len(shapes), sum(int(np.prod(sh)) for sh in shapes)
    got = [np.shape(x) for x in leaves]
    if len(leaves) == 4 and got[1] == got[2] == (n_val,):
        mu, nu = leaves[1], leaves[2]
    elif (len(leaves) == 2 * n_leaf + 2
          and got[1:-1] == [tuple(sh) for sh in shapes] * 2):
        mu = ravel_jax_tree(leaves[1:1 + n_leaf])
        nu = ravel_jax_tree(leaves[1 + n_leaf:-1])
    else:
        raise ValueError(
            f"{path}: {len(leaves)} optimizer leaves do not fit the "
            f"model's {n_leaf} parameter tensors of {n_val} values (flat: "
            f"4 leaves, tree: {2 * n_leaf + 2})")
    count = _count(leaves[0], "Adam's count", path)
    sched_count = _count(leaves[-1], "the schedule's count", path)
    mu = params_from_jax(unravel_jax_tree(mu, like))
    nu = params_from_jax(unravel_jax_tree(nu, like))
    sd = state.opt.state_dict()
    # the optimizer's parameters are net.parameters(), in this order
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": mu[k], "exp_avg_sq": nu[k]}
                   for i, k in enumerate(named)}
    state.opt.load_state_dict(sd)
    state.sched = make_schedule(tc, state.opt, sched_count)
    return _count(np.asarray(blob["step"]), "the step", path)


def load_checkpoint(tc: TrainConfig, ckpt_dir: str, name: str = "last.pt",
                    resume_iter: int = -1, device=None) -> TrainState:
    """The state saved by save_checkpoint, or by the JAX package's (its
    `.opt.msgpack`, flat or tree layout), or an `.opt.pt` of earlier
    versions. Without an optimizer file the optimizer starts fresh;
    resume_iter >= 0 overrides the step."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, name)
    net = RevResNet(tc.model_cfg, device=device)
    net.load_state_dict(load_revresnet(path))
    state = init_train_state(tc, device, net)
    step = None
    if os.path.exists(path + ".opt.msgpack"):
        step = load_native_opt_state(state, tc, path + ".opt.msgpack")
    elif os.path.exists(path + ".opt.pt"):
        blob = torch.load(path + ".opt.pt", map_location=device,
                          weights_only=True)
        state.opt.load_state_dict(blob["optimizer"])
        state.sched.load_state_dict(blob["scheduler"])
        step = int(blob["step"])
    if resume_iter >= 0:
        state.step = resume_iter
    elif step is not None:
        state.step = step
    return state


# ---------------------------------------------------------------------------
# Logging helpers (loss.log, image grid, auto-refresh HTML)
# ---------------------------------------------------------------------------

def write_loss_log(logs_dir: str, message: str):
    os.makedirs(logs_dir, exist_ok=True)
    with open(os.path.join(logs_dir, "loss.log"), "a") as f:
        f.write(message + "\n")


def loss_message(it: int, total: int, weights: LossWeights, aux,
                 sec_per_it: float) -> str:
    """The reference's loss.log line."""
    w = weights
    return (
        "Iteration: %08d/%08d  content_loss:%.4f  lap_loss:%.4f  "
        "rec_loss:%.4f  style_loss:%.4f  loss_tmp:%.4f  "
        "loss_tmp_GT:%.4f  (%.2f s/it)" % (
            it, total,
            w.content * float(aux["loss_c"]),
            w.lap * float(aux["loss_lap"]),
            w.rec * float(aux["loss_rec"]),
            w.style * float(aux["loss_s"]),
            w.temporal * float(aux["loss_tmp"]),
            w.temporal * float(aux["loss_tmp_gt"]),
            sec_per_it,
        ))


def write_sample_grid(path: str, rows):
    """rows: list of (B, H, W, 3) tensors -> one image, rows stacked
    vertically, batch horizontally."""
    from PIL import Image

    rows = [r.detach().float().cpu().numpy() for r in rows]
    grid = np.concatenate(
        [np.concatenate(list(np.clip(r, 0, 1)), axis=1) for r in rows],
        axis=0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)
    return path


def write_html(logs_dir: str, iterations: int, image_save_iter: int):
    rows = ['<h3>current</h3>',
            '<img src="images/train_current.jpg" style="width:1024px"><br>']
    for j in range(iterations, image_save_iter - 1, -image_save_iter):
        if j % image_save_iter == 0:
            rows.append(f"<h3>iteration {j}</h3>")
            rows.append(f'<img src="images/train_{j:08d}.jpg" '
                        'style="width:1024px"><br>')
    html = ("<!DOCTYPE html><html><head><title>vstnet_tpu training</title>"
            '<meta http-equiv="refresh" content="60"></head><body>'
            + "\n".join(rows) + "</body></html>")
    with open(os.path.join(logs_dir, "index.html"), "w") as f:
        f.write(html)


@contextlib.contextmanager
def _no_tf32():
    """Clear TF32 for cuDNN and matmul for the block: autograd's backward
    convs and matmuls run outside the cWCT's own context."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

def train(tc: TrainConfig, content_dir, style_dir, vgg,
          resume: bool = False, resume_iter: int = -1,
          max_steps: Optional[int] = None, loader_workers: int = 4,
          data_parallel: str = "auto", device=None) -> TrainState:
    """The reference train.py loop. `max_steps` caps the steps of this
    call. The step is temporal while step > training_iterations.

    data_parallel: inside a torch.distributed group (torchrun's, or the
    one parallel/multihost.init_distributed joins from the environment)
    "auto" and "on" train data-parallel over its ranks, one device each;
    outside one, "auto" spawns one rank per visible card when there are
    several (NCCL on 127.0.0.1) and returns rank 0's last.pt, "on" needs
    several cards, and "off" (or one device) trains on `vgg`'s device or
    `device`. Data-parallel, the global batch is batch_size per rank, each
    rank's loaders and flow are seeded with seed + rank, rank 0's initial
    or resumed weights are broadcast, the step is
    parallel/sharding.parallel_train_step, and rank 0 alone writes
    loss.log (global-batch means), the checkpoints, the samples and
    index.html."""
    import torch.distributed as dist

    from vstnet_tpu_torch.parallel.multihost import init_distributed

    if tc.precision not in DTYPES:
        raise ValueError(f"precision {tc.precision!r}: use f32 or bf16")
    if data_parallel not in ("auto", "on", "off"):
        raise ValueError(f"data_parallel {data_parallel!r}: use auto, on "
                         "or off")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if init_distributed(backend="gloo" if on_cpu else None) \
            and dist.get_world_size() > 1:
        if data_parallel == "off":
            raise ValueError(f"--data_parallel off in a group of "
                             f"{dist.get_world_size()} processes")
        return _train_loop(tc, content_dir, style_dir, vgg, resume,
                           resume_iter, max_steps, loader_workers,
                           resolve_device(device), dist.get_rank(),
                           dist.get_world_size())
    device = resolve_device(device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if data_parallel == "on" and n_dev < 2:
        raise ValueError(f"--data_parallel on: only {n_dev} device visible")
    if data_parallel != "off" and n_dev > 1:
        from vstnet_tpu_torch.parallel.multihost import spawn_ranks

        vgg_state = {k: v.cpu() for k, v in vgg.state_dict().items()}
        spawn_ranks(_train_rank, n_dev, args=(
            tc, content_dir, style_dir, vgg_state,
            dict(resume=resume, resume_iter=resume_iter,
                 max_steps=max_steps, loader_workers=loader_workers)))
        return load_checkpoint(tc, os.path.join(
            tc.logs_directory, tc.base_name, "checkpoints"), device=device)
    return _train_loop(tc, content_dir, style_dir, vgg, resume, resume_iter,
                       max_steps, loader_workers, device, 0, 1)


def _train_rank(rank, tc, content_dir, style_dir, vgg_state, kwargs):
    """One spawned rank of train(data_parallel="auto"): its card is the
    current device, its group is live."""
    from vstnet_tpu_torch.models.vgg import VGG

    vgg = VGG(device=resolve_device(None))
    vgg.load_state_dict(vgg_state)
    train(tc, content_dir, style_dir, vgg, data_parallel="on", **kwargs)


def _train_loop(tc, content_dir, style_dir, vgg, resume, resume_iter,
                max_steps, loader_workers, device, rank, world):
    from vstnet_tpu_torch.ops.warp import generate_fake_flow
    from vstnet_tpu_torch.train.data import InfiniteLoader

    vgg = vgg.to(device)
    logs_dir = os.path.join(tc.logs_directory, tc.base_name)
    ckpt_dir = os.path.join(logs_dir, "checkpoints")
    img_dir = os.path.join(logs_dir, "images")
    lead = rank == 0
    if lead:
        os.makedirs(img_dir, exist_ok=True)

    if resume:
        state = load_checkpoint(tc, ckpt_dir, resume_iter=resume_iter,
                                device=device)
        if lead:
            print(f"Resume from {ckpt_dir}/last.pt at iter {state.step}")
    else:
        state = init_train_state(tc, device)
    if world > 1:
        import torch.distributed as dist

        from vstnet_tpu_torch.parallel.sharding import parallel_train_step

        with torch.no_grad():
            for t in state.net.state_dict().values():
                dist.broadcast(t, 0)
        step_fn = parallel_train_step
        if lead:
            print(f"data-parallel training over {world} ranks "
                  f"({dist.get_backend()}, global batch "
                  f"{tc.batch_size * world})")
    else:
        step_fn = train_step

    loader_a = InfiniteLoader(content_dir, tc.batch_size, tc.new_size,
                              tc.crop_size, num_workers=loader_workers,
                              seed=tc.seed + rank)
    loader_b = InfiniteLoader(style_dir, tc.batch_size, tc.new_size,
                              tc.crop_size, num_workers=loader_workers,
                              seed=tc.seed + 1000 + rank)
    host_rng = np.random.default_rng(tc.seed + 7 + rank)
    noise_gen = torch.Generator().manual_seed(tc.seed + 13 + rank)
    t0 = time.time()
    end = tc.total_iterations if max_steps is None else min(
        tc.total_iterations, state.step + max_steps)

    try:
        with _no_tf32():
            while state.step < end:
                a = torch.from_numpy(next(loader_a)).to(device)
                b = torch.from_numpy(next(loader_b)).to(device)
                temporal = (tc.weights.temporal > 0
                            and state.step > tc.training_iterations)
                flow = noise = None
                if temporal:
                    f = generate_fake_flow(host_rng, a.shape[1], a.shape[2])
                    flow = torch.from_numpy(f).to(device)[None].expand(
                        *a.shape[:3], 2)
                    stddev = tc.weights.noise_level * (1 + host_rng.random())
                    noise = (stddev * torch.randn(
                        a.shape, generator=noise_gen)).to(device)

                aux = step_fn(state, vgg, a, b, tc, flow, noise, temporal)

                it = state.step
                if not lead:
                    continue   # the log, samples and checkpoints: rank 0
                if it % tc.log_every == 0:
                    msg = loss_message(it, tc.total_iterations, tc.weights,
                                       aux, (time.time() - t0) / max(it, 1))
                    print(msg)
                    write_loss_log(logs_dir, msg)
                if it % tc.image_display_iter == 0 or it == end:
                    da, db = _display_batches(loader_a, loader_b, tc, device)
                    _write_samples(state.net, da, db, img_dir,
                                   "train_current.jpg")
                if it % tc.image_save_iter == 0:
                    da, db = _display_batches(loader_a, loader_b, tc, device)
                    _write_samples(state.net, da, db, img_dir,
                                   f"train_{it:08d}.jpg")
                    write_html(logs_dir, it, tc.image_save_iter)
                if it % tc.model_save_interval == 0:
                    save_checkpoint(state, ckpt_dir, "last.pt")
                if it == tc.training_iterations:
                    save_checkpoint(state, ckpt_dir, "model_image.pt",
                                    with_optimizer=False)
                elif it == tc.total_iterations:
                    save_checkpoint(state, ckpt_dir, "model_video.pt",
                                    with_optimizer=False)
    finally:
        loader_a.close()
        loader_b.close()
    if lead:
        save_checkpoint(state, ckpt_dir, "last.pt")
    if world > 1:
        dist.barrier()
    return state


def _display_batches(loader_a, loader_b, tc: TrainConfig, device):
    """display_size random dataset crops of each side for the sample
    grids, as the reference draws them."""
    return (torch.from_numpy(loader_a.sample(tc.display_size)).to(device),
            torch.from_numpy(loader_b.sample(tc.display_size)).to(device))


def _write_samples(net: RevResNet, a, b, img_dir: str, name: str):
    """[content | style | stylized | cycle reconstruction] grid, on the
    inference path."""
    z_c = net.encode(a)
    stylized = net.decode(cwct.transfer(z_c, net.encode(b)))
    rec = net.decode(cwct.transfer(net.encode(stylized), z_c))
    write_sample_grid(os.path.join(img_dir, name), [a, b, stylized, rec])
