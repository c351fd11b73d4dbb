"""HTTP stylization service of the PyTorch port.

Counterpart of vstnet_tpu/serve.py, with its endpoints and JSON bodies:

  * styles are registered once (`PUT /styles/<name>`): the style image is
    encoded and reduced to its cWCT colouring factors
    (cwct.style_factors[_packed]), which do not depend on the content's
    size, so one registration serves every request;
  * a request's content is replicate-padded to a 64-px shape bucket
    (runtime/buckets.py) and cropped back, so requests of nearby sizes
    share a batch shape;
  * concurrent requests coalesce: one worker thread drains the queue for
    up to batch_window_ms, groups consecutive requests of one (bucket,
    style) key, pads the batch to the next power of two with repeats and
    runs it as one batch;
  * fast=True serves the fused kernel path in bf16 with the packed latent
    (encode_fast, transfer_with_factors_packed, decode_fast); the default
    is the float32 standard path.

The transfer runs frame by frame inside a batch, so a request's pixels do
not depend on its batch-mates: one batched call sums its statistics in
another order at another batch count, which moves replies by uint8 levels
(chip_smoke.py phase 9 prints by how much, and both forms' times). On the
fused path a reply equals the same content sent alone, bit for bit.

Only the worker and style registration touch the devices, each under one
lock, so a registration never interleaves with a batch; HTTP handler
threads decode the request images on the host, and the worker encodes the
replies. `batch_log` keeps, for each recent batch, the worker's host clock
around its device section and its reply encodes, and `/healthz` reports
the encodes' share of the two over the log. Built with `trace_dir`, the
worker runs inside runtime/profiling.trace(trace_dir), where the two
sections are the spans vst.serve_device and vst.serve_reply_encode, and
the trace is written when close() stops it. The model's device decides
where the styles are encoded (StyleModel's constructors put it on the CUDA
card unless given device="cpu"). A failure in a batch (a kernel's included)
is reported to each of its requests and never stops the worker: there is no
fallback to another route.

Several cards, as the JAX service runs over its mesh: with the model on a
card, the service keeps one replica of the weights on every visible card
(or on the `devices` it is given), registers each style's factors on each,
pads a batch to a multiple of the device count, and runs each device's
contiguous shard of it (parallel/sharding.map_shards); the shards come
back in order to the first device. Frames stay independent, so a reply is
the same whichever shard it lands in.

Endpoints:
  GET  /healthz               -> JSON {status, mode, fast, styles, device,
                                       devices, sharded, max_batch,
                                       reply_encode_share}
  PUT  /styles/<name>         -> register a style (body: image bytes);
                                 POST is accepted too
  POST /stylize?style=<name>  -> the stylized PNG (body: content image
                                 bytes; optional &max_size=N)

No third-party server: stdlib http.server with a threading mixin.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from vstnet_tpu_torch.models import cwct
from vstnet_tpu_torch.models import revresnet_fast as rf
from vstnet_tpu_torch.parallel.mesh import make_mesh
from vstnet_tpu_torch.parallel.sharding import gather, map_shards, replicate
from vstnet_tpu_torch.runtime.buckets import bucket_hw
from vstnet_tpu_torch.runtime.profiling import span, trace


def _decode_image(data: bytes, max_size: Optional[int], down_scale: int):
    """Image bytes -> uint8 (1, H, W, 3), the longest side capped at
    max_size and both sides floored to multiples of down_scale
    (io/image.resize_pil)."""
    from PIL import Image

    from vstnet_tpu_torch.io.image import resize_pil

    img = Image.open(io.BytesIO(data)).convert("RGB")
    img = resize_pil(img, max_size, down_scale)
    return np.array(img, dtype=np.uint8)[None]     # writable, for torch


def _encode_png(arr) -> bytes:
    from PIL import Image

    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


@dataclass
class _Job:
    content: np.ndarray           # padded (1, BH, BW, 3) uint8
    hw: Tuple[int, int]           # original size to crop back to
    key: Tuple[int, int, str]     # (BH, BW, style name) coalescing key
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[bytes] = None
    error: Optional[str] = None


class StyleService:
    """Model + registered styles + the coalescing batch worker. Builds
    nothing itself: it runs where `model.net` lies, and on every visible
    card when that is a card (`devices`, a mesh of parallel/mesh.py,
    overrides it). `close()` stops the worker. With `trace_dir`, the
    worker's whole life is one profiling.trace under that directory."""

    def __init__(self, model, fast: bool = False, grid: int = 64,
                 max_size: int = 1280, max_batch: int = 8,
                 batch_window_ms: float = 5.0, devices=None,
                 trace_dir: Optional[str] = None):
        self.model = model
        self.trace_dir = trace_dir
        self.fast = fast
        self.grid = grid
        self.max_size = max_size
        self.max_batch = max_batch
        self.window_s = batch_window_ms / 1000.0
        self.device = next(model.net.parameters()).device
        if devices is None:
            devices = (make_mesh() if self.device.type == "cuda"
                       else (self.device,))
        self.devices = tuple(torch.device(d) for d in devices)
        self._shards = map_shards(self.devices, self._program)
        self.styles: Dict[str, Tuple] = {}   # name -> (ls, mu_s)
        self._replicas: Dict[str, Tuple] = {}  # name -> one copy a device
        # registrations come from handler threads, reads from the worker
        self._styles_lock = threading.Lock()
        # one user of the device at a time: the worker's batches and
        # style registrations
        self._device_lock = threading.Lock()
        # (end time, requests, padded batch, device s, encode s) a batch,
        # on time.perf_counter: the device section holds the lock wait,
        # the upload, the launches and the readback
        self.batch_log = collections.deque(maxlen=4096)
        self._q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def close(self, timeout: float = 30.0):
        """Stop the worker after the requests already queued."""
        self._q.put(None)
        self._worker.join(timeout)

    # -- style registration ------------------------------------------------
    def register_style(self, name: str, data: bytes):
        cfg = self.model.cfg
        img = _decode_image(data, self.max_size, cfg.down_scale)
        with self._device_lock, self._on_device(), torch.no_grad():
            x = torch.from_numpy(img).to(self.device).float() / 255.0
            if self.fast:
                fp = self.model.fast_params
                zp = rf.encode_fast(fp, x.to(fp["dtype"]), cfg,
                                    packed_latent=True)
                ls, mu = cwct.style_factors_packed(zp, cfg.latent_channels)
            else:
                ls, mu = cwct.style_factors(self.model.net.encode(x))
            # (C, C) and (C,) per style: resolution-independent, reused
            # by every request, on every device
            factors = replicate(self.devices, (ls, mu))
        with self._styles_lock:
            self.styles[name] = (ls, mu)
            self._replicas[name] = factors

    def reply_encode_share(self) -> Optional[float]:
        """The reply encodes' seconds over the device sections' and the
        encodes' seconds, summed over batch_log; None before the first
        batch."""
        log = tuple(self.batch_log)
        dev = sum(e[3] for e in log)
        enc = sum(e[4] for e in log)
        return enc / (dev + enc) if log else None

    def style_names(self):
        with self._styles_lock:
            return sorted(self.styles)

    def _style_factors(self, name: str):
        """The style's factors, one copy a device."""
        with self._styles_lock:
            return self._replicas[name]

    # -- request path -------------------------------------------------------
    def stylize(self, data: bytes, style: str,
                max_size: Optional[int] = None) -> bytes:
        """Content image bytes -> stylized PNG bytes, through the worker."""
        with self._styles_lock:
            if style not in self.styles:
                raise KeyError(style)
        img = _decode_image(data, max_size or self.max_size,
                            self.model.cfg.down_scale)
        h, w = img.shape[1], img.shape[2]
        bh, bw = bucket_hw(h, w, self.grid)
        padded = np.pad(img, ((0, 0), (0, bh - h), (0, bw - w), (0, 0)),
                        mode="edge")
        job = _Job(content=padded, hw=(h, w), key=(bh, bw, style))
        self._q.put(job)
        job.done.wait()
        if job.error is not None:
            raise RuntimeError(job.error)
        return job.result

    # -- device worker -------------------------------------------------------
    def _drain_batch(self, first: Optional[_Job] = None):
        """One coalesced batch: the first job blocks (or is the one stashed
        by the previous drain), then same-key jobs join for up to the batch
        window. A different key ends the batch and becomes the next stash,
        which gets a fresh window: its batch-mates may still be arriving.
        (None, None) once close() was called."""
        if first is None:
            first = self._q.get()
            if first is None:
                return None, None
        batch = [first]
        stash = None
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)   # stop after this batch
                break
            if nxt.key == first.key:
                batch.append(nxt)
            else:
                stash = nxt
                break
        return batch, stash

    @torch.no_grad()
    def _program(self, weights, frames, factors):
        """One device's shard: uint8 (b, H, W, 3) -> stylized uint8, with
        that device's weights (the packed fast weights or the net) and
        style factors."""
        ls, mu = factors
        cfg = self.model.cfg
        c_lat = cfg.latent_channels
        x = frames.float() / 255.0
        if self.fast:
            zp = rf.encode_fast(weights, x.to(weights["dtype"]), cfg,
                                packed_latent=True)
            z_cs = torch.cat([cwct.transfer_with_factors_packed(
                zp[i:i + 1], ls, mu, c_lat) for i in range(zp.shape[0])])
            out = rf.decode_fast(weights, z_cs, cfg, packed_latent=True)
        else:
            z = weights.encode(x)
            z_cs = torch.cat([cwct.transfer_with_factors(z[i:i + 1], ls, mu)
                              for i in range(z.shape[0])])
            out = weights.decode(z_cs)
        out = out.float().clamp(0.0, 1.0)
        return torch.round(out * 255.0).to(torch.uint8)

    def _stylize_batch(self, frames, style_name: str):
        """uint8 (B, H, W, 3) on the first device, B a multiple of the
        device count -> stylized uint8 there, same shape: each device
        stylizes its contiguous shard."""
        weights = self.model.fast_params if self.fast else self.model.net
        return gather(self._shards(weights, frames,
                                   self._style_factors(style_name)))

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        # a profiler records the spans of its own thread only
        with (trace(self.trace_dir) if self.trace_dir
              else contextlib.nullcontext()):
            self._serve_batches()

    def _serve_batches(self):
        stash = None
        while True:
            batch, stash = self._drain_batch(stash)
            if batch is None:
                return
            try:
                # pad the batch to the next power of two (a few batch
                # shapes per bucket instead of one per batch size), then
                # to a multiple of the device count, so that it shards
                n = len(batch)
                n_pad = 1
                while n_pad < n:
                    n_pad *= 2
                n_dev = len(self.devices)
                n_pad = -(-n_pad // n_dev) * n_dev
                frames = np.concatenate(
                    [j.content for j in batch]
                    + [batch[0].content] * (n_pad - n), axis=0)
                t0 = time.perf_counter()
                with span("serve_device"), self._device_lock:
                    x = torch.from_numpy(frames).to(self.devices[0])
                    out = self._stylize_batch(x, batch[0].key[2]).cpu()
                t1 = time.perf_counter()
                out = out.numpy()
                with span("serve_reply_encode"):
                    for i, j in enumerate(batch):
                        h, w = j.hw
                        j.result = _encode_png(out[i, :h, :w])
                        j.done.set()
                t2 = time.perf_counter()
                self.batch_log.append((t2, n, n_pad, t1 - t0, t2 - t1))
            except Exception as e:  # report, never kill the worker
                for j in batch:
                    j.error = f"{type(e).__name__}: {e}"
                    j.done.set()


def make_handler(service: StyleService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(n)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                info = {
                    "status": "ok",
                    "mode": service.model.mode,
                    "fast": service.fast,
                    "styles": service.style_names(),
                    "device": service.device_name(),
                    "devices": len(service.devices),
                    "sharded": len(service.devices) > 1,
                    "max_batch": service.max_batch,
                    "reply_encode_share": service.reply_encode_share(),
                }
                self._reply(200, json.dumps(info).encode())
            else:
                self._reply(404, b'{"error": "not found"}')

        def do_PUT(self):
            path = urlparse(self.path).path
            if path.startswith("/styles/") and len(path) > len("/styles/"):
                name = path[len("/styles/"):]
                try:
                    service.register_style(name, self._body())
                except Exception as e:
                    self._reply(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())
                    return
                self._reply(200, json.dumps({"registered": name}).encode())
            else:
                self._reply(404, b'{"error": "not found"}')

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path.startswith("/styles/"):
                return self.do_PUT()
            if parsed.path != "/stylize":
                self._reply(404, b'{"error": "not found"}')
                return
            q = parse_qs(parsed.query)
            style = q.get("style", [None])[0]
            if style is None or style not in service.style_names():
                self._reply(404, json.dumps(
                    {"error": f"unknown style {style!r}",
                     "styles": service.style_names()}).encode())
                return
            max_size = q.get("max_size", [None])[0]
            try:
                png = service.stylize(
                    self._body(), style,
                    max_size=int(max_size) if max_size else None)
            except Exception as e:
                self._reply(400, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode())
                return
            self._reply(200, png, ctype="image/png")

    return Handler


def serve(service: StyleService, host: str = "127.0.0.1", port: int = 8790):
    """The HTTP server in front of `service` (not yet serving: call its
    serve_forever, and shutdown to stop it)."""
    return ThreadingHTTPServer((host, port), make_handler(service))
