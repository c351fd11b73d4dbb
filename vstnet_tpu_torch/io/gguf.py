"""GGUF weight interop (read and write), the weight format of the
reference's GGML engine, which streams f16 GGUF checkpoints.

Counterpart of vstnet_tpu/io/gguf.py, pure Python and numpy: the GGUF v3
subset with F32, F16, Q8_0 and Q4_0 tensors. Dim order follows the ggml
convention: ne[0] is the fastest-varying axis (the reversed numpy shape),
which is what the reference's name-mapped loader expects. Q8_0 and Q4_0
store blocks of 32 elements, so the reader and the writer reject a tensor
whose element count is no multiple of 32.

`revresnet_to_gguf` writes a RevResNet's weights under the reference key
names (`RevResNet.state_dict()`), with the tensors that the quantized
types cannot hold in F16; `revresnet_from_gguf` reads them back into a
RevResNet on the device.
"""

from __future__ import annotations

import io
import struct
from typing import Dict

import numpy as np
import torch

from vstnet_tpu_torch.config import PHOTO_CONFIG
from vstnet_tpu_torch.io.checkpoint import tolerant_state_dict
from vstnet_tpu_torch.models.revresnet import RevResNet

GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q8_0 = 0, 1, 2, 8
_MAGIC = 0x46554747
_ALIGN = 32
_TYPES = {"f32": GGML_F32, "f16": GGML_F16, "q8_0": GGML_Q8_0,
          "q4_0": GGML_Q4_0}


# ---------------------------------------------------------------------------
# Read
# ---------------------------------------------------------------------------

def read_gguf(path: str) -> Dict[str, np.ndarray]:
    """-> {name: float32 numpy array in numpy (C-order) shape}."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0

    def u32():
        nonlocal pos
        v = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        return v

    def u64():
        nonlocal pos
        v = struct.unpack_from("<Q", buf, pos)[0]
        pos += 8
        return v

    def s():
        nonlocal pos
        n = u64()
        v = buf[pos:pos + n].decode()
        pos += n
        return v

    if u32() != _MAGIC:
        raise ValueError(f"{path}: not a GGUF file")
    version = u32()
    if version not in (2, 3):
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors, n_kv = u64(), u64()

    align = _ALIGN
    _scalar = {0: 1, 1: 1, 2: 2, 3: 2, 4: 4, 5: 4, 6: 4, 7: 1, 10: 8,
               11: 8, 12: 8}
    for _ in range(n_kv):
        key = s()
        t = u32()
        if t == 8:
            s()
        elif t == 9:
            at, alen = u32(), u64()
            if at == 8:
                for _ in range(alen):
                    s()
            else:
                pos += alen * _scalar[at]
        else:
            if key == "general.alignment" and t == 4:
                align = u32()
            else:
                pos += _scalar[t]

    infos = []
    for _ in range(n_tensors):
        name = s()
        nd = u32()
        ne = [u64() for _ in range(nd)]
        ttype = u32()
        off = u64()
        infos.append((name, ne, ttype, off))

    data_start = (pos + align - 1) // align * align
    out = {}
    for name, ne, ttype, off in infos:
        shape = tuple(reversed(ne))
        n = int(np.prod(shape)) if shape else 1
        if ttype == GGML_F32:
            arr = np.frombuffer(buf, np.float32, n, data_start + off).copy()
        elif ttype == GGML_F16:
            arr = np.frombuffer(buf, np.float16, n, data_start + off)
            arr = arr.astype(np.float32)
        elif ttype == GGML_Q8_0:
            # block = f16 scale + 32 int8 quants; x = d * q
            if n % 32:
                raise ValueError(f"tensor {name}: Q8_0 needs n % 32 == 0")
            raw = np.frombuffer(buf, np.uint8, (n // 32) * 34,
                                data_start + off).reshape(n // 32, 34)
            d = raw[:, :2].copy().view(np.float16).astype(np.float32)
            q = raw[:, 2:].copy().view(np.int8).astype(np.float32)
            arr = (d * q).reshape(-1)
        elif ttype == GGML_Q4_0:
            # block = f16 scale + 16 nibble bytes; element j is the low
            # nibble of qs[j], element j+16 the high nibble; x = d*(q-8)
            if n % 32:
                raise ValueError(f"tensor {name}: Q4_0 needs n % 32 == 0")
            raw = np.frombuffer(buf, np.uint8, (n // 32) * 18,
                                data_start + off).reshape(n // 32, 18)
            d = raw[:, :2].copy().view(np.float16).astype(np.float32)
            qs = raw[:, 2:]
            lo = (qs & 0x0F).astype(np.float32) - 8.0
            hi = (qs >> 4).astype(np.float32) - 8.0
            arr = (d * np.concatenate([lo, hi], axis=1)).reshape(-1)
        else:
            raise ValueError(
                f"tensor {name}: unsupported ggml type {ttype} "
                "(supported: F32, F16, Q4_0, Q8_0)")
        out[name] = arr.reshape(shape)
    return out


# ---------------------------------------------------------------------------
# Write
# ---------------------------------------------------------------------------

def write_gguf(path: str, tensors: Dict[str, np.ndarray],
               dtype: str = "f16"):
    """Write {name: numpy array} (any float dtype in) as GGUF f16, f32,
    q8_0 or q4_0. Returns path."""
    ttype = _ttype(dtype)
    return _write(path, [(k, np.ascontiguousarray(v, np.float32), ttype)
                         for k, v in tensors.items()])


def _ttype(dtype: str) -> int:
    if dtype not in _TYPES:
        raise ValueError(f"write_gguf: dtype {dtype!r}, want one of "
                         f"{sorted(_TYPES)}")
    return _TYPES[dtype]


def _write(path: str, items):
    """items: [(name, float32 array, ggml type)]."""
    hdr = io.BytesIO()
    hdr.write(struct.pack("<II", _MAGIC, 3))
    hdr.write(struct.pack("<QQ", len(items), 1))

    def ws(b, text):
        b.write(struct.pack("<Q", len(text)))
        b.write(text.encode())

    ws(hdr, "general.alignment")
    hdr.write(struct.pack("<I", 4))
    hdr.write(struct.pack("<I", _ALIGN))

    off = 0
    blobs = []
    for name, v, ttype in items:
        if ttype == GGML_Q8_0:
            data = _q8_0_quantize(v)
        elif ttype == GGML_Q4_0:
            data = _q4_0_quantize(v)
        else:
            data = (v.astype(np.float16) if ttype == GGML_F16 else
                    v).tobytes()
        ws(hdr, name)
        hdr.write(struct.pack("<I", v.ndim))
        for d in reversed(v.shape):
            hdr.write(struct.pack("<Q", d))
        hdr.write(struct.pack("<IQ", ttype, off))
        blobs.append(data)
        off = (off + len(data) + _ALIGN - 1) // _ALIGN * _ALIGN

    out = hdr.getvalue()
    pad = (_ALIGN - len(out) % _ALIGN) % _ALIGN
    with open(path, "wb") as f:
        f.write(out + b"\x00" * pad)
        for data in blobs:
            f.write(data)
            p2 = (_ALIGN - len(data) % _ALIGN) % _ALIGN
            f.write(b"\x00" * p2)
    return path


def _q4_0_quantize(v: np.ndarray) -> bytes:
    """float32 -> Q4_0 blocks (ggml block_q4_0: f16 scale d + 32 4-bit
    quants packed two per byte; d = signed_max/-8 per block, q =
    round(x/d)+8 in [0, 15], element j in the low nibble of byte j, j+16
    in the high)."""
    flat = v.reshape(-1)
    if flat.size % 32:
        raise ValueError("Q4_0 requires element count % 32 == 0 "
                         f"(got {flat.size})")
    blocks = flat.reshape(-1, 32)
    idx = np.abs(blocks).argmax(axis=1)
    maxv = blocks[np.arange(len(blocks)), idx]  # signed extreme
    d = (maxv / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.round(blocks * inv[:, None]) + 8.0, 0, 15).astype(np.uint8)
    out = np.empty((blocks.shape[0], 18), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def _q8_0_quantize(v: np.ndarray) -> bytes:
    """float32 -> Q8_0 blocks (ggml block_q8_0: f16 scale d + 32 int8
    quants; d = max|x|/127 per block, q = round(x/d))."""
    flat = v.reshape(-1)
    if flat.size % 32:
        raise ValueError("Q8_0 requires element count % 32 == 0 "
                         f"(got {flat.size})")
    blocks = flat.reshape(-1, 32)
    amax = np.abs(blocks).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.round(blocks * inv[:, None]).astype(np.int8)
    out = np.empty((blocks.shape[0], 34), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


# ---------------------------------------------------------------------------
# Checkpoint conversion
# ---------------------------------------------------------------------------

def revresnet_to_gguf(net_or_state_dict, path: str, dtype: str = "f16"):
    """A RevResNet (or its state dict) -> GGUF under the reference's torch
    key names, which the GGML loader's name map resolves. Returns path.

    With dtype "q8_0" or "q4_0", a tensor whose element count is no
    multiple of the 32-element block (the narrow blocks' biases and some
    of their weights) is written as F16, as ggml's quantizer keeps such
    tensors unquantized; every reader of the format takes a file of mixed
    types."""
    sd = net_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    want = _ttype(dtype)
    quantized = want in (GGML_Q8_0, GGML_Q4_0)
    items = []
    for k, v in sd.items():
        a = np.ascontiguousarray(v.detach().float().cpu().numpy())
        items.append((k, a, GGML_F16 if quantized and a.size % 32 else want))
    return _write(path, items)


def revresnet_from_gguf(path: str, strict: bool = True, cfg=None,
                        seed: int = 0, device=None):
    """A GGUF file of RevResNet weights -> RevResNet(cfg) on `device`
    (None: the CUDA card; device.resolve_device), float32.

    cfg defaults to PHOTO_CONFIG (the photorealistic and the artistic
    configs hold weights of the same shapes, so a file does not tell them
    apart). strict=False skips missing and misshapen tensors with a
    warning, keeping the values of a RevResNet(cfg) initialised from
    `seed` (io/checkpoint.tolerant_state_dict); cfg is then required."""
    sd = {k: torch.from_numpy(v) for k, v in read_gguf(path).items()}
    if not strict:
        if cfg is None:
            raise ValueError("strict=False needs cfg= to size the "
                             "expected weights")
        expected = RevResNet(cfg, device="cpu").init_weights(
            torch.Generator().manual_seed(seed)).state_dict()
        sd = tolerant_state_dict(sd, expected, label=path)
    net = RevResNet(cfg or PHOTO_CONFIG, device=device)
    net.load_state_dict(sd)
    return net
