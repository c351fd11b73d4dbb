"""The JAX package's native checkpoint format: flax's msgpack, read and
written in pure Python and numpy.

flax.serialization.msgpack_serialize writes a tree of maps (str keys),
arrays, str, bin, int, float, bool and nil; an ndarray leaf is msgpack
ext type 1 whose payload is the packed array [shape, dtype name, C-order
bytes] (`_ndarray_to_bytes`), a numpy scalar is ext type 3 with the same
payload. `packb` writes that subset byte for byte as msgpack-python's
`packb` does under flax's settings (str8 and bin types, float64 floats,
the smallest integer and container headers, maps in sorted key order); `unpackb` reads it back, a
numpy scalar as flax returns it (the 0-d array's item).

What this codec does not know raises instead of being misread: another
ext type, a dtype outside _DTYPES (bfloat16 among them, which numpy alone
cannot hold), a payload whose byte count disagrees with its shape, and
flax's chunked arrays (`__msgpack_chunked_array__` maps, which flax
writes only for a leaf past 2**30 bytes).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"
_DTYPES = frozenset(
    ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
     "uint32", "uint64", "float16", "float32", "float64", "complex64",
     "complex128"])


# ---------------------------------------------------------------------------
# Write
# ---------------------------------------------------------------------------

def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes([v])
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        if v >= -32:
            return struct.pack(">b", v)
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: integer {v} out of range")


def _sized(n: int, fix, codes) -> bytes:
    """A header for a length-n object: fix(n) where it fits, else the first
    of codes' (code, struct format, limit) that holds n."""
    head = fix(n)
    if head is not None:
        return head
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: object of length {n} too large")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARR = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _ext_head(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code])
    for head, fmt, top in ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                           (0xc9, ">I", 0xffffffff)):
        if n <= top:
            return bytes([head]) + struct.pack(fmt, n) + bytes([code])
    raise ValueError(f"msgpack: ext payload of {n} bytes too large")


def _ndarray_chunks(arr: np.ndarray):
    """The payload of an ndarray ext as byte chunks, the data as a view."""
    if arr.dtype.name not in _DTYPES:
        raise ValueError(f"msgpack: dtype {arr.dtype} not supported")
    arr = np.asarray(arr, order="C")   # (ascontiguousarray makes 0-d 1-d)
    if arr.dtype.byteorder == ">":
        raise ValueError("msgpack: big-endian arrays not supported")
    head = [b"\x93", _sized(arr.ndim, _fixarray, _ARR)]
    head += [_int(int(d)) for d in arr.shape]
    _pack(arr.dtype.name, head)
    head.append(_sized(arr.nbytes, lambda n: None, _BIN))
    return head + [memoryview(arr.reshape(-1).view(np.uint8))]


def _fixarray(n):
    return bytes([0x90 | n]) if n < 16 else None


def _fixmap(n):
    return bytes([0x80 | n]) if n < 16 else None


def _fixstr(n):
    return bytes([0xa0 | n]) if n < 32 else None


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, np.generic)):
        chunks = _ndarray_chunks(np.asarray(obj))
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        out.append(_ext_head(code, sum(len(c) for c in chunks)))
        out.extend(chunks)
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += [_sized(len(data), _fixstr, _STR), data]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out += [_sized(len(data), lambda n: None, _BIN), data]
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), _fixmap, _MAP))
        for k in sorted(obj):     # flax's tree_map sorts every dict
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), _fixarray, _ARR))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def pack_chunks(tree) -> list:
    """`tree` as a list of byte chunks (array data as views, not copies)."""
    out: list = []
    _pack(tree, out)
    return out


def packb(tree) -> bytes:
    """`tree` in msgpack, as flax.serialization.msgpack_serialize writes a
    tree of dicts and numpy leaves."""
    return b"".join(pack_chunks(tree))


# ---------------------------------------------------------------------------
# Read
# ---------------------------------------------------------------------------

_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_NUM = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
        0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = (">B", ">H", ">I")      # the length of an 8-, 16- and 32-bit form


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown ext type {code}")
        arr = _ndarray(data)
        return arr if code == EXT_NDARRAY else arr[()]

    def obj(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0f)
        if b < 0xa0:
            return [self.obj() for _ in range(b & 0x0f)]
        if b < 0xc0:
            return str(self.take(b & 0x1f), "utf-8")
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUM:
            return self.num(_NUM[b])
        if 0xc4 <= b <= 0xc6:
            return bytes(self.take(self.num(_LEN[b - 0xc4])))
        if 0xd9 <= b <= 0xdb:
            return str(self.take(self.num(_LEN[b - 0xd9])), "utf-8")
        if 0xc7 <= b <= 0xc9:
            n = self.num(_LEN[b - 0xc7])
            return self.ext(self.num(">b"), n)
        if 0xd4 <= b <= 0xd8:
            return self.ext(self.num(">b"), 1 << (b - 0xd4))
        if b in (0xdc, 0xdd):
            return [self.obj() for _ in range(self.num(_LEN[b - 0xdb]))]
        if b in (0xde, 0xdf):
            return self.map(self.num(_LEN[b - 0xdd]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if out.get(CHUNKED):
            raise ValueError(
                "msgpack: a chunked array (a leaf past 2**30 bytes, which "
                "flax splits) is not supported")
        return out


def _ndarray(payload) -> np.ndarray:
    """flax's ndarray payload [shape, dtype name, bytes] -> a new array."""
    r = _Reader(payload)
    if r.take(1)[0] != 0x93:
        raise ValueError("msgpack: malformed ndarray payload")
    shape = r.obj()
    name = r.obj()
    b = r.take(1)[0]
    if not 0xc4 <= b <= 0xc6:
        raise ValueError("msgpack: malformed ndarray payload")
    data = r.take(r.num(_LEN[b - 0xc4]))
    if r.pos != len(payload):
        raise ValueError("msgpack: malformed ndarray payload")
    if not isinstance(name, str) or name not in _DTYPES:
        raise ValueError(f"msgpack: dtype {name!r} not supported")
    dtype = np.dtype(name)
    if (not isinstance(shape, list)
            or not all(isinstance(d, int) and d >= 0 for d in shape)
            or int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            != len(data)):
        raise ValueError(f"msgpack: {len(data)} bytes do not hold a "
                         f"{name} array of shape {shape}")
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def unpackb(buf):
    """The tree in `buf` (bytes or any buffer): maps as dicts, arrays as
    lists, ndarray leaves as new writable numpy arrays."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the object")
    return out
