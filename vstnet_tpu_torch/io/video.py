"""Video I/O, numpy and PIL on the host.

A copy of vstnet_tpu/io/video.py (which the port may not import), with
make_dataset from vstnet_tpu/train/data.py for frame directories. Sources
and sinks, in order of preference:
  * a pure-Python RIFF/AVI parser and writer for MJPEG (each frame is a
    JPEG, decoded and encoded by PIL): it owns the .avi path, so .avi round
    trips are deterministic and need no codec library;
  * cv2, when importable, for every other container, notably .mp4 with the
    mp4v fourcc, read and write;
  * a frame directory (sorted images).
"""

from __future__ import annotations

import io
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# MJPEG AVI reader
# ---------------------------------------------------------------------------

def _walk_chunks(buf: memoryview, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        fourcc = bytes(buf[pos:pos + 4])
        size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


def _index_avi(data: memoryview, path: str):
    """One cheap structural pass: (frame (offset, size) list, fps).

    No JPEG decode happens here — decode cost and memory are paid per
    frame by the caller, so a long video never has to fit in RAM decoded."""
    if bytes(data[:4]) != b"RIFF" or bytes(data[8:12]) != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")

    fps = 25.0
    index: List[Tuple[int, int]] = []

    def scan_list(start, end):
        nonlocal fps
        for fourcc, off, size in _walk_chunks(data, start, end):
            if fourcc == b"LIST":
                list_type = bytes(data[off:off + 4])
                if list_type == b"movi":
                    for cc, o2, s2 in _walk_chunks(data, off + 4, off + size):
                        if cc[2:4] in (b"dc", b"db") and s2 > 0:
                            index.append((o2, s2))
                else:
                    scan_list(off + 4, off + size)
            elif fourcc == b"avih":
                usec_per_frame = struct.unpack("<I", data[off:off + 4])[0]
                if usec_per_frame > 0:
                    fps = 1e6 / usec_per_frame

    scan_list(12, len(data))
    if not index:
        raise ValueError(f"{path}: no MJPEG frames found (codec unsupported?)")
    return index, fps


def _decode_indexed(data: memoryview, index) -> Iterator[np.ndarray]:
    from PIL import Image

    for off, size in index:
        img = Image.open(io.BytesIO(bytes(data[off:off + size])))
        yield np.asarray(img.convert("RGB"))


def read_avi(path: str) -> Tuple[List[np.ndarray], float]:
    """Read an MJPEG AVI -> (frames [HWC uint8 RGB], fps). Eager; for long
    videos prefer read_frames(), which decodes lazily."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    index, fps = _index_avi(data, path)
    return list(_decode_indexed(data, index)), fps


# ---------------------------------------------------------------------------
# MJPEG AVI writer
# ---------------------------------------------------------------------------

def _encode_jpeg(frame: np.ndarray, quality: int) -> bytes:
    """HWC uint8 RGB -> JPEG bytes. Routes through cv2 (libjpeg-turbo,
    measured ~1.5x faster than PIL at 512²) when importable, PIL
    otherwise. Pure function — safe to call from many threads at once,
    which is what AsyncWriter's encode pool does."""
    cv2 = _cv2()
    if cv2 is not None:
        ok, enc = cv2.imencode(
            ".jpg", np.ascontiguousarray(frame[:, :, ::-1]),
            [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
        if ok:
            return enc.tobytes()
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _as_uint8(frame: np.ndarray) -> np.ndarray:
    if frame.dtype != np.uint8:
        frame = np.clip(np.asarray(frame) * 255.0, 0, 255).astype(np.uint8)
    return frame


class AviWriter:
    """Streaming MJPEG AVI writer (RIFF + avih/strh/strf + movi + idx1).

    Truly streaming: the header goes to disk on the first frame (with
    placeholder counts), every frame chunk is appended immediately, and
    close() writes idx1 then seeks back to patch the RIFF/avih/strh/movi
    size fields. Host memory is O(1) in video length — only the 16-byte
    idx1 entries accumulate (160 KB for a 10k-frame video), never the
    JPEGs. This replaces the reference's buffer-whole-video writers
    (video_transfer.py:89-106 holds cv2 writers, but ingests the entire
    input into RAM at 68-78).

    The encode step is exposed separately (`encode` / `write_payload`) so
    AsyncWriter can fan JPEG compression out over a thread pool while this
    class remains the single ordered container appender.
    """

    # fixed header geometry (bytes): RIFF(12) LIST hdrl(12 + avih(8+56)
    #   + LIST strl(12 + strh(8+56) + strf(8+40))) then LIST movi header.
    _AVIH_OFF = 12 + 12 + 8          # file offset of the avih payload
    _STRH_OFF = _AVIH_OFF + 56 + 12 + 8   # offset of the strh payload
    _MOVI_LIST_OFF = _STRH_OFF + 56 + 8 + 40  # offset of 'LIST' for movi

    def __init__(self, path: str, fps: float = 25.0, quality: int = 92):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.fps = fps
        self.quality = quality
        self._f = None
        self._size: Optional[Tuple[int, int]] = None
        self._idx: List[Tuple[int, int]] = []   # (offset rel. movi, size)
        self._movi_pos = 0                       # running offset in movi
        self._max_bytes = 0

    # -- split encode/append API (the encode half is thread-safe) ---------
    def encode(self, frame: np.ndarray):
        """Pure CPU half: frame -> payload accepted by write_payload()."""
        frame = _as_uint8(frame)
        return (_encode_jpeg(frame, self.quality),
                (frame.shape[1], frame.shape[0]))

    def _open(self, w: int, h: int):
        self._size = (w, h)
        self._f = open(self.path, "wb")
        usec = int(1e6 / max(self.fps, 1e-6))
        # placeholder counts/sizes; close() patches them in place
        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            usec, 0, 0, 0x10,  # HASINDEX
            0, 0, 1, 0, w, h, 0, 0, 0, 0,
        )
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh",
            b"vids", b"MJPG", 0, 0, 0, 0, 1, int(round(self.fps)),
            0, 0, 0, 0xFFFFFFFF, 0, 0, 0, w, h,
        )
        strf = struct.pack(
            "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0
        )
        strl = b"LIST" + struct.pack("<I", 4 + 8 + 56 + 8 + 40) + b"strl" \
            + b"strh" + struct.pack("<I", 56) + strh \
            + b"strf" + struct.pack("<I", 40) + strf
        hdrl = b"LIST" + struct.pack("<I", 4 + 8 + 56 + len(strl)) + b"hdrl" \
            + b"avih" + struct.pack("<I", 56) + avih + strl
        self._f.write(b"RIFF" + struct.pack("<I", 0) + b"AVI " + hdrl)
        assert self._f.tell() == self._MOVI_LIST_OFF
        self._f.write(b"LIST" + struct.pack("<I", 0) + b"movi")
        self._movi_pos = 4  # idx offsets are relative to the movi fourcc

    def write_payload(self, payload):
        """Append one encoded frame (output of encode()) to the container."""
        jpeg, (w, h) = payload
        if self._f is None:
            self._open(w, h)
        pad = b"\x00" if len(jpeg) & 1 else b""
        self._f.write(b"00dc" + struct.pack("<I", len(jpeg)) + jpeg + pad)
        self._idx.append((self._movi_pos, len(jpeg)))
        self._movi_pos += 8 + len(jpeg) + len(pad)
        self._max_bytes = max(self._max_bytes, len(jpeg))

    def write(self, frame: np.ndarray):
        """frame: HWC uint8 RGB (or float [0,1])."""
        self.write_payload(self.encode(frame))

    def close(self):
        if self._f is None:
            raise ValueError("no frames written")
        f, (w, h) = self._f, self._size
        n = len(self._idx)
        idx1 = b"".join(
            struct.pack("<4sIII", b"00dc", 0x10, off, size)
            for off, size in self._idx)
        f.write(b"idx1" + struct.pack("<I", len(idx1)) + idx1)
        file_size = f.tell()
        # patch the placeholder sizes now that counts are known
        f.seek(4)
        f.write(struct.pack("<I", file_size - 8))            # RIFF size
        f.seek(self._AVIH_OFF + 4)
        f.write(struct.pack("<I", self._max_bytes * int(self.fps)))
        f.seek(self._AVIH_OFF + 16)
        f.write(struct.pack("<I", n))                        # dwTotalFrames
        f.seek(self._AVIH_OFF + 28)
        f.write(struct.pack("<I", self._max_bytes))          # suggested buf
        f.seek(self._STRH_OFF + 32)
        f.write(struct.pack("<II", n, self._max_bytes))      # dwLength, buf
        f.seek(self._MOVI_LIST_OFF + 4)
        f.write(struct.pack("<I", self._movi_pos))           # movi list size
        f.close()
        self._f = None
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# cv2-backed container support (.mp4 and friends)
# ---------------------------------------------------------------------------

def _cv2():
    try:
        import cv2

        return cv2
    except Exception:
        return None


def have_cv2() -> bool:
    return _cv2() is not None


class Cv2Writer:
    """cv2.VideoWriter wrapper (RGB frames in; the reference's mp4v
    fourcc for .mp4, video_transfer.py:94-96)."""

    def __init__(self, path: str, fps: float = 25.0, fourcc: str = "mp4v"):
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("cv2 not available; use AviWriter")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.fps = fps
        self._cv2 = cv2
        # cv2.VideoWriter.fourcc is the stable spelling (the module-level
        # VideoWriter_fourcc is an alias generated at import).
        self._fourcc = cv2.VideoWriter.fourcc(*fourcc)
        self._w = None

    def write(self, frame: np.ndarray):
        """frame: HWC uint8 RGB (or float [0,1])."""
        if frame.dtype != np.uint8:
            frame = np.clip(np.asarray(frame) * 255.0, 0, 255).astype(np.uint8)
        if self._w is None:
            h, w = frame.shape[:2]
            self._w = self._cv2.VideoWriter(
                self.path, self._fourcc, self.fps, (w, h))
            if not self._w.isOpened():
                raise IOError(f"cv2.VideoWriter failed to open {self.path}")
        self._w.write(np.ascontiguousarray(frame[:, :, ::-1]))  # RGB->BGR

    def close(self):
        if self._w is None:
            raise ValueError("no frames written")
        self._w.release()
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_video_writer(path: str, fps: float = 25.0):
    """Writer for `path` by extension: .avi -> the in-repo MJPEG writer
    (deterministic, dependency-free); anything else -> cv2 (mp4v for
    .mp4). Raises if a non-avi container is requested without cv2."""
    if path.lower().endswith(".avi") or _cv2() is None:
        if not path.lower().endswith(".avi"):
            raise RuntimeError(
                f"{path}: only .avi can be written without cv2")
        return AviWriter(path, fps)
    return Cv2Writer(path, fps)


# ---------------------------------------------------------------------------
# Unified frame sources / sinks
# ---------------------------------------------------------------------------

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp",
                  ".JPG", ".JPEG", ".PNG", ".PPM", ".BMP")


def make_dataset(root) -> List[str]:
    """The image files under root (a directory or a list of them),
    recursively, in sorted order."""
    roots = root if isinstance(root, (list, tuple)) else [root]
    images: List[str] = []
    for r in roots:
        if not os.path.isdir(r):
            raise RuntimeError(f"{r} is not a valid directory")
        for base, _, fnames in sorted(os.walk(r)):
            images.extend(
                os.path.join(base, f) for f in sorted(fnames)
                if f.endswith(IMG_EXTENSIONS)
            )
    if not images:
        raise RuntimeError(f"Found 0 images in {root}")
    return images


def read_frames(path: str) -> Tuple[Iterator[np.ndarray], int, float]:
    """Video file or frame directory -> (frame iterator, count, fps).

    Frames decode LAZILY (per pull): only the raw container bytes are
    resident, never the decoded video. .avi routes through the in-repo
    MJPEG parser; other containers (.mp4, ...) decode via cv2. Wrap the
    iterator in prefetch_frames() to overlap decode with device compute."""
    from PIL import Image

    if os.path.isdir(path):
        files = make_dataset(path)

        def gen():
            for fp in files:
                yield np.asarray(Image.open(fp).convert("RGB"))

        return gen(), len(files), 25.0
    if not path.lower().endswith(".avi"):
        cv2 = _cv2()
        if cv2 is None:
            raise ValueError(
                f"{path}: only .avi readable without cv2 (not installed)")
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise ValueError(f"{path}: cv2 cannot open this video")
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 25.0
        if n <= 0:
            raise ValueError(f"{path}: container reports no frames")

        def gen():
            try:
                while True:
                    ok, f = cap.read()
                    if not ok:
                        return
                    yield np.ascontiguousarray(f[:, :, ::-1])  # BGR->RGB
            finally:
                cap.release()

        return gen(), n, fps
    with open(path, "rb") as f:
        data = memoryview(f.read())
    index, fps = _index_avi(data, path)
    return _decode_indexed(data, index), len(index), fps


# ---------------------------------------------------------------------------
# Async host-side decode/encode (SURVEY §7 hard-part 5: the device should
# never wait on JPEG work; a 1000-fps device loop dies the moment decode
# or encode runs synchronously in the dispatch thread)
# ---------------------------------------------------------------------------

_SENTINEL = object()


def prefetch_frames(frames: Iterator[np.ndarray],
                    depth: int = 64) -> Iterator[np.ndarray]:
    """Decode-ahead iterator: a daemon thread pulls `frames` into a
    bounded queue so JPEG decode overlaps device compute. Exceptions in
    the worker re-raise at the consumer's next pull."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))

    def work():
        try:
            for f in frames:
                q.put(f)
            q.put(_SENTINEL)
        except BaseException as e:  # re-raise on the consumer side
            q.put(e)

    threading.Thread(target=work, daemon=True).start()

    def gen():
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    return gen()


class AsyncWriter:
    """Threaded wrapper over a frame writer. Two shapes, picked by the
    inner writer's capabilities:

      * encode POOL (inner exposes thread-safe ``encode``/``write_payload``,
        e.g. AviWriter): write() enqueues (seq, frame); N encoder threads
        JPEG-compress concurrently — the CPU-bound half, ~5-7 ms/frame at
        512² per core — and a single appender drains the results back into
        sequence order before touching the container. At the ≥1000 fps
        north star the single-threaded encoder was the measured host
        bottleneck (~150-215 fps/core); the pool's ceiling scales with
        host cores (scripts/bench_video_e2e.py measures it).
      * serial (any other writer, e.g. Cv2Writer whose encode lives inside
        cv2.VideoWriter.write): one worker thread runs inner.write, the
        pre-round-4 behavior.

    Worker exceptions re-raise on the caller's next write()/close().
    """

    def __init__(self, inner, depth: int = 64, workers: Optional[int] = None):
        import queue
        import threading

        self._inner = inner
        self._err: Optional[BaseException] = None
        self._pooled = hasattr(inner, "encode") and hasattr(
            inner, "write_payload")
        if workers is None:
            workers = min(os.cpu_count() or 1, 8) if self._pooled else 1
        self._workers = max(1, workers) if self._pooled else 1
        depth = max(depth, 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._seq = 0
        self._threads = []
        if self._pooled:
            # encoders feed an ordered drain; the appender owns the file
            self._out: "queue.Queue" = queue.Queue(maxsize=depth)
            for _ in range(self._workers):
                t = threading.Thread(target=self._encode_work, daemon=True)
                t.start()
                self._threads.append(t)
            self._appender = threading.Thread(
                target=self._append_work, daemon=True)
            self._appender.start()
        else:
            t = threading.Thread(target=self._serial_work, daemon=True)
            t.start()
            self._threads.append(t)

    # -- serial shape ------------------------------------------------------
    def _serial_work(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            if self._err is None:
                try:
                    self._inner.write(item[1])
                except BaseException as e:
                    self._err = e  # surface on next write()/close()

    # -- pool shape --------------------------------------------------------
    def _encode_work(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                self._out.put(_SENTINEL)
                return
            seq, frame = item
            if self._err is not None:
                continue
            try:
                self._out.put((seq, self._inner.encode(frame)))
            except BaseException as e:
                self._err = e

    def _append_work(self):
        pending = {}
        next_seq = 0
        ended = 0
        while ended < self._workers:
            item = self._out.get()
            if item is _SENTINEL:
                ended += 1
                continue
            seq, payload = item
            pending[seq] = payload
            while next_seq in pending and self._err is None:
                try:
                    self._inner.write_payload(pending.pop(next_seq))
                except BaseException as e:
                    self._err = e
                    break
                next_seq += 1
        # flush any stragglers that arrived out of order before the end
        while next_seq in pending and self._err is None:
            try:
                self._inner.write_payload(pending.pop(next_seq))
            except BaseException as e:
                self._err = e
                break
            next_seq += 1

    # -- caller API --------------------------------------------------------
    def _check(self):
        if self._err is not None:
            raise self._err  # sticky: a failed stream stays failed

    def write(self, frame: np.ndarray):
        self._check()
        self._q.put((self._seq, frame))
        self._seq += 1

    def close(self):
        for _ in self._threads:
            self._q.put(_SENTINEL)
        for t in self._threads:
            t.join()
        if self._pooled:
            self._appender.join()
        try:
            self._inner.close()  # always finalize the container
        finally:
            self._check()  # then surface any worker failure

    @property
    def path(self):
        return getattr(self._inner, "path", None)

