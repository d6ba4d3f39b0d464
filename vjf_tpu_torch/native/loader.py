"""The native streaming loader and the prefetch to the card (counterpart of
``vjf_tpu/native/loader.py``).

The native side (``src/stream_loader.cpp``, the port's own copy) is a
threaded ring buffer over a file or FIFO. It is compiled with ``g++`` at
first use into ``build/vjf_tpu_torch/stream-<hash>/`` (git-ignored; the hash
covers the source, the compiler and its flags) and loaded with ``ctypes``;
nothing is built when the module is imported. Where it cannot be built, the
loader reads with plain Python, says so in the log, and records the failure
beside the would-be library so that later processes do not try again
(delete the ``build_failed`` file to retry). :func:`device_prefetch` stages
chunks on the card through pinned host memory and a side CUDA stream, so
host IO and the copy overlap the device's compute.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from ..ops import _build

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "src" / "stream_loader.cpp"
BUILD_ROOT = _build.BUILD_ROOT
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def build() -> Path:
    """Compile the loader unless its hashed library exists; raises
    ``RuntimeError`` on a failed build, and at once on a failure recorded by
    an earlier build of the same source."""
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(SRC.read_bytes())
    out_dir = Path(BUILD_ROOT) / f"stream-{h.hexdigest()[:16]}"
    lib, failed = out_dir / "libvjfstream.so", out_dir / "build_failed"
    if lib.exists():
        return lib
    if failed.exists():
        raise RuntimeError(f"cached build failure at {failed} (delete it to retry): "
                           f"{failed.read_text().strip()}")
    out_dir.mkdir(parents=True, exist_ok=True)
    # build to a temporary name and rename: a concurrent loader never sees a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SRC)], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}): {proc.stderr.strip()}")
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        failed.write_text(f"{type(e).__name__}: {e}\n")
        raise RuntimeError(f"build failed ({e}); failure cached at {failed}") from e
    os.replace(tmp, lib)
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    """The native library, built once per process at first use; None (and
    one log line) where it cannot be built."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        path = build()
    except RuntimeError as e:
        logger.warning("native stream loader unavailable (%s); using the Python reader", e)
        return None
    lib = ctypes.CDLL(str(path))
    lib.vjf_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.vjf_stream_open.restype = ctypes.c_int64
    lib.vjf_stream_read.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
    lib.vjf_stream_read.restype = ctypes.c_int64
    lib.vjf_stream_close.argtypes = [ctypes.c_int64]
    lib.vjf_stream_close.restype = None
    _lib = lib
    return _lib


class StreamingLoader:
    """Iterate fixed-shape host chunks ``(chunk, batch, ydim)`` (numpy) from
    a binary stream of per-step records (row-major ``batch * ydim`` values
    of ``dtype``).

    The native ring-buffer reader overlaps ingest with compute where it
    builds; plain Python reads serve otherwise, with the same semantics.
    Every chunk is a fresh array (the ring's slots are reused, so each read
    copies out). The final partial chunk is zero-padded and its true length
    is ``last_valid``. A FIFO's end (its last writer gone) ends the
    iteration; ``close()`` never hangs on an idle FIFO.
    """

    def __init__(self, path: str, ydim: int, batch: int = 1, chunk: int = 256,
                 dtype=np.float32, capacity_chunks: int = 8, native: Optional[bool] = None):
        self.path = path
        self.ydim = ydim
        self.batch = batch
        self.chunk = chunk
        self.dtype = np.dtype(dtype)
        self.step_bytes = self.batch * self.ydim * self.dtype.itemsize
        self.last_valid = chunk
        self._handle = None
        self._fp = None

        lib = _load_native() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native loader requested but unavailable")
        if lib is not None:
            h = lib.vjf_stream_open(path.encode(), self.step_bytes, capacity_chunks * chunk)
            if h > 0:
                self._handle = h
                self._lib = lib
                return
        self._fp = open(path, "rb")

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        buf = np.zeros((self.chunk, self.batch, self.ydim), dtype=self.dtype)
        if self._handle is not None:
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            got = int(self._lib.vjf_stream_read(self._handle, ptr, self.chunk))
        elif self._fp is not None:
            raw = self._fp.read(self.step_bytes * self.chunk)
            got = len(raw) // self.step_bytes
            if got:
                buf[:got] = np.frombuffer(raw[: got * self.step_bytes], dtype=self.dtype
                                          ).reshape(got, self.batch, self.ydim)
        else:
            got = 0
        if got <= 0:
            self.close()
            raise StopIteration
        self.last_valid = got
        return buf

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vjf_stream_close(self._handle)
            self._handle = None
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter shutdown may have torn down ctypes
            pass


def device_prefetch(iterator, depth: int = 2, valid_fn=None, device="cuda"):
    """Stage the chunks of a host iterator on ``device`` ahead of their
    consumption, from a background thread.

    On the card each chunk is copied into pinned host memory, then to the
    card with a ``non_blocking`` copy on a side CUDA stream; an event is
    recorded after the copy, the consumer's current stream waits on it
    before the chunk is yielded, and the chunk is ``record_stream``-ed on
    that stream, so its memory is not reused while the consumer's work may
    read it. ``device="cpu"`` yields copies on the host. ``depth`` chunks
    are staged at most.

    ``valid_fn`` (e.g. ``lambda: loader.last_valid``) is called on the
    producer thread straight after each chunk is drawn, and the generator
    yields ``(chunk, n_valid)`` pairs, what ``VJF.filter_stream`` takes:
    with the producer ahead of the consumer, a ``valid_fn()`` called by the
    consumer would report a later chunk's count. An exception of the
    producer (the iterator, ``valid_fn``, the copy) is raised again in the
    consumer; when the consumer abandons the generator, the worker stops.
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("device_prefetch: no CUDA device; pass device='cpu' to stage on "
                           "the host")
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a plain put would block for ever on a full queue once the consumer
        # is gone, leaking this thread and the source loader
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def stage(item):
        host = torch.as_tensor(item)
        if not on_card:
            return host.to(device, copy=True), None, None
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(side):
            dev = pinned.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        # the pinned buffer rides with the chunk until the consumer has
        # ordered its stream after the copy
        return dev, ready, pinned

    def worker():
        try:
            for item in iterator:
                v = valid_fn() if valid_fn is not None else None
                if not put((stage(item), v)):
                    return
            put(done)
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer, which raises it
            put(e)

    def get():
        # bounded waits: a staging thread that died without a word (it puts
        # its exceptions) must not leave the consumer blocked for ever
        while True:
            try:
                return q.get(timeout=0.5)
            except queue.Empty:
                if not t.is_alive() and q.empty():
                    raise RuntimeError("device_prefetch: the staging thread ended without "
                                       "handing over a chunk") from None

    side = torch.cuda.Stream(device) if on_card else None
    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            (chunk, ready, _pinned), v = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                chunk.record_stream(consumer)
            yield chunk if v is None else (chunk, v)
    finally:
        stop.set()
        # the worker sees ``stop`` within one put timeout; one blocked in the
        # source iterator (an idle FIFO) is a daemon and is left to it
        t.join(timeout=1.0)
