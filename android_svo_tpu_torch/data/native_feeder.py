"""ctypes bindings of the native (C++) frame feeder — port of
`android_svo_tpu/data/native_feeder.py`: threaded PNG/PGM decode with a
bounded prefetch ring (`native/frame_feeder.cpp`, `native/png_decode.cpp`),
so the tracker never waits on file IO or decode in Python.

The library is built from the repository's `native/` sources with
`make -C native BUILD=build/torch_native` the first time it is needed (make
rebuilds it when a source is newer); a failed build raises.  There is no
fallback to a Python decoder: `available()` only tells a caller (the CPU
tests) whether the library builds here.

On CUDA, `NativeFrameFeeder` decodes each frame straight into a slot of a
ring of pinned host buffers and copies it to a fresh device tensor with
`non_blocking=True`; an event recorded after the copy guards the slot,
which is not written again until its copy has completed.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.utils import profiling

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIB_PATH = BUILD_DIR / "libsvo_native.so"

_lib = None


def build() -> Path:
    """Run make on `native/` into `build/torch_native/` (one process at a
    time: a file lock serialises concurrent builds); raises if it fails.
    Span `build.native_feeder`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with profiling.span("build.native_feeder"), \
            open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(
            ["make", "-C", str(NATIVE_DIR), f"BUILD={BUILD_DIR}"],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native feeder failed "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return LIB_PATH


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.ff_create.restype = ctypes.c_void_p
    lib.ff_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                              ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ff_next.restype = ctypes.c_int
    lib.ff_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int]
    lib.ff_count.restype = ctypes.c_int
    lib.ff_count.argtypes = [ctypes.c_void_p]
    lib.ff_dims.restype = ctypes.c_int
    lib.ff_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)]
    lib.ff_destroy.restype = None
    lib.ff_destroy.argtypes = [ctypes.c_void_p]
    lib.ff_decode_file.restype = ctypes.c_int
    lib.ff_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load_library()
        return True
    except (RuntimeError, OSError):
        return False


def decode_image(path: str, max_pixels: int = 4096 * 4096) -> torch.Tensor:
    """One-shot native decode of a PNG/PGM to a float32 (H, W) CPU
    tensor."""
    lib = _load_library()
    buf = torch.empty((max_pixels,), dtype=torch.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.ff_decode_file(path.encode(), buf.data_ptr(), max_pixels,
                            ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return buf[: h.value * w.value].reshape(h.value, w.value).clone()


class NativeFrameFeeder:
    """Prefetching iterator over image paths, yielding (index, frame) in
    sequence order: a float32 (H, W) tensor on the feeder's device (CUDA
    unless `device="cpu"`; without a card the constructor raises).

    On the CPU each frame is a fresh tensor.  On CUDA each is a fresh
    device tensor, copied without blocking from one of `capacity` pinned
    slots; `wait_s` sums the host time spent waiting for decoded frames
    and free slots."""

    _handle = None

    def __init__(self, paths: Sequence[str], capacity: int = 16,
                 n_threads: int = 4, device=None):
        self.device = resolve_device(device)
        self._lib = _load_library()
        arr = (ctypes.c_char_p * len(paths))(
            *[str(p).encode() for p in paths])
        self._handle = self._lib.ff_create(arr, len(paths), capacity,
                                           n_threads)
        h = ctypes.c_int()
        w = ctypes.c_int()
        if self._lib.ff_dims(self._handle, ctypes.byref(h),
                             ctypes.byref(w)) != 0:
            raise IOError("frame feeder: failed to decode first frame")
        self.height = h.value
        self.width = w.value
        self.capacity = max(int(capacity), 1)
        self._n = len(paths)
        self.wait_s = 0.0

    def __len__(self):
        return self._n

    def _next(self, buf: torch.Tensor):
        """Decode the next frame into `buf`; its index, or None at the
        end."""
        rc = self._lib.ff_next(self._handle, buf.data_ptr(), self.height,
                               self.width)
        if rc == -1:
            return None
        if rc < 0:
            raise IOError(f"frame feeder error {rc}")
        return rc

    def __iter__(self):
        shape = (self.height, self.width)
        if self.device.type != "cuda":
            while True:
                buf = torch.empty(shape)
                idx = self._next(buf)
                if idx is None:
                    return
                yield idx, buf
        slots = [torch.empty(shape, pin_memory=True)
                 for _ in range(self.capacity)]
        copied = [None] * self.capacity
        k = 0
        while True:
            s = k % self.capacity
            t0 = time.perf_counter()
            if copied[s] is not None:
                copied[s].synchronize()   # the slot's last copy is done
            idx = self._next(slots[s])
            self.wait_s += time.perf_counter() - t0
            if idx is None:
                return
            out = torch.empty(shape, device=self.device)
            out.copy_(slots[s], non_blocking=True)
            copied[s] = torch.cuda.Event()
            copied[s].record()
            k += 1
            yield idx, out

    def close(self):
        if self._handle:
            self._lib.ff_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
