"""ctypes bindings for the native C++ data loader (port of
flvis_tpu/io/native_loader.py over the repository's native/flvis_io.cpp).

Provides PNG decode + rectification + multi-threaded prefetch so the host
loop overlaps disk/decode with device compute — the role the ROS image
pipeline + nodelet threading plays in the reference.  The shared library
is built from native/flvis_io.cpp with g++ (libpng and pthreads) on first
use, into the port's build directory flvis_tpu_torch/_build/ (native/ and
its Makefile belong to the JAX package's loader).  When it cannot be built
or loaded — no compiler, no libpng — `available()` is False, `build_error()`
says why, and callers read with cv2 as the JAX package does.  This is host
decoding: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "flvis_io.cpp"
_LIB_PATH = Path(__file__).resolve().parents[1] / "_build" / "libflvis_io.so"
_lib = None
_error: Optional[str] = None


def _build() -> None:
    """g++ native/flvis_io.cpp → _LIB_PATH, through a temporary file renamed
    into place (several processes may build at once)."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_PATH.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", str(_SOURCE), "-o", tmp,
                        "-shared", "-lpng", "-lpthread"],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SOURCE.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    except subprocess.CalledProcessError as e:
        _error = f"g++ failed (exit {e.returncode}): {e.stderr.strip()[-2000:]}"
        return None
    except (OSError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None
    lib.flvis_decode_png_gray.restype = ctypes.c_int
    lib.flvis_decode_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.flvis_prefetch_create.restype = ctypes.c_void_p
    lib.flvis_prefetch_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.flvis_prefetch_next.restype = ctypes.c_int
    lib.flvis_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.flvis_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is built (building it now if it is not)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _load()
    return _error


def library_path() -> str:
    return str(_LIB_PATH)


def decode_png_gray(path: str) -> Optional[np.ndarray]:
    """A PNG as a (H, W) float32 grayscale image, or None (no library, or
    the file does not decode)."""
    lib = _load()
    if lib is None:
        return None
    max_pixels = 4096 * 3072
    buf = np.empty(max_pixels, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    ok = lib.flvis_decode_png_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_pixels, ctypes.byref(w), ctypes.byref(h),
    )
    if not ok:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class StereoPrefetcher:
    """Background-threaded stereo frame loader with optional rectification.

    maps: None, or a pair ((map0_x, map0_y), (map1_x, map1_y)) of (H, W)
    float32 arrays from cv2.initUndistortRectifyMap.
    """

    def __init__(self, paths0, paths1, width, height, maps=None, num_threads=2):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self._lib = lib
        self.width = width
        self.height = height
        self.n = len(paths0)
        self._mx = self._my = None
        mx_ptr = my_ptr = None
        if maps is not None:
            (m0x, m0y), (m1x, m1y) = maps
            self._mx = np.ascontiguousarray(
                np.concatenate([m0x.reshape(-1), m1x.reshape(-1)]), np.float32)
            self._my = np.ascontiguousarray(
                np.concatenate([m0y.reshape(-1), m1y.reshape(-1)]), np.float32)
            mx_ptr = self._mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            my_ptr = self._my.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._handle = lib.flvis_prefetch_create(
            "\n".join(paths0).encode(), "\n".join(paths1).encode(), self.n,
            width, height, mx_ptr, my_ptr, num_threads,
        )
        self._emitted = 0

    def __iter__(self):
        return self

    def __next__(self):
        # rc: 1 = frame, 0 = failed frame (skip, like the cv2 path's
        # `continue`), -1 = end of stream.
        while True:
            if self._emitted >= self.n:
                raise StopIteration
            img0 = np.empty((self.height, self.width), np.float32)
            img1 = np.empty((self.height, self.width), np.float32)
            rc = self._lib.flvis_prefetch_next(
                self._handle,
                img0.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                img1.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            self._emitted += 1
            if rc == 1:
                return img0, img1
            if rc == -1:
                raise StopIteration

    def close(self):
        if self._handle:
            self._lib.flvis_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
