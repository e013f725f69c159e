"""ctypes bindings + lazy build of the native data-loading pipeline.

Counterpart of dmvio_tpu/io/native.py. The C++ library
(native/dataloader.cpp, shared with the JAX package) does PNG decode,
gamma/vignette correction and the undistortion remap on a prefetching
worker pool: the runtime role DM-VIO fills with its C++
DatasetReader/Undistort stack.

The library is built from that source into the git-ignored
build/native/ at first use (never at import), with the flags of
native/Makefile, and rebuilt when the source is newer than the library.
Nothing is written into native/. Callers check `available()`;
`load_error()` says why the library could not be built or loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "dataloader.cpp"
BUILD_DIR = _REPO / "build" / "native"
LIB = BUILD_DIR / "libdmvio_native.so"
# native/Makefile's CXXFLAGS, plus -shared and -lz as its link line has.
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread"]

_LIB = None
_TRIED = False
_ERROR: Optional[str] = None


def _build() -> None:
    """Compile SRC into LIB unless LIB is at least as new as SRC. The
    library is written to a temporary name and renamed, so concurrent
    processes never load a half-written file."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o",
           str(tmp), str(SRC), "-lz"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (rc={out.returncode}):\n"
                           + out.stderr[-2000:])
    os.replace(tmp, LIB)


def _load():
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        _build()
        lib = ctypes.CDLL(str(LIB))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _ERROR = f"{type(e).__name__}: {e}"
        return None
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    lib.dl_decode_png.restype = ctypes.c_int
    lib.dl_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    _load()
    return _ERROR


def decode_png(path: str, max_w: int = 4096,
               max_h: int = 4096) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty((max_h * max_w,), np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    ok = lib.dl_decode_png(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_w, max_h, ctypes.byref(w), ctypes.byref(h))
    if not ok:
        return None
    return out[:h.value * w.value].reshape(h.value, w.value).copy()


class NativeLoader:
    """Prefetching frame pipeline over a list of image paths."""

    def __init__(self, paths: List[str], in_size, out_size,
                 remap_x: np.ndarray, remap_y: np.ndarray,
                 gamma_lut: Optional[np.ndarray] = None,
                 vignette: Optional[np.ndarray] = None,
                 n_threads: int = 4, ring: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native dataloader unavailable: {_ERROR}")
        self._lib = lib
        self.out_w, self.out_h = out_size
        self._paths_buf = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(paths))(*self._paths_buf)
        fp = ctypes.POINTER(ctypes.c_float)
        self._rx = np.ascontiguousarray(remap_x, np.float32)
        self._ry = np.ascontiguousarray(remap_y, np.float32)
        self._g = (np.ascontiguousarray(gamma_lut, np.float32)
                   if gamma_lut is not None else None)
        self._v = (np.ascontiguousarray(vignette, np.float32)
                   if vignette is not None else None)
        self._h = lib.dl_create(
            arr, len(paths), in_size[0], in_size[1],
            self.out_w, self.out_h,
            self._rx.ctypes.data_as(fp), self._ry.ctypes.data_as(fp),
            self._g.ctypes.data_as(fp) if self._g is not None else None,
            self._v.ctypes.data_as(fp) if self._v is not None else None,
            n_threads, ring)

    def next(self) -> Optional[np.ndarray]:
        out = np.empty((self.out_h, self.out_w), np.float32)
        ok = self._lib.dl_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out if ok else None

    def close(self):
        if self._h:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
