"""ctypes binding of the native frame loader, `runtime/frame_loader.cc`
(counterpart of `dqo_map_tpu/data/native_loader.py`): a C++ worker pool
that decodes 16-bit grey depth PNGs ahead of the SLAM loop.

The library is built from `runtime/frame_loader.cc` at first use, with
`g++` and `runtime/Makefile`'s flags (`-O3 -fPIC -std=c++17 -pthread
-shared ... -lz`), into `dqo_map_tpu_torch/_build/` under a name keyed by
the source's and the flags' hash; `runtime/` is only read and `make` is
never called. A failed build or load raises: there is no fallback to
another decoder. A file that fails to decode keeps the JAX contract:
`decode_depth_png` returns None and `NativeDepthLoader.get` raises
`IOError`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils.native import build_shared

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG.parent / "runtime" / "frame_loader.cc"
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]
LIBS = ["-lz"]

_LIB = None


def build_library() -> Path:
    """Compile `runtime/frame_loader.cc` into `_build/` unless a library of
    the same source and flags is already there; returns its path."""
    return build_shared(SOURCE, BUILD_DIR, "libframe_loader", CXX_FLAGS,
                        LIBS, "the native frame loader")


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    i, v, u16p = ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.fl_create.restype = v
    lib.fl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i, i]
    lib.fl_destroy.restype = None
    lib.fl_destroy.argtypes = [v]
    lib.fl_prefetch.restype = None
    lib.fl_prefetch.argtypes = [v, i, i]
    lib.fl_get.restype = i
    lib.fl_get.argtypes = [v, i, u16p, ip, ip]
    lib.decode_depth.restype = i
    lib.decode_depth.argtypes = [ctypes.c_char_p, u16p, i, ip, ip]
    lib.fl_evict_below.restype = None
    lib.fl_evict_below.argtypes = [v, i]
    _LIB = lib
    return lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load_lib() is not None


def _u16(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def decode_depth_png(path: str,
                     max_pixels: int = 4096 * 4096) -> Optional[np.ndarray]:
    """One 8- or 16-bit grey PNG decoded natively, as (H, W) uint16; None
    when the file does not decode or holds more than `max_pixels`."""
    lib = _load_lib()
    buf = np.empty(max_pixels, np.uint16)
    w, h = ctypes.c_int(), ctypes.c_int()
    ok = lib.decode_depth(str(path).encode(), _u16(buf), max_pixels,
                          ctypes.byref(w), ctypes.byref(h))
    if ok != 1:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class NativeDepthLoader:
    """Prefetching depth loader over a list of PNG paths, for one consumer:
    `prefetch(start, count)` queues frames for the worker pool, `get(i)`
    returns frame i (decoding it first if no worker has), and
    `evict_below(i)` drops the decoded frames before i. Every frame must
    hold at most `max_pixels` pixels (the native side copies a decoded
    frame whole into the loader's buffer). `close` (or leaving a `with`
    block) stops the workers."""

    def __init__(self, paths: List[str], workers: int = 4,
                 cache_cap: int = 64, max_pixels: int = 4096 * 4096):
        self._handle = None
        self._lib = _load_lib()
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.fl_create(arr, len(self._paths), workers,
                                           cache_cap)
        self._buf = np.empty(max_pixels, np.uint16)

    def __len__(self) -> int:
        return len(self._paths)

    def _index(self, i: int) -> int:
        if self._handle is None:
            raise ValueError("the loader is closed")
        if not 0 <= i < len(self._paths):
            raise IndexError(f"frame {i} of {len(self._paths)}")
        return i

    def prefetch(self, start: int, count: int):
        self._index(start)
        self._lib.fl_prefetch(self._handle, start, count)

    def get(self, i: int) -> np.ndarray:
        w, h = ctypes.c_int(), ctypes.c_int()
        ok = self._lib.fl_get(self._handle, self._index(i), _u16(self._buf),
                              ctypes.byref(w), ctypes.byref(h))
        if ok != 1:
            raise IOError(f"native decode failed for frame {i}")
        return self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def evict_below(self, i: int):
        if self._handle is None:
            raise ValueError("the loader is closed")
        self._lib.fl_evict_below(self._handle, i)

    def close(self):
        if self._handle:
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
