"""Training-data loaders with ``next_batch()``, after
debvader_tpu/runtime/loader.py.

- ``NativeNpyLoader``: the native prefetching loader over an (inputs.npy,
  labels.npy) pair, ``csrc/dataloader.cpp`` (the JAX package's source,
  copied): mmap'd archives, a seeded per-epoch shuffle, float64 -> float32
  conversion and batch assembly on a background thread.  The library is
  built with ``g++`` into ``debvader_tpu_torch/_build/`` at first use
  (kernels/_build.build_host_library) and loaded with ``ctypes``; a failed
  build raises with the compiler's output.  The JAX package's
  ``make_loader`` falls back to numpy when its library is missing; the
  port does not.
- ``NumpyLoader``: the same contract over arrays already in memory, an
  explicit choice for arrays only.

Both yield full batches (``len`` is rows // batch_size a pass) and
reshuffle when the rows left cannot fill one.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from debvader_tpu_torch.kernels._build import BUILD_DIR, CSRC, build_host_library

__all__ = ["NativeNpyLoader", "NumpyLoader", "make_loader", "build"]

SOURCE = CSRC / "dataloader.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
# the compiler and the build directory; a test points them elsewhere to
# see a failed build raise
CXX = "g++"

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """The library's path, compiled by ``CXX`` into ``BUILD_DIR`` unless it
    is there already; raises RuntimeError when the compiler is missing or
    fails."""
    return build_host_library(SOURCE, "libdvloader", CXX_FLAGS, CXX, Path(BUILD_DIR))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.dvl_open.restype = ctypes.c_void_p
        lib.dvl_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64]
        lib.dvl_last_error.restype = ctypes.c_char_p
        lib.dvl_last_error.argtypes = []
        for fn in ("dvl_rows", "dvl_x_row_elems", "dvl_y_row_elems", "dvl_ndim_x", "dvl_ndim_y"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("dvl_shape_x", "dvl_shape_y"):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.dvl_next.restype = ctypes.c_int
        lib.dvl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        lib.dvl_close.restype = None
        lib.dvl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeNpyLoader:
    """Prefetching batch iterator over (inputs.npy, labels.npy): float32,
    float64 or int32 little-endian C-order archives with equal row counts
    and at least ``batch_size`` rows (anything else raises at open)."""

    def __init__(self, x_path, y_path, batch_size: int, shuffle: bool = True, seed: int = 0):
        self._handle = None
        lib = _load()
        self._lib = lib
        self._handle = lib.dvl_open(str(x_path).encode(), str(y_path).encode(), int(batch_size), int(shuffle),
                                    int(seed))
        if not self._handle:
            raise RuntimeError(f"loader open failed: {lib.dvl_last_error().decode()}")
        self.batch_size = int(batch_size)
        self.rows = int(lib.dvl_rows(self._handle))

        def shape(ndim_fn, shape_fn):
            buf = (ctypes.c_int64 * ndim_fn(self._handle))()
            shape_fn(self._handle, buf)
            return tuple(int(s) for s in buf)

        self.x_shape = shape(lib.dvl_ndim_x, lib.dvl_shape_x)
        self.y_shape = shape(lib.dvl_ndim_y, lib.dvl_shape_y)
        self._xe = int(lib.dvl_x_row_elems(self._handle))
        self._ye = int(lib.dvl_y_row_elems(self._handle))

    def __len__(self) -> int:
        return self.rows // self.batch_size

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._handle:
            raise RuntimeError("the loader is closed")
        x = np.empty((self.batch_size, self._xe), np.float32)
        y = np.empty((self.batch_size, self._ye), np.float32)
        n = self._lib.dvl_next(self._handle, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n < 0:
            raise StopIteration
        return x.reshape((self.batch_size,) + self.x_shape[1:]), y.reshape((self.batch_size,) + self.y_shape[1:])

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self) -> None:
        if self._handle:
            self._lib.dvl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


class NumpyLoader:
    """The loader contract over in-memory arrays: batches in a shuffled
    order (``np.random.default_rng(seed)``, reshuffled each pass)."""

    def __init__(self, x, y, batch_size: int, shuffle: bool = True, seed: int = 0):
        if isinstance(x, (str, Path)) or isinstance(y, (str, Path)):
            raise TypeError("NumpyLoader takes arrays; .npy paths go to NativeNpyLoader")
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(len(self.x))
        self._cursor = len(self.x)  # shuffle at the first call
        self.x_shape = self.x.shape

    def __len__(self) -> int:
        return len(self.x) // self.batch_size

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        if self._cursor + self.batch_size > len(self.x):
            if self.shuffle:
                self._rng.shuffle(self._order)
            self._cursor = 0
        idx = self._order[self._cursor : self._cursor + self.batch_size]
        self._cursor += self.batch_size
        return self.x[idx].astype(np.float32), self.y[idx].astype(np.float32)

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self) -> None:
        pass


def make_loader(x, y, batch_size: int, shuffle: bool = True, seed: int = 0):
    """``NativeNpyLoader`` for .npy paths (its build raises rather than
    falling back), ``NumpyLoader`` for arrays."""
    if isinstance(x, (str, Path)):
        return NativeNpyLoader(x, y, batch_size, shuffle, seed)
    return NumpyLoader(x, y, batch_size, shuffle, seed)
