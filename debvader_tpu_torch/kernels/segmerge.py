"""The native multi-threshold merge and Lutz tree: host C++ over ctypes.

Port of debvader_tpu/runtime/segmerge.py.  ``csrc/segmerge.cpp`` (the JAX
package's source, copied) holds two host functions of detection's
postprocess, on the CPU and behind a card alike:

- ``dvm_merge``: the sequential merge of watershed segments, operation for
  operation ``ops/detection._merge_segments_py``, so the roots are
  bit-identical to that plain version;
- ``dvm_lutz``: the multi-threshold component tree of
  ``DetectionConfig.deblend_algo='lutz'``.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17`` into
``debvader_tpu_torch/_build/`` at first use, under a name that carries a
hash of the source and the flags (an edited source is rebuilt), and loaded
with ``ctypes``.  A failed build or load raises with the compiler's
output: there is no fallback to the Python loop, which stays only as the
plain version the tests hold the native core against.  Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from debvader_tpu_torch.kernels._build import BUILD_DIR, CSRC, build_host_library

__all__ = ["CXX_FLAGS", "build", "merge_segments", "lutz_deblend"]

SOURCE = CSRC / "segmerge.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# the compiler and the build directory; a test points them elsewhere to
# see a failed build raise
CXX = "g++"

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """The library's path, compiled by ``CXX`` into ``BUILD_DIR`` unless it
    is there already; raises RuntimeError when the compiler is missing or
    fails, with its output."""
    return build_host_library(SOURCE, "libsegmerge", CXX_FLAGS, CXX, Path(BUILD_DIR))


def _load() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process, with
    the argument types of the JAX package's wrapper."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.dvm_merge.restype = ctypes.c_int64
        lib.dvm_merge.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, f64p,
            f64p, f64p,
            i64p,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            i64p,
        ]
        lib.dvm_lutz.restype = ctypes.c_int64
        lib.dvm_lutz.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            f64p, i64p,
            i64p, i64p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double,
            i64p,
        ]
        _lib = lib
    return _lib


def merge_segments(ea, eb, eh, peak, flux, order, nthr, thr, cont) -> np.ndarray:
    """The root of every segment (int64, len L) after the merge loop:
    segment edges (ea, eb) with saddle heights eh, per-segment peaks and
    fluxes (``flux`` is copied, not consumed), ``order`` the weakest-first
    visiting order."""
    lib = _load()
    L = len(peak)
    ea = np.ascontiguousarray(ea, np.int64)
    eb = np.ascontiguousarray(eb, np.int64)
    eh = np.ascontiguousarray(eh, np.float64)
    peak = np.ascontiguousarray(peak, np.float64)
    flux = np.array(flux, np.float64)  # the core updates it in place
    order = np.ascontiguousarray(order, np.int64)
    roots = np.empty(L, np.int64)
    lib.dvm_merge(L, len(ea), ea, eb, eh, peak, flux, order, int(nthr), float(thr), float(cont), roots)
    return roots


def lutz_deblend(val, flat, ea, eb, f, nthr, thr, cont) -> np.ndarray:
    """Per-pixel object labels (int64: the flat index of each pixel's
    object peak) of the masked-pixel COO ``val`` / ``flat`` with its
    8-neighbour pixel edges (ea, eb), by the multi-threshold tree."""
    lib = _load()
    val = np.ascontiguousarray(val, np.float64)
    flat = np.ascontiguousarray(flat, np.int64)
    ea = np.ascontiguousarray(ea, np.int64)
    eb = np.ascontiguousarray(eb, np.int64)
    labels = np.empty(len(val), np.int64)
    lib.dvm_lutz(len(val), len(ea), val, flat, ea, eb, int(f), int(nthr), float(thr), float(cont), labels)
    return labels
