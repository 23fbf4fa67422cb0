"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into ``debvader_tpu_torch/_build/``,
at first CUDA use, then loaded with ``ctypes``.  The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Kernels held bit for bit against their plain versions are compiled with
``-fmad=false``: the plain PyTorch versions round each multiply and each
add on its own, and a fused multiply-add would change the last bit of the
matched filter and of the clip thresholds.  A source listed in
``FMAD_SOURCES`` is held to a tolerance instead and builds with
contraction on.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "nvcc_path", "build_all", "load", "launcher", "call", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# sources whose float32 multiply-adds may contract into FMAs
FMAD_SOURCES = frozenset({"decoder_tail"})

_loaded: dict[str, ctypes.CDLL] = {}
_launchers: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc was not found (set CUDA_HOME); the CUDA kernels are built "
            "from debvader_tpu_torch/csrc at first use"
        )
    return found


def _flags(name: str) -> tuple:
    fmad = "true" if name in FMAD_SOURCES else "false"
    return NVCC_FLAGS + (f"-fmad={fmad}",)


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (process, tmp path, final path) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=None) -> dict[str, str]:
    """Build every kernel library (or ``names``) in parallel; returns
    {name: nvcc output} for the sources compiled by this call (ptxas
    register and shared-memory report included)."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start(n) for n in names}
    logs = {}
    for name, job in jobs.items():
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def launcher(name: str, symbol: str, n_ptr: int, n_int: int):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``: ``n_ptr`` pointer
    arguments, ``n_int`` int arguments, then the CUDA stream; returns a
    cudaError_t.  Pointers and the stream go as ``c_void_p`` so ctypes does
    not cut them to 32 bits.  Looked up and typed once a process."""
    key = (name, symbol, n_ptr, n_int)
    fn = _launchers.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launchers[key] = fn
    return fn


def _raw_stream(index: int) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def call(fn, device, *args) -> int:
    """``fn(*args, stream)`` with ``stream`` the current CUDA stream of
    ``device`` and that device current during the call; returns the
    launcher's status.  The device is switched only when it is not current
    already, and the stream's raw handle is read without building a
    ``torch.cuda.Stream``."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _raw_stream(index))


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {status}")
