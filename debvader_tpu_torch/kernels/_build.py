"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into ``debvader_tpu_torch/_build/``,
at first CUDA use, then loaded with ``ctypes``.  The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Every kernel is compiled with ``-fmad=false``: the plain PyTorch versions
round each multiply and each add on its own, and a fused multiply-add
would change the last bit of the matched filter and of the clip
thresholds.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "nvcc_path", "build_all", "load", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


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


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (process, tmp path, final path) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    not cut them to 32 bits."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {status}")
