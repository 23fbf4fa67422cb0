"""Device selection and float32 numerics shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["fp32_math", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The default is the GPU; without one this raises instead of falling
    back, so a CPU run is always one the caller asked for (``device="cpu"``).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


@contextlib.contextmanager
def fp32_math():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block,
    the caller's settings restored after it.

    The model and background paths are float32; TF32 keeps about three
    decimal digits (the same class of error as a TPU's default one-pass
    precision).  Scoped, so the port never changes the numerics of the
    caller's other code."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
