"""Multi-process runtime initialisation on ``torch.distributed``.

Port of debvader_tpu/parallel/distributed.py.  A job of several processes
initialises the process group once per process before it touches a
device; on a single process this is a no-op, so library code can call it
unconditionally.  ``init_process_group`` runs only when the caller names a
coordinator or the environment does (``MASTER_ADDR``, as ``torchrun`` sets
it); the backend is NCCL with a card, gloo without.

A mesh built afterwards still holds this process's devices only: a mesh
across processes is not ported yet (parallel/mesh.py).
"""

from __future__ import annotations

import os

import torch

__all__ = ["initialize_distributed", "is_multi_host", "process_index"]

_ENV_KEYS = ("MASTER_ADDR", "COORDINATOR_ADDRESS")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialise ``torch.distributed`` when running multi-process.

    ``coordinator_address``: 'host:port' of rank 0 (``tcp://`` is added),
    with ``num_processes`` and ``process_id``; with no arguments the
    environment's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK`` are read.  Returns True if the process group is (now) active,
    False for a single-process run."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if not any(k in os.environ for k in _ENV_KEYS):
            return False  # single process: nothing to do
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    group = {} if num_processes is None else {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend, init_method=init_method, **group)
    return True


def process_index() -> int:
    """This process's rank (0 on a single process)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_multi_host() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
