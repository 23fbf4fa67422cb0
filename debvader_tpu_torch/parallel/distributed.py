"""Multi-process runtime initialisation on ``torch.distributed``.

Port of debvader_tpu/parallel/distributed.py.  A job of several processes
initialises the process group once per process before it touches a
device; on a single process this is a no-op, so library code can call it
unconditionally.  ``init_process_group`` runs only when the caller names a
coordinator or the environment does (``MASTER_ADDR``, as ``torchrun`` sets
it).  The backend is NCCL with a card and gloo without one, unless the
caller names it: nothing falls back from one to the other (NCCL refuses two
ranks on one card, and the run then fails).  Every collective of the group
fails after ``timeout`` seconds instead of waiting on a dead peer.

After initialisation :func:`global_devices` is every rank's devices in rank
order, as ``jax.devices()`` is after ``jax.distributed.initialize``, and
``parallel.make_mesh()`` spans them (parallel/mesh.py).
"""

from __future__ import annotations

import datetime
import os

import torch

__all__ = [
    "initialize_distributed",
    "is_multi_host",
    "process_index",
    "process_count",
    "barrier",
    "global_devices",
]

_ENV_KEYS = ("MASTER_ADDR", "COORDINATOR_ADDRESS")
# a collective waits this long for its peers unless the caller says otherwise
DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: float | datetime.timedelta | None = None,
) -> bool:
    """Initialise ``torch.distributed`` when running multi-process.

    ``coordinator_address``: 'host:port' of rank 0 (``tcp://`` is added),
    or an init URL (``tcp://...``, ``file://...``), with ``num_processes``
    and ``process_id``; with no arguments the environment's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` are read.
    ``backend``: 'nccl' or 'gloo' (default: 'nccl' with a card, 'gloo'
    without).  ``timeout``: seconds (or a timedelta) a collective waits for
    its peers before it fails.  Returns True if the process group is (now)
    active, False for a single-process run."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if not any(k in os.environ for k in _ENV_KEYS):
            return False  # single process: nothing to do
        init_method = "env://"
    elif coordinator_address is not None and "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if timeout is None:
        timeout = DEFAULT_TIMEOUT_S
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    group = {} if num_processes is None else {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **group)
    return True


def _active() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 on a single process)."""
    import torch.distributed as dist

    return dist.get_rank() if _active() else 0


def process_count() -> int:
    """The number of processes of the job (1 on a single process)."""
    import torch.distributed as dist

    return dist.get_world_size() if _active() else 1


def is_multi_host() -> bool:
    return process_count() > 1


def barrier() -> None:
    """Wait until every rank is here (a no-op on a single process)."""
    import torch.distributed as dist

    if _active():
        dist.barrier()


def _local_devices() -> list:
    """This process's devices: every card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_devices() -> list:
    """Every rank's devices as (rank, device) pairs, rank by rank: the
    counterpart of ``jax.devices()`` after ``jax.distributed.initialize``.
    On a single process, this process's devices under rank 0."""
    import torch.distributed as dist

    mine = [str(d) for d in _local_devices()]
    if not _active():
        return [(0, torch.device(d)) for d in mine]
    tables = [None] * dist.get_world_size()
    dist.all_gather_object(tables, mine)
    return [(rank, torch.device(d)) for rank, devs in enumerate(tables) for d in devs]
