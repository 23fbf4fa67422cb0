"""Device meshes and placement rules, on one process or several.

Port of debvader_tpu/parallel/mesh.py.  The JAX package hands a
``jax.sharding.Mesh`` to XLA, which places shards and inserts the
collectives.  Here each process drives its own shards itself: a
:class:`Mesh` is a (data, model) grid of entries under the axis names
``DATA_AXIS`` and ``MODEL_AXIS``, each entry a ``torch.device`` of one
rank of the job, and the placement helpers split a tensor's leading axis
over ``data`` or copy it to every shard of this rank.  The collectives
(parallel/collectives.py) are copies between this process's devices,
issued without a host sync, and ``torch.distributed`` between processes:

- ``ppermute`` is a ``.to(device, non_blocking=True)`` of a strip;
- ``psum`` is a sum in global shard order, the same on every rank;
- an all-gather is a ``torch.cat`` of every shard's piece.

A mesh may repeat one device: ``make_mesh(4, devices=["cpu"] * 4)`` is the
port's counterpart of JAX's virtual CPU devices (its shards run in turn on
that device), and so is ``["cuda:0"] * 4`` on one card.  On several cards
(``cuda:0`` .. ``cuda:n-1``) the shards' work overlaps, since a shard loop
queues every shard's kernels before anything synchronises.

A mesh across processes lists (rank, device) entries, repeats allowed:
``[(0, "cpu"), (0, "cpu"), (1, "cpu"), (1, "cpu")]`` is two processes with
two shards each, the counterpart of two virtual devices a process.  After
``initialize_distributed``, ``make_mesh()`` spans every rank's devices in
rank order (distributed.global_devices), as JAX's does.  Each rank computes
the data shards of the rows that hold one of its entries
(``Mesh.local_shards``); a shard's row belongs to the rank of its first
entry (``Mesh.owner``).  Training runs on such a mesh; a serving route,
which reads its results on the host, refuses one
(:func:`require_single_process`), as the JAX package's fails to fetch an
array that spans devices of other processes.

Axes: ``data`` splits the batch (stamps, detection tiles, the row bands of
the sharded serve); ``model`` column-shards the two large dense kernels
(the encoder head and the decoder's expansion, 2^20 elements or more) for
training.  Serving runs each data shard's forward on the first device of
its model row with the whole model.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from debvader_tpu_torch.parallel import distributed

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "replicate_module",
    "param_shardings",
    "shard_variables",
    "require_single_process",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The TP rule's size threshold: a 2-D dense kernel of this many elements or
# more is column-sharded over 'model' (JAX _dense_kernel_spec).
_TP_MIN_ELEMENTS = 1 << 20


class Mesh:
    """A (data, model) grid of devices, each of one rank.

    ``devices``: an array-like of shape (data, model) (a flat sequence is
    one model column) of devices or (rank, device) pairs; a bare device is
    this process's.  ``shape`` maps each axis name to its size, as a
    ``jax.sharding.Mesh`` does."""

    def __init__(self, devices):
        rows = [list(r) if isinstance(r, (list, np.ndarray)) else [r] for r in devices]
        if not rows or any(len(r) != len(rows[0]) for r in rows) or not rows[0]:
            raise ValueError("a mesh needs a non-empty (data, model) grid of devices")
        self.rank = distributed.process_index()
        grid = np.empty((len(rows), len(rows[0])), dtype=object)
        ranks = np.empty(grid.shape, dtype=np.int64)
        for i, r in enumerate(rows):
            for j, d in enumerate(r):
                rank, dev = d if isinstance(d, tuple) else (self.rank, d)
                grid[i, j], ranks[i, j] = torch.device(dev), int(rank)
        self.devices = grid
        self.ranks = ranks
        self.axis_names = (DATA_AXIS, MODEL_AXIS)
        self._groups = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list:
        """Every device, row by row (the band axis of the sharded serve)."""
        return list(self.devices.reshape(-1))

    @property
    def spans_processes(self) -> bool:
        """Whether an entry belongs to another rank than this process's."""
        return bool((self.ranks != self.rank).any())

    def owner(self, i: int) -> int:
        """The rank of data shard ``i``: that of its row's first entry."""
        return int(self.ranks[i, 0])

    @property
    def local_shards(self) -> list:
        """The data shards this rank computes: the rows that hold one of
        its entries (all of them on a single process)."""
        return [i for i in range(self.devices.shape[0]) if (self.ranks[i] == self.rank).any()]

    @property
    def owned_shards(self) -> list:
        """The data shards this rank owns (``owner``)."""
        return [i for i in range(self.devices.shape[0]) if self.owner(i) == self.rank]

    def shard_device(self, i: int) -> torch.device:
        """This rank's device of data shard ``i``: its first entry in the
        shard's row."""
        return self.devices[i, int(np.argmax(self.ranks[i] == self.rank))]

    @property
    def data_devices(self) -> list:
        """This rank's device of each of its data shards (``local_shards``):
        on a single process the first device of each model row."""
        return [self.shard_device(i) for i in self.local_shards]

    @property
    def device(self) -> torch.device:
        """This rank's first device, row by row: where a train state lies."""
        return self.devices[self.ranks == self.rank][0]

    @property
    def distinct(self) -> list:
        """The mesh's devices without repeats, in first-seen order."""
        out = []
        for d in self.flat:
            if d not in out:
                out.append(d)
        return out

    def row_group(self, i: int):
        """The process group of the ranks in row ``i`` (None for the whole
        job).  The groups of every row are made at the first call, on
        every rank in the same order, as ``torch.distributed.new_group``
        needs."""
        if self._groups is None:
            import torch.distributed as dist

            world = distributed.process_count()
            self._groups = {}
            for row in self.ranks:
                key = tuple(sorted(set(int(r) for r in row)))
                if len(key) > 1 and key not in self._groups:
                    self._groups[key] = None if len(key) == world else dist.new_group(list(key))
        return self._groups.get(tuple(sorted(set(int(r) for r in self.ranks[i]))))

    def __repr__(self) -> str:
        if self.spans_processes:
            return f"Mesh({self.shape}, devices={[(int(r), str(d)) for r, d in zip(self.ranks.flat, self.flat)]})"
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat]})"


def _available() -> list:
    """This process's devices: every card, else the CPU."""
    return distributed._local_devices()


def _entry(dev) -> tuple:
    """One mesh entry as (rank, device).  A device of this process is
    checked against its cards; one of another rank needs a process group
    that holds that rank."""
    me = distributed.process_index()
    rank, dev = dev if isinstance(dev, tuple) else (me, dev)
    rank, d = int(rank), torch.device(dev)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh devices must be 'cuda' or 'cpu', got {dev!r}")
    if rank != me:
        if not 0 <= rank < distributed.process_count():
            raise ValueError(
                f"a mesh entry of rank {rank} needs a process group that holds that rank "
                f"(this job has {distributed.process_count()} process(es)): call initialize_distributed first"
            )
        return rank, torch.device(d.type, 0 if d.type == "cuda" and d.index is None else d.index)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} requested but no CUDA device is available")
        index = 0 if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {d} requested but this process has {torch.cuda.device_count()} card(s)")
        return rank, torch.device("cuda", index)
    return rank, d


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, devices=None) -> Mesh:
    """Build a ('data', 'model') mesh.

    ``devices``: the devices to use, in order (repeats allowed: a repeated
    device runs its shards in turn), each a device of this process or a
    (rank, device) pair; by default every card of every rank of the job
    (distributed.global_devices), or on a single process every card of
    this one, or the CPU without one.  ``n_devices`` takes the first that
    many; asking for more than there are is an error, never a truncation
    and never a fall-back to other devices (a card machine with one card
    does not build a CPU mesh for ``make_mesh(4)``).  The device count must
    be a multiple of ``model_parallel``.  A mesh across processes holds an
    entry of every rank."""
    if devices is None:
        devices = distributed.global_devices() if distributed.is_multi_host() else _available()
    entries = [_entry(d) for d in devices]
    if n_devices is not None:
        if len(entries) < n_devices:
            raise ValueError(
                f"requested n_devices={n_devices} but only {len(entries)} available "
                f"({', '.join(sorted({str(d) for _, d in entries}))}); pass devices= to repeat a device"
            )
        entries = entries[:n_devices]
    n = len(entries)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    ranks = {r for r, _ in entries}
    if ranks != {distributed.process_index()} and ranks != set(range(distributed.process_count())):
        raise ValueError(f"a mesh across processes holds an entry of every rank; it has ranks {sorted(ranks)} "
                         f"of {distributed.process_count()}")
    return Mesh([entries[i : i + model_parallel] for i in range(0, n, model_parallel)])


def require_single_process(mesh, route: str) -> None:
    """Raise for a serving route on a mesh across processes: the route
    reads its results on the host, and rows of another process are not
    this one's to read (the JAX package's route fails there too, fetching
    an array that spans devices of other processes)."""
    if mesh is not None and mesh.spans_processes:
        raise ValueError(
            f"{route} reads its results on the host, so it takes a mesh of this process's devices, not {mesh!r} "
            "(the JAX package's route fails there too: an array that spans devices of other processes cannot "
            "be fetched); train on a mesh across processes, serve on one of a single process"
        )


def batch_sharding(x, mesh: Mesh, shards=None) -> list:
    """Split the leading axis of ``x`` over 'data' and take this rank's
    pieces: one a data shard of ``shards`` (default ``mesh.local_shards``,
    every shard on a single process), on this rank's device of that shard
    (copies issued without a host sync).  The leading axis must be a
    multiple of the data axis."""
    x = torch.as_tensor(x)
    d = mesh.shape[DATA_AXIS]
    if x.shape[0] % d:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split over {d} data shards")
    pieces = torch.tensor_split(x, d)
    shards = mesh.local_shards if shards is None else shards
    return [pieces[i].to(mesh.shard_device(i), non_blocking=True) for i in shards]


def replicated(x, mesh: Mesh) -> list:
    """``x`` on this rank's device of each of its data shards (one copy a
    distinct device; a shard on x's own device reads x itself)."""
    x = torch.as_tensor(x)
    copies = {}
    return [copies.setdefault(dev, x.to(dev, non_blocking=True)) for dev in mesh.data_devices]


def replicate_module(module, mesh: Mesh, devices=None) -> list:
    """A copy of ``module`` (anything with ``.to(device)``, a model or a
    quantized bundle) for each of ``devices`` (default: the data shards'),
    one copy a distinct device; on the module's own device the module
    itself.  The copies are frozen snapshots: refresh them after a weight
    update."""
    devices = mesh.data_devices if devices is None else devices
    own = _module_device(module)
    copies = {}
    out = []
    for dev in devices:
        if dev not in copies:
            copies[dev] = module if dev == own else _moved(module, dev)
        out.append(copies[dev])
    return out


def _module_device(module) -> torch.device:
    device = getattr(module, "device", None)
    if isinstance(device, torch.device):
        return device
    return next(iter(module.parameters())).device


def _moved(module, dev: torch.device):
    if isinstance(module, torch.nn.Module):
        return copy.deepcopy(module).to(dev)
    return module.to(dev)


def _dense_kernel_spec(name: str, leaf: torch.Tensor) -> tuple:
    """Column-shard the big dense kernels over 'model'; replicate the rest."""
    if name.split(".")[-1] == "kernel" and leaf.ndim == 2 and leaf.numel() >= _TP_MIN_ELEMENTS:
        return (None, MODEL_AXIS)
    return ()


def param_shardings(params: Any, mesh: Mesh) -> dict:
    """{name: spec} of a model's parameters (a module or a name -> tensor
    mapping): ``(None, 'model')`` for a tensor-parallel dense kernel,
    ``()`` for a replicated one (JAX's PartitionSpecs as tuples)."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return {name: _dense_kernel_spec(name, leaf) for name, leaf in items}


def shard_variables(model: torch.nn.Module, mesh: Mesh) -> list:
    """The model's state (parameters and BatchNorm statistics) placed on
    this rank's entries of the mesh: one {name: tensor} an entry, row by
    row over the grid; a tensor-parallel kernel holds its model column's
    share of the output columns, everything else is copied whole."""
    specs = param_shardings(model, mesh)
    m = mesh.shape[MODEL_AXIS]
    out = []
    for i in range(mesh.shape[DATA_AXIS]):
        for j in range(m):
            if mesh.ranks[i, j] != mesh.rank:
                continue
            dev = mesh.devices[i, j]
            state = {}
            for name, t in model.state_dict().items():
                if specs.get(name) == (None, MODEL_AXIS):
                    t = torch.chunk(t, m, dim=1)[j]
                state[name] = t.to(dev, non_blocking=True)
            out.append(state)
    return out
