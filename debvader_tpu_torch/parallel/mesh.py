"""Device meshes and placement rules, driven by one process.

Port of debvader_tpu/parallel/mesh.py.  The JAX package hands a
``jax.sharding.Mesh`` to XLA, which places shards and inserts the
collectives.  Here one process drives every shard itself: a :class:`Mesh`
is a (data, model) grid of ``torch.device``s under the axis names
``DATA_AXIS`` and ``MODEL_AXIS``, the placement helpers split a tensor's
leading axis over ``data`` or copy it to every shard, and the collectives
are explicit copies, issued without a host sync:

- ``ppermute`` is a ``.to(device, non_blocking=True)`` of a strip;
- ``psum`` is a sum in shard order on the first device of the axis;
- an all-gather is a ``torch.cat``.

A mesh may repeat one device: ``make_mesh(4, devices=["cpu"] * 4)`` is the
port's counterpart of JAX's virtual CPU devices (its shards run in turn on
that device), and so is ``["cuda:0"] * 4`` on one card.  On several cards
(``cuda:0`` .. ``cuda:n-1``) the shards' work overlaps, since a shard loop
queues every shard's kernels before anything synchronises.

Axes: ``data`` splits the batch (stamps, detection tiles, the row bands of
the sharded serve); ``model`` column-shards the two large dense kernels
(the encoder head and the decoder's expansion, 2^20 elements or more) for
training.  Serving runs each data shard's forward on the first device of
its model row with the whole model.

A mesh that spans processes (devices of other ranks) is not ported yet:
``make_mesh`` raises for it, naming its ROADMAP.md item.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from debvader_tpu_torch.config import _not_ported

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
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The TP rule's size threshold: a 2-D dense kernel of this many elements or
# more is column-sharded over 'model' (JAX _dense_kernel_spec).
_TP_MIN_ELEMENTS = 1 << 20

CROSS_PROCESS_TITLE = "cross-process mesh"


class Mesh:
    """A (data, model) grid of ``torch.device``s.

    ``devices``: an array-like of shape (data, model) (a flat sequence is
    one model column).  ``shape`` maps each axis name to its size, as a
    ``jax.sharding.Mesh`` does."""

    def __init__(self, devices):
        rows = [list(r) if isinstance(r, (list, tuple, np.ndarray)) else [r] for r in devices]
        if not rows or any(len(r) != len(rows[0]) for r in rows) or not rows[0]:
            raise ValueError("a mesh needs a non-empty (data, model) grid of devices")
        grid = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, r in enumerate(rows):
            for j, d in enumerate(r):
                grid[i, j] = torch.device(d)
        self.devices = grid
        self.axis_names = (DATA_AXIS, MODEL_AXIS)

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
    def data_devices(self) -> list:
        """The device of each data shard: the first of its model row."""
        return list(self.devices[:, 0])

    @property
    def distinct(self) -> list:
        """The mesh's devices without repeats, in first-seen order."""
        out = []
        for d in self.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat]})"


def _available() -> list:
    """This process's devices: every card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _local(dev) -> torch.device:
    """One mesh entry as a device of this process.  A (rank, device) pair
    names a device of another rank when its rank is not this process's."""
    if isinstance(dev, tuple):
        rank, dev = dev
        from debvader_tpu_torch.parallel.distributed import process_index

        if int(rank) != process_index():
            _not_ported(f"a mesh device of rank {rank}", CROSS_PROCESS_TITLE)
    d = torch.device(dev)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} requested but no CUDA device is available")
        index = 0 if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {d} requested but this process has {torch.cuda.device_count()} card(s)")
        return torch.device("cuda", index)
    if d.type != "cpu":
        raise ValueError(f"mesh devices must be 'cuda' or 'cpu', got {dev!r}")
    return d


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, devices=None) -> Mesh:
    """Build a ('data', 'model') mesh.

    ``devices``: the devices to use, in order (repeats allowed: a repeated
    device runs its shards in turn); by default every card of this
    process, or the CPU without one.  ``n_devices`` takes the first that
    many; asking for more than there are is an error, never a truncation
    and never a fall-back to other devices (a card machine with one card
    does not build a CPU mesh for ``make_mesh(4)``).  The device count must
    be a multiple of ``model_parallel``."""
    if devices is None:
        from debvader_tpu_torch.parallel.distributed import is_multi_host

        devices = _available()
        if n_devices is not None and len(devices) < n_devices and is_multi_host():
            _not_ported(f"make_mesh({n_devices}) over the devices of several processes", CROSS_PROCESS_TITLE)
    devices = [_local(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested n_devices={n_devices} but only {len(devices)} available "
                f"({', '.join(sorted({str(d) for d in devices}))}); pass devices= to repeat a device"
            )
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return Mesh([devices[i : i + model_parallel] for i in range(0, n, model_parallel)])


def batch_sharding(x, mesh: Mesh) -> list:
    """Split the leading axis of ``x`` over 'data': one piece a data shard,
    on that shard's device (copies issued without a host sync).  The
    leading axis must be a multiple of the data axis."""
    x = torch.as_tensor(x)
    d = mesh.shape[DATA_AXIS]
    if x.shape[0] % d:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split over {d} data shards")
    return [p.to(dev, non_blocking=True) for p, dev in zip(torch.tensor_split(x, d), mesh.data_devices)]


def replicated(x, mesh: Mesh) -> list:
    """``x`` on every data shard's device (one copy a distinct device; a
    shard on x's own device reads x itself)."""
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
    the mesh: one {name: tensor} a device, row by row over the grid; a
    tensor-parallel kernel holds its model column's share of the output
    columns on each device, everything else is copied whole."""
    specs = param_shardings(model, mesh)
    m = mesh.shape[MODEL_AXIS]
    out = []
    for i in range(mesh.shape[DATA_AXIS]):
        for j in range(m):
            dev = mesh.devices[i, j]
            state = {}
            for name, t in model.state_dict().items():
                if specs.get(name) == (None, MODEL_AXIS):
                    t = torch.chunk(t, m, dim=1)[j]
                state[name] = t.to(dev, non_blocking=True)
            out.append(state)
    return out
