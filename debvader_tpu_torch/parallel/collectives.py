"""The collectives of a mesh, on one process or across several.

The counterpart of the collectives that XLA inserts into the JAX package's
sharded programs.  Each works on either kind of parallel.Mesh:

- :func:`all_gather`: every data shard's tensor, in global shard order, on
  one device of this rank.  On a single process it is a copy of each
  shard's tensor; across processes each rank sends the shards it owns
  (``Mesh.owner``) through one ``torch.distributed.all_gather``;
- :func:`psum`: the all-gather, then one sum in global shard order,
  ``((s0 + s1) + s2) + ...``, written once for both kinds of mesh, so
  every rank and a single process of the same mesh shape add the same
  numbers in the same order and get the same bits;
- :func:`broadcast`: rank ``src``'s tensor on every rank.

``gather_entries`` is the exchange under both gathers, also used by the
tensor-parallel layers of a model row (parallel/sharded.py).

Both backends take card tensors as they are: NCCL on the card, and gloo
in ``all_gather`` and ``broadcast`` by staging them through host memory
itself (checked on the card by chip_smoke.py's phase 24, its gloo_cuda
record), a copy to the host and back that is the stated cost of gloo on
cards.
"""

from __future__ import annotations

import torch

from debvader_tpu_torch.parallel import distributed
from debvader_tpu_torch.parallel.mesh import DATA_AXIS

__all__ = ["all_gather", "psum", "broadcast", "gather_entries", "flatten", "unflatten"]


def flatten(tensors: list) -> torch.Tensor:
    """One 1-D tensor of ``tensors`` (of one dtype, on one device), in
    order."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat: torch.Tensor, likes: list) -> list:
    """``flatten``'s inverse: views of ``flat`` with the shapes of
    ``likes``."""
    out, at = [], 0
    for t in likes:
        out.append(flat[at : at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def gather_entries(local: dict, owners: list, device, like: torch.Tensor, across: bool, group=None) -> list:
    """Entry i's tensor for every i of ``owners``, in order, on ``device``:
    entry i is given by rank ``owners[i]``, which holds it in ``local``
    ({i: tensor} of the entries this rank owns; every entry of one shape
    and dtype, that of ``like``).  Without ``across`` (every entry this
    rank's) the entries are copied to ``device``; with it every rank of
    ``group`` (None for the whole job) takes part in one all-gather, each
    sending its entries padded to the largest count (a rank that owns
    none sends zeros)."""
    if not across:
        return [local[i].to(device, non_blocking=True) for i in range(len(owners))]
    import torch.distributed as dist

    ranks = list(range(dist.get_world_size())) if group is None else dist.get_process_group_ranks(group)
    width = max(owners.count(r) for r in ranks)
    mine = [i for i, o in enumerate(owners) if o == distributed.process_index()]
    send = torch.zeros((width,) + tuple(like.shape), dtype=like.dtype, device=like.device)
    for k, i in enumerate(mine):
        send[k].copy_(local[i])
    got = [torch.empty_like(send) for _ in ranks]
    dist.all_gather(got, send, group=group)
    seen = dict.fromkeys(ranks, 0)
    out = []
    for o in owners:
        out.append(got[ranks.index(o)][seen[o]].to(device, non_blocking=True))
        seen[o] += 1
    return out


def all_gather(computed: dict, mesh, device) -> list:
    """Every data shard's tensor, in global shard order, on ``device``.
    ``computed``: {shard: tensor} of the shards this rank computed (at
    least those it owns; a shard owned by another rank is taken from that
    rank)."""
    owners = [mesh.owner(i) for i in range(mesh.shape[DATA_AXIS])]
    local = {i: t for i, t in computed.items() if owners[i] == mesh.rank}
    return gather_entries(local, owners, device, next(iter(computed.values())), mesh.spans_processes)


def psum(computed: dict, mesh, device) -> list:
    """The sum over every data shard, in global shard order, of each
    shard's list of tensors: ``computed`` is {shard: [tensor, ...]} of the
    shards this rank computed (the lists of one structure); returns the
    list of sums on ``device``, the same bits on every rank and on a
    single process of the same mesh shape.  Across processes a shard's
    list goes out as one flat tensor, so one all-gather carries them all."""
    likes = next(iter(computed.values()))
    if mesh.spans_processes:
        flat = all_gather({i: flatten(ts) for i, ts in computed.items()}, mesh, device)
        parts = [unflatten(f, likes) for f in flat]
    else:
        parts = [[t.to(device, non_blocking=True) for t in computed[i]] for i in range(mesh.shape[DATA_AXIS])]
    total = parts[0]
    for part in parts[1:]:
        total = [a + b for a, b in zip(total, part)]
    return total


def broadcast(tensor: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place (every rank gives
    a tensor of the same shape and dtype); on a single process the tensor
    itself."""
    if mesh.spans_processes:
        import torch.distributed as dist

        dist.broadcast(tensor, src=src)
    return tensor
