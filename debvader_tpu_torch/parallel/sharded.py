"""Batch-sharded inference and training over a device mesh.

Port of debvader_tpu/parallel/sharded.py.  The batch is split over the
mesh's 'data' axis, each shard's device runs the whole forward on its
share with its own copy of the weights, and the shards' outputs are
gathered by ``torch.cat`` onto the input's device.  Every shard's work is
queued before anything synchronises: the shard loops hold no ``.item()``,
``.cpu()`` or ``bool(tensor)``.  On a mesh across processes
(parallel/mesh.py) the fan-out returns each rank's own rows and their
indices, as a global array's addressable shards are a process's own.

The latent noise of a sampled forward is drawn once for the whole batch,
from the caller's generator, and then split: a mesh run and a
single-device run with the same generator give the same numbers.

Training (``make_sharded_train_step``) is the single-device step of
training/train.py computed over the shards, on one process or on every
rank of a mesh across processes, each rank with the same global batch
and its own replica of the state (the model, Adam's moments, the noise
generator) on its first device of the mesh.  Train-mode BatchNorm takes
statistics over the global batch (each shard's sums of x and x^2 reduced
before the variance is formed, the fast biased E[x^2] - E[x]^2 of
models/layers.BatchNorm); each shard takes the gradient of its own share
of the loss, the mean over the unpadded global batch; and the shards'
sums and gradients are added in global shard order
(parallel/collectives.psum) before every rank applies the same Adam
update.  A pad row weighs 0 in the loss, the gradient, the metrics and
the BatchNorm statistics, so a step at any batch size is the
single-device step.  (The JAX package's pad rows enter its BatchNorm
statistics.)  With ``model_parallel > 1`` the two tensor-parallel dense
kernels (``mesh.param_shardings``) compute their output columns on the
entries of the shard's model row, column share by column share, on one
process or across the ranks of the row.
"""

from __future__ import annotations

from typing import Callable

import torch

from debvader_tpu_torch.device import fp32_math
from debvader_tpu_torch.models.distributions import PixelNormal
from debvader_tpu_torch.ops.normalize import denormalize_distribution, normalize_non_linear
from debvader_tpu_torch.parallel import collectives
from debvader_tpu_torch.parallel import mesh as mesh_lib
from debvader_tpu_torch.utils.flux_cal import apply_flux_calibration

__all__ = [
    "shard_batch",
    "sharded_forward",
    "make_sharded_apply",
    "gather",
    "pad_rows",
    "create_sharded_train_state",
    "shard_train_state",
    "make_sharded_train_step",
    "make_sharded_eval_step",
]


def shard_batch(batch, mesh) -> list:
    """The batch split over 'data', one piece on each data shard's device."""
    return mesh_lib.batch_sharding(batch, mesh)


def gather(pieces, device) -> torch.Tensor:
    """All-gather of per-shard pieces onto ``device``: a ``torch.cat``
    of copies, non-blocking onto a card.  A copy into host memory blocks:
    a non-blocking one from a card lands in pinned memory that the
    ``torch.cat`` could read before the copy has filled it."""
    device = torch.device(device)
    return torch.cat([p.to(device, non_blocking=device.type != "cpu") for p in pieces])


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` with zero rows appended to a multiple of ``multiple``."""
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])


def latent_draw(generator, n: int, latent: int, device) -> torch.Tensor:
    """(n, latent) standard-normal noise as the single-device sampled
    forward draws it (``MultivariateNormalTriL.sample``), from
    ``generator`` on its own device (the global generator when None)."""
    dev = device if generator is None else generator.device
    return torch.randn((n, latent), generator=generator, dtype=torch.float32, device=dev)


def _float_forward(z_mode: str) -> Callable:
    """The float model's per-shard forward: the stamp forward under
    ``fp32_math`` and the model's flux calibration."""

    def forward(replica, x, eps):
        with fp32_math():
            dist, _ = replica(x, z_mode=z_mode, eps=eps)
        return apply_flux_calibration(dist, replica)

    return forward


def make_sharded_apply(net, mesh, z_mode: str = "sample", shard_forward: Callable | None = None) -> Callable:
    """Batch-sharded forward: ``apply(x, generator=None, eps=None)`` ->
    PixelNormal on x's device.

    x (N, S, S, B) with N a multiple of the 'data' axis, guarded and
    normalised already (``sharded_forward`` does both).  Under 'sample'
    the latent noise ``eps`` (N, latent) is split with the batch; when it
    is not given it is drawn here, once for the whole batch, from
    ``generator``.  ``net`` (a DeblenderVAE, or anything else
    ``replicate_module`` copies and that has a ``cfg``) is copied once
    here to each data shard's device, and ``shard_forward(replica, x_k,
    eps_k) -> PixelNormal`` runs one shard's share on its copy: by default
    the float model's forward with its flux calibration.

    On a mesh across processes every rank calls ``apply`` with the same
    global batch and gets ``(PixelNormal, index)``: the rows of the shards
    it owns and their indices in the batch, the counterpart of a global
    array's addressable shards (no rank reads another's rows)."""
    if z_mode not in ("sample", "mean"):
        raise ValueError(f"z_mode must be 'sample' or 'mean', got {z_mode!r}")
    shards = mesh.owned_shards
    replicas = mesh_lib.replicate_module(net, mesh, [mesh.shard_device(i) for i in shards])
    latent = net.cfg.latent_dim
    forward = shard_forward or _float_forward(z_mode)

    @torch.no_grad()
    def apply(x: torch.Tensor, generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        n = x.shape[0]
        if z_mode == "sample" and eps is None:
            eps = latent_draw(generator, n, latent, x.device)
        xs = mesh_lib.batch_sharding(x, mesh, shards)
        es = mesh_lib.batch_sharding(eps, mesh, shards) if z_mode == "sample" else [None] * len(xs)
        dists = [forward(replica, xk, ek) for replica, xk, ek in zip(replicas, xs, es)]
        out = PixelNormal(gather([d.loc for d in dists], x.device), gather([d.scale for d in dists], x.device))
        if not mesh.spans_processes:
            return out
        rows = n // mesh.shape[mesh_lib.DATA_AXIS]
        return out, torch.cat([torch.arange(i * rows, (i + 1) * rows, device=x.device) for i in shards])

    apply.z_mode = z_mode
    apply.latent_dim = latent
    apply.mesh = mesh
    return apply


@torch.no_grad()
def sharded_forward(apply_fn, x: torch.Tensor, mesh, normalise: bool = False, generator=None, eps=None):
    """One mesh-sharded deblend forward with the pre/post pipeline of the
    single-device ``api.deblend_tensor``: finite guard -> optional
    normalise -> pad the batch to a multiple of 'data' -> the sharded
    ``apply_fn`` (``make_sharded_apply``) -> optional delta-method
    denormalise -> un-pad.  Under 'sample' the noise of the N real rows is
    drawn before the padding (pad rows take zeros), so it is the
    single-device draw.  Returns the PixelNormal over x's N rows on x's
    device; on a mesh across processes ``(PixelNormal, index)`` of this
    rank's real rows (``make_sharded_apply``)."""
    n = x.shape[0]
    x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))
    if normalise:
        x = normalize_non_linear(x)
    d = mesh.shape[mesh_lib.DATA_AXIS]
    if apply_fn.z_mode == "sample":
        if eps is None:
            eps = latent_draw(generator, n, apply_fn.latent_dim, x.device)
        eps = pad_rows(eps.to(x.device), d)
    dist = apply_fn(pad_rows(x, d), eps=eps)
    index = None
    if mesh.spans_processes:
        dist, index = dist
    if normalise:
        dist = denormalize_distribution(dist)
    if index is None:
        return PixelNormal(dist.loc[:n], dist.scale[:n])
    real = index < n
    return PixelNormal(dist.loc[real], dist.scale[real]), index[real]


# ----------------------------------------------------------------- training


class _ColumnParallel(torch.autograd.Function):
    """x @ kernel over one model row: the column share of entry j is
    multiplied on its device by its rank, the shares are exchanged within
    the row (collectives.gather_entries: copies on one process, an
    all-gather over the row's ranks across processes) and concatenated.
    The backward takes each entry's share of the output gradient: its
    kernel columns' gradient and its share of x's gradient, exchanged the
    same way; x's gradient is the sum of the shares in column order, the
    kernel's their concatenation.  Every rank of the row ends with the
    same tensors, on one process or several."""

    @staticmethod
    def forward(ctx, x, kernel, mesh, row):
        ctx.save_for_backward(x, kernel)
        ctx.mesh, ctx.row = mesh, row
        own = {j: x.to(dev, non_blocking=True) @ k.to(dev, non_blocking=True)
               for j, (k, dev) in _own_columns(kernel, mesh, row)}
        return torch.cat(_row_exchange(own, mesh, row, x.device), dim=-1)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        mesh, row = ctx.mesh, ctx.row
        gs = torch.tensor_split(g, mesh.shape[mesh_lib.MODEL_AXIS], dim=-1)
        own = {}
        for j, (k, dev) in _own_columns(kernel, mesh, row):
            gj, xj = gs[j].to(dev, non_blocking=True), x.to(dev, non_blocking=True)
            own[j] = collectives.flatten([gj @ k.to(dev, non_blocking=True).T, xj.T @ gj])
        shares = [collectives.unflatten(f, [x, gj.new_empty((x.shape[1], gj.shape[1]))])
                  for f, gj in zip(_row_exchange(own, mesh, row, x.device), gs)]
        gx = shares[0][0]
        for share in shares[1:]:
            gx = gx + share[0]
        return gx, torch.cat([share[1] for share in shares], dim=1), None, None


def _own_columns(kernel, mesh, row: int):
    """(j, (kernel column share j, its device)) for the entries of ``row``
    on this rank."""
    ks = torch.tensor_split(kernel, mesh.shape[mesh_lib.MODEL_AXIS], dim=1)
    return [(j, (ks[j], mesh.devices[row, j])) for j in range(len(ks)) if mesh.ranks[row, j] == mesh.rank]


def _row_exchange(own: dict, mesh, row: int, device) -> list:
    """Every entry's tensor of ``row`` in column order, on ``device``."""
    owners = [int(r) for r in mesh.ranks[row]]
    across = len(set(owners)) > 1
    return collectives.gather_entries(own, owners, device, next(iter(own.values())), across,
                                      mesh.row_group(row) if across else None)


class _ColumnParallelDense(torch.nn.Module):
    """A tensor-parallel dense layer of one data shard's model row
    (float32 only; the row's column shares must be equal across
    processes)."""

    def __init__(self, dense, mesh, row: int):
        super().__init__()
        if dense.scheme is not None or dense.dtype != torch.float32:
            raise ValueError("tensor-parallel training takes float32 dense layers without a precision scheme")
        if len(set(mesh.ranks[row].tolist())) > 1 and dense.kernel.shape[1] % mesh.shape[mesh_lib.MODEL_AXIS]:
            raise ValueError(f"a model row across processes splits a kernel of {dense.kernel.shape[1]} columns into "
                             f"{mesh.shape[mesh_lib.MODEL_AXIS]} equal shares")
        self.kernel, self.bias, self.mesh, self.row = dense.kernel, dense.bias, mesh, row

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ColumnParallel.apply(x.to(self.kernel.dtype), self.kernel, self.mesh, self.row) + self.bias


def _shard_modules(module, mesh) -> dict:
    """{shard: structure} of the data shards this rank computes, for
    ``torch.func.functional_call``: a copy of ``module`` on this rank's
    device of the shard, its tensor-parallel dense layers computed over
    the shard's model row when the mesh has one.  The copies' own tensors
    are never read: each step hands them the state's."""
    import copy

    specs = mesh_lib.param_shardings(module, mesh)
    tp = sorted(name.rsplit(".", 1)[0] for name, spec in specs.items() if spec == (None, mesh_lib.MODEL_AXIS))
    if mesh.shape[mesh_lib.MODEL_AXIS] > 1:
        mesh.row_group(0)  # every row's process group, made on every rank in one order
    out = {}
    for i in mesh.local_shards:
        rep = copy.deepcopy(module).to(mesh.shard_device(i))
        if mesh.shape[mesh_lib.MODEL_AXIS] > 1:
            for name in tp:
                parent, _, leaf = name.rpartition(".")
                owner = rep.get_submodule(parent)
                setattr(owner, leaf, _ColumnParallelDense(getattr(owner, leaf), mesh, i))
        out[i] = rep
    return out


def shard_train_state(state, mesh):
    """The state placed for ``make_sharded_train_step``: its model, moments
    and generator on this rank's first device of the mesh (``mesh.device``;
    on every rank of a mesh across processes a replica, which the steps
    keep equal to the others; the shards' devices get the parameters each
    step).  A state already there is returned as it is."""
    dev = mesh.device
    if state.device == dev:
        return state
    gen = torch.Generator(device=dev)
    if state.generator.device.type == dev.type:
        gen.set_state(state.generator.get_state())
    else:
        gen.manual_seed(int(torch.randint(2**62, (1,), generator=state.generator, device=state.generator.device)))
    state.module.to(dev)
    state.mu = {k: v.to(dev) for k, v in state.mu.items()}
    state.nu = {k: v.to(dev) for k, v in state.nu.items()}
    state.generator = gen
    return state


def create_sharded_train_state(model, mesh, train_cfg=None, generator=None, freeze_decoder=False, freeze=None,
                               variables=None):
    """``training.train.create_train_state`` on this rank's first device of
    the mesh."""
    from debvader_tpu_torch.training.train import create_train_state

    return create_train_state(model, train_cfg, generator=generator, freeze_decoder=freeze_decoder, freeze=freeze,
                              variables=variables, device=mesh.device)


def _padded_shards(mesh, n: int, dev, *tensors):
    """Each tensor moved to ``dev``, padded with zero rows to a multiple of
    the 'data' axis and split over it (this rank's shards); plus the
    real-row mask's shards."""
    d = mesh.shape[mesh_lib.DATA_AXIS]
    real = pad_rows(torch.ones((n,), dtype=torch.float32, device=dev), d)
    return [shard_batch(pad_rows(t.to(dev, non_blocking=True), d), mesh) for t in tensors] + [shard_batch(real, mesh)]


def _per_sample_terms(dist, posterior, y, z, kl_mode: str) -> tuple:
    """(nll, kl, mse) of each sample, as losses.elbo_terms reduces them."""
    from debvader_tpu_torch.training import losses

    axes = tuple(range(1, y.ndim))
    return (-torch.mean(dist.log_prob(y), dim=axes), losses._kl_per_sample(posterior, z, kl_mode),
            torch.mean(torch.square(dist.mean() - y), dim=axes))


def _global_bn_stats(module, mesh, xs: list, reals: list, dev):
    """Train-mode BatchNorm statistics of the encoder's input over the
    global batch's real rows: each shard's sums of x and x^2 (in float32,
    as the layer computes them) and its count, reduced in global shard
    order (collectives.psum), then the mean and the biased E[x^2] - E[x]^2
    clipped at 0.  They are statistics of the input: no gradient flows
    through them."""
    dtype = module.encoder.dtype
    sums = {}
    for i, xk, rk in zip(mesh.local_shards, xs, reals):
        xb = xk.to(dtype).to(torch.float32)
        wk = rk[:, None, None, None]
        sums[i] = [torch.sum(xb * wk, dim=(0, 1, 2)), torch.sum(torch.square(xb) * wk, dim=(0, 1, 2)),
                   torch.sum(rk) * (xk.shape[1] * xk.shape[2])]
    s1, s2, count = collectives.psum(sums, mesh, dev)
    mean = s1 / count
    return mean, torch.clamp(s2 / count - torch.square(mean), min=0.0)


def _shard_setup(step_name: str, state, mesh, structures: dict) -> tuple:
    """The structures of this rank's shards for ``state``'s module (made
    at the first step), after checking that the state lies on
    ``mesh.device``."""
    module, dev = state.module, state.device
    if dev != mesh.device:
        raise ValueError(f"the state lies on {dev}, this rank's first device of the mesh is {mesh.device}: "
                         f"shard_train_state before the {step_name}")
    if id(module) not in structures:
        structures.clear()
        structures[id(module)] = _shard_modules(module, mesh)
    return structures[id(module)]


def make_sharded_train_step(mesh, train_cfg=None, weighted: bool = False):
    """The (state, x, y) -> (state, terms) step of ``make_train_step``,
    data-parallel over ``mesh`` (``(state, x, y, w)`` with ``weighted``),
    on one process or on every rank of a mesh across processes, each rank
    called with the same global batch.

    The batch (any size: it is padded to the 'data' axis with rows of
    weight 0) is split over the shards; the latent noise is drawn for the
    whole batch from the state's generator, the single-device step's draw,
    and each shard takes its rows; BatchNorm's batch statistics are the
    global batch's.  Each shard computes its weighted sums of the terms
    and, by ``torch.autograd.grad``, the gradient of its share of the loss
    (its sums over the global weight sum); the sums and gradients are
    reduced in global shard order (collectives.psum), and every rank
    applies the same Adam update to its own state.  So a mesh across
    processes gives the bits of a single process's mesh of the same shape,
    on every rank, and both give the single-device step to the order of
    float sums.  The state must lie on ``mesh.device``
    (``shard_train_state``)."""
    from debvader_tpu_torch.config import TrainConfig
    from debvader_tpu_torch.training import train as _train

    train_cfg = train_cfg or TrainConfig()
    structures = {}

    def train_step(state, x, y, w=None):
        if weighted == (w is None):
            raise TypeError("a weighted step takes (state, x, y, w), an unweighted one (state, x, y)")
        reps = _shard_setup("train step", state, mesh, structures)
        module, dev = state.module, state.device
        n = x.shape[0]
        params = dict(module.named_parameters())
        buffers = {k: b for k, b in module.named_buffers() if b is not None}
        trainable = state.trainable()
        kl_weight = _train._kl_weight_at(state.step, train_cfg)
        with fp32_math():
            eps = _train._latent_noise(state.generator, (n, module.cfg.latent_dim), torch.empty(0, device=dev))
            wts = torch.ones((n,), dtype=torch.float32, device=dev) if w is None else w.to(dev, torch.float32)
            wsum = torch.sum(wts)
            xs, ys, es, ws, reals = _padded_shards(mesh, n, dev, x, y, eps, wts)
            mean, var = _global_bn_stats(module, mesh, xs, reals, dev)
            computed = {}
            for i, xk, yk, ek, wk in zip(mesh.local_shards, xs, ys, es, ws):
                dk = mesh.shard_device(i)
                tensors = {k: p.to(dk, non_blocking=True) for k, p in params.items()}
                tensors.update({k: b.to(dk, non_blocking=True) for k, b in buffers.items()})
                tensors["encoder.bn.mean"], tensors["encoder.bn.var"] = mean.to(dk), var.to(dk)
                dist, posterior = torch.func.functional_call(reps[i], tensors, (xk,), {"z_mode": "sample", "eps": ek})
                z = posterior.sample(eps=ek)
                sums = [torch.sum(wk * t) for t in _per_sample_terms(dist, posterior, yk, z, train_cfg.kl_mode)]
                share = sums[0] / wsum.to(dk) + kl_weight * (sums[1] / wsum.to(dk))
                grads = torch.autograd.grad(share, [tensors[k] for k in trainable])
                computed[i] = [s.detach() for s in sums] + list(grads)
            total = collectives.psum(computed, mesh, dev)
            rec, kl, mse = (v / wsum for v in total[:3])
            loss = rec + kl_weight * kl
            _train._adam_update(list(trainable.values()), total[3:], [state.mu[k] for k in trainable],
                                [state.nu[k] for k in trainable], state.step + 1, train_cfg.learning_rate)
            bn = module.encoder.bn
            with torch.no_grad():
                bn.mean.copy_(bn.momentum * bn.mean + (1 - bn.momentum) * mean)
                bn.var.copy_(bn.momentum * bn.var + (1 - bn.momentum) * var)
        state.step += 1
        return state, {"nll": rec, "kl": kl, "loss": loss, "mse": mse}

    return train_step


def make_sharded_eval_step(mesh, train_cfg=None):
    """The (state, x, y, generator[, w]) -> terms validation step of
    ``make_eval_step`` over ``mesh``, on one process or on every rank of a
    mesh across processes: BatchNorm in inference mode, the latent noise
    drawn once from ``generator`` and split, each shard's forward on its
    device, each shard's weighted sums of the terms reduced in global
    shard order and divided by the weight sum of the unpadded global batch
    (pad rows and zero weights drop out)."""
    from debvader_tpu_torch.config import TrainConfig
    from debvader_tpu_torch.training import train as _train

    train_cfg = train_cfg or TrainConfig()
    structures = {}

    @torch.no_grad()
    def eval_step(state, x, y, generator, w=None):
        reps = _shard_setup("eval step", state, mesh, structures)
        module, dev = state.module, state.device
        n = x.shape[0]
        tensors = dict(module.named_parameters())
        tensors.update({k: b for k, b in module.named_buffers() if b is not None})
        with fp32_math():
            eps = _train._latent_noise(generator, (n, module.cfg.latent_dim), torch.empty(0, device=dev))
            wts = torch.ones((n,), dtype=torch.float32, device=dev) if w is None else w.to(dev, torch.float32)
            xs, ys, es, ws, _ = _padded_shards(mesh, n, dev, x, y, eps, wts)
            computed = {}
            for i, xk, yk, ek, wk in zip(mesh.local_shards, xs, ys, es, ws):
                dk = mesh.shard_device(i)
                local = {k: t.to(dk, non_blocking=True) for k, t in tensors.items()}
                dist, posterior = torch.func.functional_call(reps[i], local, (xk,), {"z_mode": "sample", "eps": ek})
                z = posterior.sample(eps=ek)
                computed[i] = [torch.sum(wk * t) for t in _per_sample_terms(dist, posterior, yk, z, train_cfg.kl_mode)]
            wsum = torch.sum(wts)
            rec, kl, mse = (v / wsum for v in collectives.psum(computed, mesh, dev))
        return {"nll": rec, "kl": kl, "loss": rec + train_cfg.kl_weight * kl, "mse": mse}

    return eval_step
