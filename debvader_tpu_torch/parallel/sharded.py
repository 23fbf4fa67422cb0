"""Batch-sharded inference and training over a device mesh.

Port of debvader_tpu/parallel/sharded.py.  One process drives every shard
(parallel/mesh.py): the batch is split over the mesh's 'data' axis, each
shard's device runs the whole forward on its share with its own copy of
the weights, and the shards' outputs are gathered by ``torch.cat`` onto
the input's device.  Every shard's work is queued before anything
synchronises: the shard loops hold no ``.item()``, ``.cpu()`` or
``bool(tensor)``.

The latent noise of a sampled forward is drawn once for the whole batch,
from the caller's generator, and then split: a mesh run and a
single-device run with the same generator give the same numbers.

Training (``make_sharded_train_step``) is the single-device step of
training/train.py computed over the shards: the state (the model, Adam's
moments, the noise generator) stays on the mesh's first device, the
controller's copy; each step copies the parameters to the shards' devices
inside the autograd graph (so the backward sums every shard's gradient
into the state's), runs train-mode BatchNorm with statistics over the
global batch (the per-shard sums of x and x^2 reduced before the variance
is formed, the fast biased E[x^2] - E[x]^2 of models/layers.BatchNorm),
and takes the loss as the mean over the unpadded global batch: a pad row
weighs 0 in the loss, the gradient, the metrics and the BatchNorm
statistics, so a step at any batch size is the single-device step.  (The
JAX package's pad rows enter its BatchNorm statistics.)  With
``model_parallel > 1`` the two tensor-parallel dense kernels
(``mesh.param_shardings``) compute their output columns on the devices of
the shard's model row, column share by column share, and the outputs are
concatenated.
"""

from __future__ import annotations

from typing import Callable

import torch

from debvader_tpu_torch.device import fp32_math
from debvader_tpu_torch.models.distributions import PixelNormal
from debvader_tpu_torch.ops.normalize import denormalize_distribution, normalize_non_linear
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
    the float model's forward with its flux calibration."""
    if z_mode not in ("sample", "mean"):
        raise ValueError(f"z_mode must be 'sample' or 'mean', got {z_mode!r}")
    replicas = mesh_lib.replicate_module(net, mesh)
    latent = net.cfg.latent_dim
    forward = shard_forward or _float_forward(z_mode)

    @torch.no_grad()
    def apply(x: torch.Tensor, generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        n = x.shape[0]
        if z_mode == "sample" and eps is None:
            eps = latent_draw(generator, n, latent, x.device)
        xs = shard_batch(x, mesh)
        es = shard_batch(eps, mesh) if z_mode == "sample" else [None] * len(xs)
        dists = [forward(replica, xk, ek) for replica, xk, ek in zip(replicas, xs, es)]
        return PixelNormal(gather([d.loc for d in dists], x.device), gather([d.scale for d in dists], x.device))

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
    device."""
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
    if normalise:
        dist = denormalize_distribution(dist)
    return PixelNormal(dist.loc[:n], dist.scale[:n])


# ----------------------------------------------------------------- training


class _ColumnParallelDense(torch.nn.Module):
    """A tensor-parallel dense layer of one data shard: each column share
    of the kernel is multiplied on its model column's device and the
    outputs are concatenated on the shard's device (float32 only)."""

    def __init__(self, dense, devices: list):
        super().__init__()
        if dense.scheme is not None or dense.dtype != torch.float32:
            raise ValueError("tensor-parallel training takes float32 dense layers without a precision scheme")
        self.kernel, self.bias, self.devices = dense.kernel, dense.bias, devices

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.kernel.dtype)
        parts = [(x.to(dev, non_blocking=True) @ k.to(dev, non_blocking=True)).to(x.device, non_blocking=True)
                 for k, dev in zip(torch.tensor_split(self.kernel, len(self.devices), dim=1), self.devices)]
        return torch.cat(parts, dim=-1) + self.bias


def _shard_modules(module, mesh) -> list:
    """One structure a data shard for ``torch.func.functional_call``: a
    copy of ``module`` on the shard's device, its tensor-parallel dense
    layers computed over the shard's model row when the mesh has one.  The
    copies' own tensors are never read: each step hands them the state's."""
    import copy

    specs = mesh_lib.param_shardings(module, mesh)
    tp = sorted(name.rsplit(".", 1)[0] for name, spec in specs.items() if spec == (None, mesh_lib.MODEL_AXIS))
    out = []
    for i, dev in enumerate(mesh.data_devices):
        rep = copy.deepcopy(module).to(dev)
        if mesh.shape[mesh_lib.MODEL_AXIS] > 1:
            for name in tp:
                parent, _, leaf = name.rpartition(".")
                owner = rep.get_submodule(parent)
                setattr(owner, leaf, _ColumnParallelDense(getattr(owner, leaf), list(mesh.devices[i])))
        out.append(rep)
    return out


def shard_train_state(state, mesh):
    """The state placed for ``make_sharded_train_step``: its model, moments
    and generator on the mesh's first device (the controller's copy, which
    the steps update; the shards' devices get the parameters each step).
    A state already there is returned as it is."""
    dev = mesh.flat[0]
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
    """``training.train.create_train_state`` on the mesh's first device."""
    from debvader_tpu_torch.training.train import create_train_state

    return create_train_state(model, train_cfg, generator=generator, freeze_decoder=freeze_decoder, freeze=freeze,
                              variables=variables, device=mesh.flat[0])


def _padded_shards(mesh, n: int, dev, *tensors):
    """Each tensor moved to ``dev``, padded with zero rows to a multiple of
    the 'data' axis and split over it; plus the real-row mask's shards."""
    d = mesh.shape[mesh_lib.DATA_AXIS]
    real = pad_rows(torch.ones((n,), dtype=torch.float32, device=dev), d)
    return [shard_batch(pad_rows(t.to(dev, non_blocking=True), d), mesh) for t in tensors] + [shard_batch(real, mesh)]


def _per_sample_terms(dist, posterior, y, z, kl_mode: str) -> tuple:
    """(nll, kl, mse) of each sample, as losses.elbo_terms reduces them."""
    from debvader_tpu_torch.training import losses

    axes = tuple(range(1, y.ndim))
    return (-torch.mean(dist.log_prob(y), dim=axes), losses._kl_per_sample(posterior, z, kl_mode),
            torch.mean(torch.square(dist.mean() - y), dim=axes))


def _global_bn_stats(module, xs: list, reals: list, dev):
    """Train-mode BatchNorm statistics of the encoder's input over the
    global batch's real rows: the per-shard sums of x and x^2 (in float32,
    as the layer computes them) reduced in shard order on ``dev``, then
    the mean and the biased E[x^2] - E[x]^2 clipped at 0."""
    dtype = module.encoder.dtype
    s1 = s2 = None
    count = None
    for xk, rk in zip(xs, reals):
        xb = xk.to(dtype).to(torch.float32)
        wk = rk[:, None, None, None]
        a = torch.sum(xb * wk, dim=(0, 1, 2)).to(dev, non_blocking=True)
        b = torch.sum(torch.square(xb) * wk, dim=(0, 1, 2)).to(dev, non_blocking=True)
        c = (torch.sum(rk) * (xk.shape[1] * xk.shape[2])).to(dev, non_blocking=True)
        s1, s2, count = (a, b, c) if s1 is None else (s1 + a, s2 + b, count + c)
    mean = s1 / count
    return mean, torch.clamp(s2 / count - torch.square(mean), min=0.0)


def make_sharded_train_step(mesh, train_cfg=None, weighted: bool = False):
    """The (state, x, y) -> (state, terms) step of ``make_train_step``,
    data-parallel over ``mesh`` (``(state, x, y, w)`` with ``weighted``):
    the global batch (any size: it is padded to the 'data' axis with rows
    of weight 0) is split over the shards, the latent noise is the
    single-device step's draw from the state's generator, BatchNorm's batch
    statistics are the global batch's, and the loss, gradient and Adam
    update are the single-device step's up to the order of float sums.
    The state must lie on the mesh's first device (``shard_train_state``)."""
    from debvader_tpu_torch.config import TrainConfig
    from debvader_tpu_torch.training import train as _train

    train_cfg = train_cfg or TrainConfig()
    structures = {}

    def train_step(state, x, y, w=None):
        if weighted == (w is None):
            raise TypeError("a weighted step takes (state, x, y, w), an unweighted one (state, x, y)")
        module, dev = state.module, state.device
        if dev != mesh.flat[0]:
            raise ValueError(f"the state lies on {dev}, the mesh's first device is {mesh.flat[0]}: shard_train_state")
        if id(module) not in structures:
            structures.clear()
            structures[id(module)] = _shard_modules(module, mesh)
        reps = structures[id(module)]
        n = x.shape[0]
        params = dict(module.named_parameters())
        buffers = {k: b for k, b in module.named_buffers() if b is not None}
        trainable = state.trainable()
        with fp32_math():
            eps = _train._latent_noise(state.generator, (n, module.cfg.latent_dim), torch.empty(0, device=dev))
            wts = torch.ones((n,), dtype=torch.float32, device=dev) if w is None else w.to(dev, torch.float32)
            xs, ys, es, ws, reals = _padded_shards(mesh, n, dev, x, y, eps, wts)
            mean, var = _global_bn_stats(module, xs, reals, dev)
            sums = None
            for rep, xk, yk, ek, wk, dk in zip(reps, xs, ys, es, ws, mesh.data_devices):
                tensors = {k: p.to(dk, non_blocking=True) for k, p in params.items()}
                tensors.update({k: b.to(dk, non_blocking=True) for k, b in buffers.items()})
                tensors["encoder.bn.mean"], tensors["encoder.bn.var"] = mean.to(dk), var.to(dk)
                dist, posterior = torch.func.functional_call(rep, tensors, (xk,), {"z_mode": "sample", "eps": ek})
                z = posterior.sample(eps=ek)
                terms = [torch.sum(wk * t).to(dev, non_blocking=True)
                         for t in _per_sample_terms(dist, posterior, yk, z, train_cfg.kl_mode)]
                sums = terms if sums is None else [a + b for a, b in zip(sums, terms)]
            wsum = torch.sum(wts)
            rec, kl, mse = (v / wsum for v in sums)
            loss = rec + _train._kl_weight_at(state.step, train_cfg) * kl
            grads = torch.autograd.grad(loss, list(trainable.values()))
            _train._adam_update(list(trainable.values()), list(grads), [state.mu[k] for k in trainable],
                         [state.nu[k] for k in trainable], state.step + 1, train_cfg.learning_rate)
            bn = module.encoder.bn
            with torch.no_grad():
                bn.mean.copy_(bn.momentum * bn.mean + (1 - bn.momentum) * mean)
                bn.var.copy_(bn.momentum * bn.var + (1 - bn.momentum) * var)
        state.step += 1
        return state, {"nll": rec.detach(), "kl": kl.detach(), "loss": loss.detach(), "mse": mse.detach()}

    return train_step


def make_sharded_eval_step(mesh, train_cfg=None):
    """The (state, x, y, generator[, w]) -> terms validation step of
    ``make_eval_step`` over ``mesh``: BatchNorm in inference mode, the
    latent noise drawn once from ``generator`` and split, each shard's
    forward on its device, the terms the weighted mean over the unpadded
    global batch (pad rows and zero weights drop out)."""
    from debvader_tpu_torch.config import TrainConfig
    from debvader_tpu_torch.training import train as _train

    train_cfg = train_cfg or TrainConfig()
    structures = {}

    @torch.no_grad()
    def eval_step(state, x, y, generator, w=None):
        module, dev = state.module, state.device
        if id(module) not in structures:
            structures.clear()
            structures[id(module)] = _shard_modules(module, mesh)
        n = x.shape[0]
        tensors = dict(module.named_parameters())
        tensors.update({k: b for k, b in module.named_buffers() if b is not None})
        with fp32_math():
            eps = _train._latent_noise(generator, (n, module.cfg.latent_dim), torch.empty(0, device=dev))
            wts = torch.ones((n,), dtype=torch.float32, device=dev) if w is None else w.to(dev, torch.float32)
            xs, ys, es, ws, _ = _padded_shards(mesh, n, dev, x, y, eps, wts)
            sums = None
            for rep, xk, yk, ek, wk, dk in zip(structures[id(module)], xs, ys, es, ws, mesh.data_devices):
                local = {k: t.to(dk, non_blocking=True) for k, t in tensors.items()}
                dist, posterior = torch.func.functional_call(rep, local, (xk,), {"z_mode": "sample", "eps": ek})
                z = posterior.sample(eps=ek)
                terms = [torch.sum(wk * t).to(dev, non_blocking=True)
                         for t in _per_sample_terms(dist, posterior, yk, z, train_cfg.kl_mode)]
                sums = terms if sums is None else [a + b for a, b in zip(sums, terms)]
            wsum = torch.sum(wts)
            rec, kl, mse = (v / wsum for v in sums)
        return {"nll": rec, "kl": kl, "loss": rec + train_cfg.kl_weight * kl, "mse": mse}

    return eval_step
