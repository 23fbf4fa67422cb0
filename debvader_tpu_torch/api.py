"""Stamp-level deblending: the batched VAE forward.

``deblend(net, images)`` mirrors debvader_tpu.api.deblend: non-finite
pixels enter the network as 0, ``normalise=True`` brackets the forward with
tanh(arcsinh) in and the delta-method inverse out, and the result is
(mean images as numpy, output distribution on the device).  A model that
carries a flux calibration (utils/flux_cal.py) has it divided out in
network space, before any denormalisation.  Eager PyTorch needs no
batch-size buckets.

``deblend_samples`` and ``deblend_sample_stats`` are the epistemic
sampling of debvader_tpu.api along its single-device path: each source is
encoded once (the encoder is deterministic at inference), then
(replica, source) pairs of latent draws decode in chunks of at most
``max_chunk``.  The draws come from an explicit ``torch.Generator`` on the
device, or from an injected ``eps`` so that a test can hand the JAX
package the same noise.  With ``mesh`` (parallel/mesh.py) the tiled
(replica, source) batch is split over the mesh's 'data' axis through the
whole forward instead, as the JAX package's mesh route does; its noise is
the single-device route's draw, made once for the chunk and split, so
both routes give the same numbers for the same generator.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.device import fp32_math, resolve_device
from debvader_tpu_torch.models.distributions import MultivariateNormalTriL, PixelNormal
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.ops.normalize import (
    denormalize_distribution,
    normalize_non_linear,
)
from debvader_tpu_torch.utils.flux_cal import apply_flux_calibration

__all__ = [
    "deblend",
    "deblend_tensor",
    "deblend_samples",
    "deblend_sample_stats",
    "sample_stats_tensor",
]


def _guard(x: torch.Tensor, normalise: bool) -> torch.Tensor:
    """Non-finite pixels (chip gaps, saturation) enter the network as 0;
    then the optional normalisation."""
    x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))
    return normalize_non_linear(x) if normalise else x


def _stamps_on(images, dev: torch.device) -> torch.Tensor:
    """(N, S, S, B) float32 on ``dev``; one (S, S, B) stamp is a batch of one."""
    x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    return x[None] if x.ndim == 3 else x


@torch.no_grad()
def deblend_tensor(
    net: DeblenderVAE,
    x: torch.Tensor,
    normalise: bool = False,
    generator: torch.Generator | None = None,
    z_mode: str = "sample",
) -> PixelNormal:
    """The forward on a (N, S, S, B) float32 tensor already on the model's
    device; returns the PixelNormal there."""
    x = _guard(x, normalise)
    with fp32_math():
        dist, _ = net(x, generator=generator, z_mode=z_mode)
    dist = apply_flux_calibration(dist, net)
    if normalise:
        dist = denormalize_distribution(dist)
    return dist


def deblend(
    net: DeblenderVAE,
    images,
    normalise: bool = False,
    generator: torch.Generator | None = None,
    z_mode: str = "sample",
    device="cuda",
):
    """Drop-in for the reference deblend(): (mean images, distribution).

    images: (N, S, S, B) or one (S, S, B) stamp; ``net`` must live on
    ``device``.  ``z_mode='sample'`` draws the latent from ``generator``
    (a fresh one seeded 0 when None); ``'mean'`` is deterministic."""
    dev = resolve_device(device)
    x = _stamps_on(images, dev)
    if z_mode == "sample" and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dist = deblend_tensor(net, x, normalise, generator, z_mode)
    return dist.mean().cpu().numpy(), dist



@torch.no_grad()
def _replica_chunks(net, x, n_samples, generator, normalise, max_chunk, eps, mesh=None, apply_fn=None):
    """Yields (reps, N, S, S, B) chunks of sampled means, ``n_samples``
    replicas in all: one encode of x (N, S, S, B), then for each chunk of
    ``reps = max(max_chunk // N, 1)`` replicas the posterior tiled with the
    replica axis outermost, one latent draw a (replica, source) pair, the
    decode, the flux calibration and the denormalisation.  With ``mesh``
    each chunk is x tiled the same way through ``apply_fn``'s sharded
    forward (``make_sharded_apply(net, mesh)`` when None), with the same
    draw."""
    n = x.shape[0]
    latent = net.cfg.latent_dim
    if eps is not None and tuple(eps.shape) != (n_samples, n, latent):
        raise ValueError(f"eps must be {(n_samples, n, latent)}, got {tuple(eps.shape)}")
    reps_per_chunk = max(max_chunk // max(n, 1), 1)
    if mesh is not None:
        from debvader_tpu_torch.parallel.mesh import require_single_process
        from debvader_tpu_torch.parallel.sharded import latent_draw, make_sharded_apply, sharded_forward

        require_single_process(mesh, "the sampling API's mesh=")
        if apply_fn is None:
            apply_fn = make_sharded_apply(net, mesh, z_mode="sample")
        done = 0
        while done < n_samples:
            reps = min(reps_per_chunk, n_samples - done)
            noise = (latent_draw(generator, reps * n, latent, x.device) if eps is None
                     else eps[done : done + reps].reshape(reps * n, latent))
            loc = sharded_forward(apply_fn, x.repeat(reps, 1, 1, 1), mesh, normalise, eps=noise).loc
            yield loc.reshape((reps, n) + tuple(loc.shape[1:]))
            done += reps
        return
    with fp32_math():
        posterior = net.encode(_guard(x, normalise))
    done = 0
    while done < n_samples:
        reps = min(reps_per_chunk, n_samples - done)
        tiled = MultivariateNormalTriL(
            posterior.loc.repeat(reps, 1), posterior.scale_tril.repeat(reps, 1, 1)
        )
        noise = None if eps is None else eps[done : done + reps].reshape(reps * n, latent)
        with fp32_math():
            dist = net.decode(tiled.sample(generator=generator, eps=noise))
        dist = apply_flux_calibration(dist, net)
        if normalise:
            dist = denormalize_distribution(dist)
        yield dist.loc.reshape((reps, n) + tuple(dist.loc.shape[1:]))
        done += reps


def _sampling_inputs(images, generator, eps, device):
    """(stamps on the device, generator, eps on the device) of a sampling
    entry point: a fresh generator seeded 0 when neither it nor ``eps`` is
    given."""
    dev = resolve_device(device)
    if eps is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    return _stamps_on(images, dev), generator, eps


def _welford_merge(mean, m2, count, c_mean, c_m2, c_count):
    """Parallel-variance merge of (mean, M2, count) with a chunk's."""
    total = count + c_count
    delta = c_mean - mean
    new_mean = mean + delta * (c_count / total)
    new_m2 = m2 + c_m2 + torch.square(delta) * (count * c_count / total)
    return new_mean, new_m2


def sample_stats_tensor(
    net: DeblenderVAE,
    x: torch.Tensor,
    n_samples: int,
    generator: torch.Generator | None = None,
    normalise: bool = False,
    max_chunk: int = 8192,
    eps: torch.Tensor | None = None,
    mesh=None,
    apply_fn=None,
):
    """:func:`deblend_sample_stats` on a (N, S, S, B) float32 tensor
    already on the model's device."""
    if n_samples < 1:
        raise ValueError(f"n_samples must be at least 1, got {n_samples}")
    mean = m2 = None
    count = 0
    for samples in _replica_chunks(net, x, n_samples, generator, normalise, max_chunk, eps, mesh, apply_fn):
        reps = samples.shape[0]
        c_mean = samples.mean(dim=0)
        c_m2 = torch.square(samples - c_mean[None]).sum(dim=0)
        if mean is None:
            mean, m2 = c_mean, c_m2
        else:
            mean, m2 = _welford_merge(mean, m2, float(count), c_mean, c_m2, float(reps))
        count += reps
    return mean, torch.sqrt(torch.clamp(m2 / count, min=0.0))


def deblend_samples(
    net: DeblenderVAE,
    images,
    n_samples: int,
    generator: torch.Generator | None = None,
    normalise: bool = False,
    max_chunk: int = 8192,
    eps=None,
    device="cuda",
    mesh=None,
    apply_fn=None,
) -> torch.Tensor:
    """Epistemic sampling: ``n_samples`` stochastic forwards an image, as
    the (n_samples, N, S, S, B) tensor of their means on ``device``.

    The latent draws come from ``generator`` (a fresh one seeded 0 when
    None) or are the given ``eps`` (n_samples, N, latent), replica axis
    first.  ``mesh`` (and optionally a cached ``apply_fn`` from
    ``parallel.make_sharded_apply(net, mesh, 'sample')``) splits each
    chunk's (replica, source) batch over the mesh's 'data' axis, with the
    same draws."""
    x, generator, eps = _sampling_inputs(images, generator, eps, device)
    return torch.cat(list(_replica_chunks(net, x, n_samples, generator, normalise, max_chunk, eps, mesh, apply_fn)))


def deblend_sample_stats(
    net: DeblenderVAE,
    images,
    n_samples: int,
    generator: torch.Generator | None = None,
    normalise: bool = False,
    max_chunk: int = 8192,
    eps=None,
    device="cuda",
    mesh=None,
    apply_fn=None,
):
    """(mean, std) over ``n_samples`` stochastic forwards an image, both
    (N, S, S, B) on ``device``, without the sample cube of
    :func:`deblend_samples`: replica chunks merge into running Welford
    statistics (stable for singleton chunks), so the peak is one replica
    chunk and two stamp maps.  ``std`` is the population standard
    deviation, sqrt(max(M2 / n_samples, 0)).  Same draws as
    :func:`deblend_samples` for the same generator state or ``eps``;
    ``mesh`` / ``apply_fn`` as there."""
    x, generator, eps = _sampling_inputs(images, generator, eps, device)
    return sample_stats_tensor(net, x, n_samples, generator, normalise, max_chunk, eps, mesh, apply_fn)
