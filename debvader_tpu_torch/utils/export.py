"""Ahead-of-time export of the deblender forward through ``torch.export``.

The JAX package exports its jitted forward as StableHLO (``jax.export``);
the port exports the same forward as an ``ExportedProgram`` saved to a
``.pt2`` byte string (``torch.export.save``): the weights and any flux
calibration are baked in, and the graph holds ATen operations only (the
forward calls no hand-written kernel), so loading it needs ``torch`` and
nothing of this package.

The exported program takes ``(images (N, S, S, B) float32, eps (N, latent)
float32)`` and returns ``(loc, scale)``.  ``eps`` is the standard-normal
draw of the sampled latent, ``z = loc + L @ eps``, where the JAX package
passes threefry key data that torch cannot replay; a ``z_mode='mean'``
artifact takes it and ignores it, so both modes have one signature.  The
batch dimension is symbolic unless ``batch_size`` is given.

If ``torch.export`` cannot trace the forward, the export raises; it does
not fall back to another forward.
"""

from __future__ import annotations

import io
from pathlib import Path

import torch

from debvader_tpu_torch.device import fp32_math, resolve_device

__all__ = [
    "export_deblender",
    "load_exported",
    "artifact_forward",
    "roundtrip_check",
]


class _Forward(torch.nn.Module):
    """(images, eps) -> (loc, scale) of a DeblenderVAE, calibration
    included: what the artifact computes."""

    def __init__(self, model, z_mode: str):
        super().__init__()
        if z_mode not in ("sample", "mean"):
            raise ValueError(f"unknown z_mode {z_mode!r}")
        self.model = model
        self.z_mode = z_mode

    def forward(self, images: torch.Tensor, eps: torch.Tensor):
        from debvader_tpu_torch.utils.flux_cal import apply_flux_calibration

        posterior = self.model.encode(images)
        z = posterior.sample(eps=eps) if self.z_mode == "sample" else posterior.mean()
        # the fidelity mode's correction must travel with the artifact: an
        # exported 'high' forward without it would serve the biased fluxes
        dist = apply_flux_calibration(self.model.decode(z), self.model)
        return dist.loc, dist.scale


def _read(blob) -> bytes:
    return bytes(blob) if isinstance(blob, (bytes, bytearray)) else Path(blob).read_bytes()


def export_deblender(model, batch_size: int | None = None, z_mode: str = "sample", path=None) -> bytes:
    """The forward of ``model`` (a DeblenderVAE in eval mode, on its
    device) as ``.pt2`` bytes, also written to ``path`` if given.

    ``batch_size=None`` exports a symbolic batch dimension: one artifact
    serves any batch.  An int pins it."""
    cfg = model.cfg
    dev = model.encoder.bn.scale.device
    n = 2 if batch_size is None else int(batch_size)
    images = torch.zeros((n, cfg.stamp_size, cfg.stamp_size, cfg.nb_of_bands), dtype=torch.float32, device=dev)
    eps = torch.zeros((n, cfg.latent_dim), dtype=torch.float32, device=dev)
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch")
        dynamic = {"images": {0: batch}, "eps": {0: batch}}
    fwd = _Forward(model, z_mode).eval()
    with torch.no_grad():
        program = torch.export.export(fwd, (images, eps), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def load_exported(blob):
    """The callable ``(images, eps) -> (loc, scale)`` of an artifact
    (bytes or a path).  Needs ``torch`` only."""
    return torch.export.load(io.BytesIO(_read(blob))).module()


def _program_device(program) -> torch.device:
    for t in list(program.state_dict.values()) + list(program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _latent_dim(program) -> int:
    eps = program.graph_signature.user_inputs[1]
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name == eps:
            return int(node.meta["val"].shape[1])
    raise ValueError("the artifact has no eps input")


def artifact_forward(blob, normalise: bool = False, device="cuda"):
    """Serving closure over an artifact: ``fwd(images, generator=None) ->
    (loc, scale)`` on ``device``, with the live route's bracket: non-finite
    pixels enter as 0, ``normalise=True`` applies tanh(arcsinh) before and
    the delta-method denormalisation after.  ``eps`` is drawn as the live
    model's sampled forward draws it (``torch.randn`` of the latent's
    shape from ``generator``), so the same generator state gives the same
    numbers.  The artifact runs with TF32 off (``device.fp32_math``).

    An artifact whose weights lie on another device raises: it is
    exported again there (or moved with
    ``torch.export.passes.move_to_device_pass``) by the caller, never
    copied here behind its back."""
    from debvader_tpu_torch.api import _guard
    from debvader_tpu_torch.models.distributions import PixelNormal
    from debvader_tpu_torch.ops.normalize import denormalize_distribution

    dev = resolve_device(device)
    program = torch.export.load(io.BytesIO(_read(blob)))
    src = _program_device(program)
    if src.type != dev.type:
        raise ValueError(
            f"the artifact was exported on {src.type} and is served on {dev.type}: export it there, or move "
            "it with torch.export.passes.move_to_device_pass"
        )
    call = program.module()
    latent = _latent_dim(program)

    def fwd(images, generator: torch.Generator | None = None):
        x = _guard(torch.as_tensor(images, dtype=torch.float32, device=dev), normalise)
        eps = torch.randn((x.shape[0], latent), generator=generator, dtype=torch.float32, device=dev)
        with torch.no_grad(), fp32_math():
            loc, scale = call(x, eps)
        if normalise:
            dist = denormalize_distribution(PixelNormal(loc, scale))
            return dist.loc, dist.scale
        return loc, scale

    return fwd


def roundtrip_check(model, images, rtol: float = 1e-5) -> bool:
    """Export, reload and compare with the live model's sampled forward
    on ``images`` (the parity check the reference makes against
    onnxruntime)."""
    dev = model.encoder.bn.scale.device
    x = torch.as_tensor(images, dtype=torch.float32, device=dev)
    eps = torch.randn((x.shape[0], model.cfg.latent_dim), generator=torch.Generator(device=dev).manual_seed(42),
                      dtype=torch.float32, device=dev)
    call = load_exported(export_deblender(model, batch_size=x.shape[0]))
    with torch.no_grad(), fp32_math():
        got = call(x, eps)
        want = _Forward(model, "sample")(x, eps)
    return all(torch.allclose(g, w, rtol=rtol, atol=1e-5) for g, w in zip(got, want))
