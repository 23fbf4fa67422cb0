"""Multiply-accumulates of the VAE forward, counted from the configuration.

The JAX package's ``utils/flops.py``, in plain integer arithmetic: per
stamp, a 3x3 SAME conv at its stage's input size and a 3x3 stride-2 conv
at the ceil-halved size for each encoder stage; the latent Dense pair and
the decoder's wide Dense; each stride-2 transposed conv counted as input
pixels x 9 x cin x cout (every input pixel scatters a full 3x3 tap set),
then a stride-1 transposed conv at the doubled size; the band head on the
grid before the crop.  A bound on the stamp forward's time is
``2 * forward_macs(cfg) * N`` operations over the card's peak rate for the
compute dtype (chip_smoke.py).
"""

from __future__ import annotations

from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.models.distributions import mvn_params_size

__all__ = ["forward_macs", "per_layer_macs"]


def per_layer_macs(cfg: ModelConfig) -> dict[str, int]:
    """Useful multiply-accumulates per stamp, by the layer keys of
    ``ModelConfig.layer_precision``."""
    out: dict[str, int] = {}
    sp = cfg.stamp_size
    cin = cfg.nb_of_bands
    k2 = 9  # 3x3 kernels throughout
    for i, f in enumerate(cfg.filters):
        out[f"enc/Conv_{2 * i}"] = sp * sp * k2 * cin * f
        sp = -(-sp // 2)
        out[f"enc/Conv_{2 * i + 1}"] = sp * sp * k2 * f * f
        cin = f
    head = mvn_params_size(cfg.latent_dim)
    out["enc/Dense_0"] = sp * sp * cin * head
    out["dec/Dense_0"] = cfg.latent_dim * head
    out["dec/Dense_1"] = head * sp * sp * cfg.filters[-1]
    spd, cin2 = sp, cfg.filters[-1]
    for i, f in enumerate(reversed(cfg.filters)):
        out[f"dec/ConvT_{2 * i}"] = spd * spd * k2 * cin2 * f
        spd *= 2
        out[f"dec/ConvT_{2 * i + 1}"] = spd * spd * k2 * f * f
        cin2 = f
    out["dec/Conv_0"] = spd * spd * k2 * cin2 * 2 * cfg.nb_of_bands
    return out


def forward_macs(cfg: ModelConfig) -> int:
    """Total useful multiply-accumulates of one stamp's forward."""
    return sum(per_layer_macs(cfg).values())
