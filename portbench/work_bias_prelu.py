"""The bytes of the stamp forward's one-pass bias and PReLU
(``csrc/bias_prelu.cu`` of the port), counted from shapes as ``work.py``
counts the other kernels' bytes, so that a later change to the program
cannot change what its share of the roofline counts.

Each launch reads the layer's output once and writes the result once, in
the layer's compute dtype, and reads the float32 alpha (one per element of
a stamp's activation) and the float32 bias (one per channel) once.  The
launches are those of the 16 conv and transposed-conv layers and of the
two biased dense layers (dec/Dense_0, dec/Dense_1) that a PReLU follows.
A bfloat16 model computes dec/Dense_1 in float32 under ``strict_cast`` and
decoder stage i in float32 when i < ``decoder_f32_stages``.
"""

from __future__ import annotations

__all__ = ["bias_prelu_layers", "bias_prelu_bytes"]


def bias_prelu_layers(model: dict) -> list[tuple[int, int, bool]]:
    """(channels, elements a stamp, computed in float32 whatever the
    model's dtype) of each launch, in the forward's order, for a
    configuration's ``model`` keys."""
    filters = model["filters"]
    size = model["stamp_size"]
    layers = []
    for f in filters:
        layers.append((f, f * size * size, False))
        size = -(-size // 2)
        layers.append((f, f * size * size, False))
    latent = model["latent_dim"]
    hidden = latent + latent * (latent + 1) // 2
    top = size * size * filters[-1]
    layers.append((hidden, hidden, False))
    layers.append((top, top, bool(model.get("strict_cast", True))))
    for i in range(len(filters) - 1, -1, -1):
        size *= 2  # the stride-2 transposed conv, then the stride-1 one
        layers += [(filters[i], filters[i] * size * size, i < int(model.get("decoder_f32_stages", 0)))] * 2
    return layers


def bias_prelu_bytes(model: dict, batch: int, itemsize: int) -> int:
    """Bytes the launches of one forward of ``batch`` stamps must move,
    with ``itemsize`` the bytes of an element of the model's compute
    dtype."""
    total = 0
    for channels, elements, wide in bias_prelu_layers(model):
        size = 4 if wide else itemsize
        total += 2 * batch * elements * size + 4 * elements + 4 * channels
    return total
