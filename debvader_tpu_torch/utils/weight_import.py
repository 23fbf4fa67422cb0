"""Keras checkpoint -> the port's weights: the port's copy of
debvader_tpu/utils/weight_import.py.

The reference's DC2 checkpoint stores the Keras object graph as
``layer_with_weights-{0,1}/layer_with_weights-N/{kernel,bias,alpha,gamma,
...}`` (0 the encoder, 1 the decoder).  The tensors' layouts are the flax
tree's (the JAX package keeps TF's layouts on purpose), so the map to
that tree is a relabelling:

- Dense kernel (in, out)                   -> Dense kernel
- Conv2D kernel (kh, kw, in, out)          -> Conv kernel
- Conv2DTranspose kernel (kh, kw, out, in) -> ConvTranspose2DTF kernel
- PReLU alpha (per element)                -> PReLU alpha
- BatchNorm gamma / beta                   -> scale / bias (params);
  moving_mean / moving_variance            -> batch_stats mean / var

and ``weights.state_dict_from_flax`` lays the tree out for the port's
modules.  ``import_reference_checkpoint`` reads a checkpoint from disk and
returns the port's state dict; the CLI's ``import-weights`` writes it as a
weights file (training/checkpoint.save_weights) that ``load_deblender``
serves.
"""

from __future__ import annotations

import numpy as np

from debvader_tpu_torch.config import ModelConfig

__all__ = [
    "keras_name_map",
    "import_from_tensors",
    "export_to_tensors",
    "import_reference_checkpoint",
]

_V = "/.ATTRIBUTES/VARIABLE_VALUE"


def keras_name_map(cfg: ModelConfig | None = None) -> dict[str, tuple]:
    """{tf_checkpoint_key: ("params"|"batch_stats", module_path...)}, the
    module paths those of the flax variable tree, e.g. ("params",
    "encoder", "Conv_0", "kernel")."""
    cfg = cfg or ModelConfig()
    n_blocks = len(cfg.filters)
    m: dict[str, tuple] = {}

    def enc(i: int, leaf: str) -> str:
        return f"layer_with_weights-0/layer_with_weights-{i}/{leaf}{_V}"

    def dec(i: int, leaf: str) -> str:
        return f"layer_with_weights-1/layer_with_weights-{i}/{leaf}{_V}"

    # encoder: BN, then per block [Conv, PReLU, Conv, PReLU], then the
    # flatten PReLU and the Dense
    m[enc(0, "gamma")] = ("params", "encoder", "BatchNorm_0", "scale")
    m[enc(0, "beta")] = ("params", "encoder", "BatchNorm_0", "bias")
    m[enc(0, "moving_mean")] = ("batch_stats", "encoder", "BatchNorm_0", "mean")
    m[enc(0, "moving_variance")] = ("batch_stats", "encoder", "BatchNorm_0", "var")
    idx = 1
    for b in range(n_blocks):
        for s in range(2):  # stride-1 conv then stride-2 conv
            conv = f"Conv_{2 * b + s}"
            prelu = f"PReLU_{2 * b + s}"
            m[enc(idx, "kernel")] = ("params", "encoder", conv, "kernel")
            m[enc(idx, "bias")] = ("params", "encoder", conv, "bias")
            idx += 1
            m[enc(idx, "alpha")] = ("params", "encoder", prelu, "alpha")
            idx += 1
    m[enc(idx, "alpha")] = ("params", "encoder", f"PReLU_{2 * n_blocks}", "alpha")
    idx += 1
    m[enc(idx, "kernel")] = ("params", "encoder", "Dense_0", "kernel")
    m[enc(idx, "bias")] = ("params", "encoder", "Dense_0", "bias")

    # decoder: PReLU, Dense, PReLU, Dense, PReLU, per block [ConvT s2,
    # PReLU, ConvT s1, PReLU], the band head Conv
    m[dec(0, "alpha")] = ("params", "decoder", "PReLU_0", "alpha")
    m[dec(1, "kernel")] = ("params", "decoder", "Dense_0", "kernel")
    m[dec(1, "bias")] = ("params", "decoder", "Dense_0", "bias")
    m[dec(2, "alpha")] = ("params", "decoder", "PReLU_1", "alpha")
    m[dec(3, "kernel")] = ("params", "decoder", "Dense_1", "kernel")
    m[dec(3, "bias")] = ("params", "decoder", "Dense_1", "bias")
    m[dec(4, "alpha")] = ("params", "decoder", "PReLU_2", "alpha")
    idx = 5
    for b in range(n_blocks):
        for s in range(2):
            convt = f"ConvTranspose2DTF_{2 * b + s}"
            prelu = f"PReLU_{3 + 2 * b + s}"
            m[dec(idx, "kernel")] = ("params", "decoder", convt, "kernel")
            m[dec(idx, "bias")] = ("params", "decoder", convt, "bias")
            idx += 1
            m[dec(idx, "alpha")] = ("params", "decoder", prelu, "alpha")
            idx += 1
    m[dec(idx, "kernel")] = ("params", "decoder", "Conv_0", "kernel")
    m[dec(idx, "bias")] = ("params", "decoder", "Conv_0", "bias")
    return m


def _set_path(tree: dict, path: tuple, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def import_from_tensors(tensors: dict[str, np.ndarray], cfg: ModelConfig | None = None, strict: bool = True) -> dict:
    """The {params, batch_stats} variable tree (numpy leaves) from
    TF-named tensors; ``strict=True`` raises KeyError when one is
    missing."""
    name_map = keras_name_map(cfg)
    out: dict = {"params": {}, "batch_stats": {}}
    missing = []
    for tf_key, path in name_map.items():
        if tf_key not in tensors:
            missing.append(tf_key)
            continue
        _set_path(out[path[0]], path[1:], np.asarray(tensors[tf_key]))
    if missing and strict:
        raise KeyError(f"{len(missing)} checkpoint tensors missing, e.g. {missing[:3]}")
    return out


def export_to_tensors(variables: dict, cfg: ModelConfig | None = None) -> dict:
    """The inverse map: a variable tree, nested or as its flat key-path dict
    (``weights.flatten_flax``, a weights file's arrays), to TF-named
    tensors."""
    from debvader_tpu_torch.weights import flatten_flax

    flat = flatten_flax(variables)
    return {tf_key: flat["/".join(path)] for tf_key, path in keras_name_map(cfg).items()}


def import_reference_checkpoint(ckpt_prefix: str, cfg: ModelConfig | None = None, strict: bool = True) -> dict:
    """The port's state dict (float32 CPU tensors) of a reference TF
    checkpoint on disk; ``strict=False`` takes the tensors whose shard is
    there and leaves the others out."""
    from debvader_tpu_torch.utils.tf_checkpoint import load_available_tensors
    from debvader_tpu_torch.weights import flatten_flax, state_dict_from_flax

    tree = import_from_tensors(load_available_tensors(ckpt_prefix), cfg, strict=strict)
    return state_dict_from_flax(flatten_flax(tree), cfg)
