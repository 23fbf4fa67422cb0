"""The benchmark's two ways into the program: the configuration's model
for ``debvader_tpu_torch.config.ModelConfig``, and the deblender on the
configuration's weights file.  The drivers import the program's entry
points inside their functions, so that importing the benchmark loads
nothing of the program."""

from __future__ import annotations

from portbench.harness import REPO


def model_config(config: dict):
    """The configuration file's ``model`` keys as the program's ModelConfig."""
    from debvader_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()})


def load_net(config: dict, device):
    """The program's deblender on the configuration's weights file, in
    eval mode on ``device``."""
    from debvader_tpu_torch.weights import load_deblender

    weights = REPO / config["weights"]
    return load_deblender(weights.stem, device=device, weights_dir=weights.parent, cfg=model_config(config))
