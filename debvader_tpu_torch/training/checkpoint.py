"""Checkpoints: best-validation saving, weight loading and resumable train
states, after debvader_tpu/training/checkpoint.py.

The JAX package stores orbax trees; the port stores npz files:

- weights (``save_weights`` / ``load_weights_from``): the flat flax
  key-path dict of weights.py, the format of the packaged weights, so a
  trained checkpoint loads wherever ``sim_demo.npz`` does;
- train states (``save_train_state`` / ``restore_train_state``): the
  module's state dict, Adam's moments, the step and the noise generator's
  state under the port's own names, so a resumed run is bit-exact.

The reference keeps two best-validation checkpoints a stage, by val_mse
and by val_loss, under ``<weights_dir>/<survey>/<vae|deblender>/<monitor>/``
(here ``ckpt.npz`` in each); ``load_weights`` takes the newest.  Every file
is written to a temporary name and renamed, so a reader never sees half a
checkpoint.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from debvader_tpu_torch.weights import default_weights_dir, load_deblender, load_flax_npz, weights_file

__all__ = [
    "default_weights_dir",
    "BestValCheckpoint",
    "define_callbacks",
    "save_weights",
    "load_weights_from",
    "save_train_state",
    "restore_train_state",
    "load_weights",
    "load_deblender",
]


def _savez(path: str | os.PathLike, arrays: dict) -> Path:
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def save_weights(path: str | os.PathLike, variables: dict) -> Path:
    """Write ``variables`` (a flat flax key-path dict,
    ``TrainState.variables()``) to ``path`` (".npz" appended if missing);
    returns the file's path."""
    return _savez(path, {k: np.asarray(v, np.float32) for k, v in variables.items()})


def load_weights_from(path: str | os.PathLike) -> dict[str, np.ndarray]:
    return load_flax_npz(path)


class BestValCheckpoint:
    """Keras ModelCheckpoint(save_best_only=True, mode='min', every epoch):
    writes the state's weights to ``<directory>/ckpt.npz`` when the
    monitored metric improves."""

    def __init__(self, directory: str | os.PathLike, monitor: str, verbose: int = 1):
        self.directory = Path(directory)
        self.monitor = monitor
        self.best = np.inf
        self.verbose = verbose

    def on_epoch_end(self, epoch: int, logs: dict, state) -> None:
        current = logs.get(self.monitor)
        if current is None or not current < self.best:
            return
        if self.verbose:
            print(f"epoch {epoch + 1}: {self.monitor} improved {self.best:.5f} -> {current:.5f}, "
                  f"saving to {self.directory}")
        self.best = current
        save_weights(self.directory / "ckpt.npz", state.variables())


def define_callbacks(vae_or_deblender: str, survey_name: str, weights_dir=None) -> list[BestValCheckpoint]:
    """The reference's two best-validation callbacks of a stage."""
    base = Path(weights_dir or default_weights_dir()) / str(survey_name) / str(vae_or_deblender)
    return [
        BestValCheckpoint(base / "val_mse", monitor="val_mse"),
        BestValCheckpoint(base / "val_loss", monitor="val_loss"),
    ]


def save_train_state(path: str | os.PathLike, state) -> Path:
    """Everything a run needs to resume bit-exact: the module's parameters
    and BatchNorm statistics, Adam's moments, the step and the latent
    noise generator's state."""
    arrays = {f"module/{k}": v.detach().cpu().numpy() for k, v in state.module.state_dict().items()}
    arrays.update({f"mu/{k}": v.cpu().numpy() for k, v in state.mu.items()})
    arrays.update({f"nu/{k}": v.cpu().numpy() for k, v in state.nu.items()})
    arrays["step"] = np.asarray(state.step, np.int64)
    arrays["generator"] = state.generator.get_state().numpy()
    return _savez(path, arrays)


def restore_train_state(path: str | os.PathLike, state):
    """Load a saved train state into ``state`` (same architecture and
    freeze, any device), in place; returns it."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    mu_keys = {k[3:] for k in arrays if k.startswith("mu/")}
    if mu_keys != set(state.mu):
        raise ValueError("the checkpoint's trainable parameters are not the state's (another freeze?)")
    dev = state.device
    state.module.load_state_dict({k[7:]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("module/")})
    for k in state.mu:
        state.mu[k].copy_(torch.from_numpy(arrays[f"mu/{k}"]).to(dev))
        state.nu[k].copy_(torch.from_numpy(arrays[f"nu/{k}"]).to(dev))
    state.step = int(arrays["step"])
    state.generator.set_state(torch.from_numpy(arrays["generator"]))
    return state


def load_weights(survey: str, weights_dir=None) -> dict[str, np.ndarray]:
    """The newest weights of ``survey`` (weights.weights_file) as a flat flax
    key-path dict."""
    return load_flax_npz(weights_file(survey, weights_dir))
