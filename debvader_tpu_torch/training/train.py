"""Training: ELBO steps, the two-stage transfer trainer and its histories,
after debvader_tpu/training/train.py.

Reference workflow:

  stage 1 "vae":        train everything on (noisy -> isolated) pairs
  stage 2 "deblender":  freeze the decoder, train on (blended -> isolated)

Each stage is a fresh ``TrainState`` (new Adam moments).  What is held to
the JAX package, and how:

- **Adam** is optax 0.2.6's ``adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root
  0) op for op: ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr`` and
  added to the parameter, every bias correction a true division by a
  float32 ``1 - b**count``.  ``torch.optim.Adam`` orders this differently.
  A frozen parameter (``multi_transform(..., set_to_zero)`` in JAX) gets no
  update and holds no moments.
- **BatchNorm** of the encoder's input runs in flax's train mode in a step
  (models/layers.BatchNorm) and updates its running statistics whatever is
  frozen; validation runs it in inference mode.
- **Batches** are the JAX package's: a host shuffle from
  ``np.random.default_rng(train_cfg.seed)`` each epoch, Keras-fit's
  trailing partial batch in training, validation capped at ``int(n / bs)``
  full batches (one partial batch when there is no full one), epoch means
  weighted by batch size.  Given the same noise the port gives JAX's batch
  order and history.
- **Latent noise** comes from the state's ``torch.Generator`` on the
  device (a step) or from a generator seeded by (seed, epoch, batch) (a
  validation batch), always through ``_latent_noise``.  Torch's streams
  cannot be threefry's; the tests replace that one function to replay the
  JAX package's draws.

Each step runs inside ``device.fp32_math()``: TF32 off and cuDNN's
deterministic algorithms on, so two seeded runs on a card are
bit-identical, as the JAX package's are.  ``steps_per_dispatch``,
``device_dataset`` and ``scan_epochs`` keep the JAX package's validation
and results; the port runs their steps one by one (a step is a few
launches of cuDNN and cuBLAS, not an XLA dispatch).  ``mesh=`` runs the
steps data-parallel over a parallel.Mesh (parallel/sharded.py): every
batch, a partial one too, is the single-device step's, split over the
mesh's 'data' axis, with BatchNorm's statistics over the global batch.
On a mesh across processes every rank runs ``train_network`` with the
same data and seed: it reads the same batches in the same shuffled
order, its steps reduce every shard's sums and gradients in global shard
order, and it returns the same state and history as every other rank and
as a single process's mesh of the same shape; rank 0 alone writes the
checkpoints and the metrics log, the others wait for it at a barrier.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from debvader_tpu_torch.config import ModelConfig, TrainConfig
from debvader_tpu_torch.device import fp32_math, resolve_device
from debvader_tpu_torch.models.vae import DeblenderVAE, init_vae
from debvader_tpu_torch.training import losses
from debvader_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax

__all__ = [
    "TrainState",
    "create_train_state",
    "freeze_labels",
    "decoder_freeze_labels",
    "make_loss_fn",
    "make_train_step",
    "make_eval_step",
    "train_network",
    "train_deblender",
]

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step.

    ``module``: the model being trained (the state's own copy, on the
    training device); ``labels``: 'trainable' or 'frozen' for each of its
    parameters; ``mu`` / ``nu``: Adam's moments of the trainable ones;
    ``step``: steps taken (Adam's count and the KL anneal's clock);
    ``generator``: the latent noise's generator, on the device.  A step
    updates all of them in place and returns the same state."""

    module: DeblenderVAE
    labels: dict[str, str]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    step: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.module.encoder.bn.scale.device

    def trainable(self) -> dict[str, torch.nn.Parameter]:
        return {k: p for k, p in self.module.named_parameters() if self.labels[k] == "trainable"}

    def variables(self) -> dict[str, np.ndarray]:
        """Parameters and BatchNorm statistics as the flat flax key-path
        dict of the weights format (weights.flax_from_state_dict)."""
        return flax_from_state_dict(self.module.state_dict(), self.module.cfg)


def freeze_labels(module: torch.nn.Module, frozen_module: str) -> dict[str, str]:
    """'frozen' for every parameter under ``frozen_module`` (a name on its
    path, e.g. 'decoder'), 'trainable' elsewhere."""
    return {
        name: "frozen" if frozen_module in name.split(".") else "trainable"
        for name, _ in module.named_parameters()
    }


def decoder_freeze_labels(module: torch.nn.Module) -> dict[str, str]:
    """'frozen' for every decoder parameter (the reference's stage 2)."""
    return freeze_labels(module, "decoder")


def _seed(*words: int) -> int:
    """A 32-bit seed for a torch.Generator from integers (numpy's
    SeedSequence mixes them, so nearby tuples give unrelated streams)."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1)[0])


def create_train_state(
    model: DeblenderVAE,
    train_cfg: TrainConfig | None = None,
    generator: torch.Generator | None = None,
    freeze_decoder: bool = False,
    freeze: str | None = None,
    variables: dict | None = None,
    device="cuda",
) -> TrainState:
    """A fresh state for ``model``'s architecture, on ``device``.

    ``variables`` (a flat flax key-path dict: ``TrainState.variables()``,
    ``checkpoint.load_weights``, ``transfer.transfer_band_count``) are its
    starting weights; without them the model is initialised as the JAX
    package's ``init_vae`` draws (models/vae.init_vae), seeded by
    ``train_cfg.seed``.  The caller's module is copied, never trained in
    place.  ``freeze``: None, 'decoder' (the reference's stage 2, also
    ``freeze_decoder=True``) or 'encoder' (frozen-encoder latent reuse).
    ``generator``: a latent-noise generator whose stream the state carries
    on (stage 2 continues stage 1's); by default one seeded by
    ``train_cfg.seed``."""
    train_cfg = train_cfg or TrainConfig()
    dev = resolve_device(device)
    module = copy.deepcopy(model)
    if variables is None:
        init_vae(module, _seed(train_cfg.seed, 0))
    else:
        module.load_state_dict(state_dict_from_flax(variables, module.cfg))
    module.to(dev).eval()
    if freeze_decoder and freeze is None:
        freeze = "decoder"
    if freeze is None:
        labels = {name: "trainable" for name, _ in module.named_parameters()}
    else:
        labels = freeze_labels(module, freeze)
    for name, p in module.named_parameters():
        p.requires_grad_(labels[name] == "trainable")
    trainable = {k: p for k, p in module.named_parameters() if labels[k] == "trainable"}
    gen = torch.Generator(device=dev)
    if generator is None:
        gen.manual_seed(_seed(train_cfg.seed, 1))
    else:
        gen.set_state(generator.get_state())
    return TrainState(
        module=module,
        labels=labels,
        mu={k: torch.zeros_like(p) for k, p in trainable.items()},
        nu={k: torch.zeros_like(p) for k, p in trainable.items()},
        step=0,
        generator=gen,
    )


def _adam_update(params: list, grads: list, mu: list, nu: list, count: int, learning_rate: float) -> None:
    """optax 0.2.6 ``adam(learning_rate)`` then ``apply_updates``, in place,
    op for op: mu = (1-b1) g + b1 mu; nu = (1-b2) g*g + b2 nu; the bias
    corrections divide by float32 ``1 - b**count`` (a device tensor, so a
    card divides truly instead of multiplying by a reciprocal); u =
    mu_hat / (sqrt(nu_hat) + eps); p = p + (-lr) u."""
    dev = params[0].device
    one = np.float32(1.0)
    bc1 = torch.full((), one - np.float32(_B1) ** np.float32(count), device=dev)
    bc2 = torch.full((), one - np.float32(_B2) ** np.float32(count), device=dev)
    with torch.no_grad():
        g1 = torch._foreach_mul(grads, 1 - _B1)
        torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - _B2)
        torch._foreach_mul_(nu, _B2)
        torch._foreach_add_(nu, g2)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, _EPS)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, -learning_rate)
        torch._foreach_add_(params, upd)


def _kl_weight_at(step: int, train_cfg: TrainConfig) -> float:
    """The KL weight at ``step``: fixed, or ramped linearly from 0 over
    ``kl_anneal_steps``, rounded to float32 as the JAX package computes it."""
    w = np.float32(train_cfg.kl_weight)
    if train_cfg.kl_anneal_steps > 0:
        w = w * np.minimum(np.float32(step) / np.float32(train_cfg.kl_anneal_steps), np.float32(1.0))
    return float(w)


def _latent_noise(generator: torch.Generator, shape: tuple, like: torch.Tensor) -> torch.Tensor:
    """Standard-normal latent noise: every draw of training and validation
    comes from here."""
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _validation_generator(seed: int, epoch: int, index: int, device) -> torch.Generator:
    """The noise of validation batch ``index`` of ``epoch``: the same for a
    seed whatever ran before (the JAX package folds (epoch, batch) into
    PRNGKey(seed))."""
    return torch.Generator(device=device).manual_seed(_seed(seed, epoch, index))


def make_loss_fn(train_cfg: TrainConfig | None = None) -> Callable:
    """(module, x, y, eps, step[, w]) -> (loss, terms): the train-mode
    forward (BatchNorm on the batch's statistics, running statistics
    updated), z = loc + L eps, and the ELBO terms at the step's KL weight."""
    train_cfg = train_cfg or TrainConfig()

    def loss_fn(module, x, y, eps, step, w=None):
        posterior = module.encode(x, train=True)
        z = posterior.sample(eps=eps)
        dist = module.decode(z)
        terms = losses.elbo_terms(
            dist, posterior, y, z=z, kl_weight=_kl_weight_at(step, train_cfg),
            kl_mode=train_cfg.kl_mode, weights=w,
        )
        return terms["loss"], terms

    return loss_fn


def make_train_step(train_cfg: TrainConfig | None = None, weighted: bool = False) -> Callable:
    """The (state, x, y) -> (state, terms) training step, ``(state, x, y,
    w)`` with ``weighted=True`` (per-sample weights; a zero-weight row adds
    nothing to the loss or the gradient).  x and y are (N, S, S, B) float32
    tensors on the state's device; ``terms`` are 0-d tensors there (nll,
    kl, loss, mse), read without a sync until the caller asks."""
    train_cfg = train_cfg or TrainConfig()
    loss_fn = make_loss_fn(train_cfg)

    def train_step(state: TrainState, x, y, w=None):
        if weighted == (w is None):
            raise TypeError("a weighted step takes (state, x, y, w), an unweighted one (state, x, y)")
        module = state.module
        params = state.trainable()
        with fp32_math():
            eps = _latent_noise(state.generator, (x.shape[0], module.cfg.latent_dim), x)
            loss, terms = loss_fn(module, x, y, eps, state.step, w)
            grads = torch.autograd.grad(loss, list(params.values()))
            _adam_update(
                list(params.values()), list(grads), [state.mu[k] for k in params], [state.nu[k] for k in params],
                state.step + 1, train_cfg.learning_rate,
            )
        state.step += 1
        return state, {k: v.detach() for k, v in terms.items()}

    return train_step


def make_eval_step(train_cfg: TrainConfig | None = None) -> Callable:
    """The (state, x, y, generator) -> terms validation step: BatchNorm in
    inference mode, a latent sampled with ``generator``'s noise, the KL at
    its unannealed weight."""
    train_cfg = train_cfg or TrainConfig()

    def eval_step(state: TrainState, x, y, generator):
        module = state.module
        with torch.no_grad(), fp32_math():
            posterior = module.encode(x)
            z = posterior.sample(eps=_latent_noise(generator, (x.shape[0], module.cfg.latent_dim), x))
            dist = module.decode(z)
            return losses.elbo_terms(
                dist, posterior, y, z=z, kl_weight=train_cfg.kl_weight, kl_mode=train_cfg.kl_mode
            )

    return eval_step


def _batches(n: int, batch_size: int, rng: np.random.Generator | None, drop_remainder: bool = False):
    """Index blocks of ``batch_size``, shuffled by ``rng``; the trailing
    partial block is yielded unless ``drop_remainder``."""
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    for start in range(0, n, batch_size):
        block = idx[start : start + batch_size]
        if drop_remainder and len(block) < batch_size:
            return
        yield block


def _check_scan_epochs(use_loader: bool, n: int | None, batch_size: int, callbacks, mesh=None) -> None:
    """The JAX package's limits of ``scan_epochs``: array data on one
    device, whole batches only, best-validation callbacks only."""
    if use_loader or mesh is not None:
        raise ValueError("scan_epochs requires in-memory array data on a single device (no loader, no mesh)")
    if n % batch_size:
        raise ValueError(
            f"scan_epochs needs len(training_data) % batch_size == 0 for static scanned shapes, got {n} % "
            f"{batch_size} — trim or pad the training set, or use steps_per_dispatch instead"
        )
    for cb in callbacks or []:
        if not (hasattr(cb, "monitor") and hasattr(cb, "directory")):
            raise ValueError(
                "scan_epochs supports BestValCheckpoint-shaped callbacks only (monitor + directory); got "
                f"{type(cb).__name__}"
            )


def train_network(
    model: DeblenderVAE,
    state: TrainState,
    epochs: int,
    training_data,
    validation_data: tuple,
    batch_size: int,
    callbacks: Iterable | None = None,
    verbose: int = 1,
    train_cfg: TrainConfig | None = None,
    mesh=None,
    metrics_log=None,
    steps_per_dispatch: int = 1,
    device_dataset: bool | None = None,
    scan_epochs: bool = False,
):
    """The epoch loop of the reference's ``train_network``; returns (state,
    history), history a Keras-History-like dict of per-epoch lists (nll,
    kl, loss, mse, then val_nll ... val_mse).

    ``model``: the architecture ``state`` was created for (its config must
    be the state's module's).  ``training_data``: an (inputs, labels) pair
    of (N, S, S, B) arrays, or a loader with ``next_batch()`` and
    ``__len__`` (runtime/loader.py); ``validation_data``: an array pair.
    ``callbacks`` get ``on_epoch_end(epoch, logs, state)``.
    ``metrics_log``: a ``utils.profiling.MetricsLog`` or a JSONL path, one
    record per epoch.  ``steps_per_dispatch`` (>= 1) and ``device_dataset``
    (with ``steps_per_dispatch > 1`` and array data: the training set is
    put on the device once, auto when it is at most 4 GB) give the
    per-step results; ``scan_epochs`` checks the JAX package's limits and
    gives the per-epoch results and best-validation checkpoints.

    ``mesh``: a parallel.Mesh; the state is placed on this rank's first
    device of it (``parallel.sharded.shard_train_state``) and every
    training and validation batch runs data-parallel over its 'data' axis,
    a batch that does not divide it padded with rows of weight 0 (the
    single-device step's results, to the order of float sums).  On a mesh
    across processes every rank calls this with the same arguments; only
    rank 0 runs ``callbacks``, writes ``metrics_log`` and prints."""
    train_cfg = train_cfg or TrainConfig()
    if model.cfg != state.module.cfg:
        raise ValueError("model is not the architecture of the state's module")
    spd = int(steps_per_dispatch)
    if spd < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {spd}")
    if mesh is not None:
        from debvader_tpu_torch.parallel.mesh import DATA_AXIS
        from debvader_tpu_torch.parallel.sharded import (
            make_sharded_eval_step,
            make_sharded_train_step,
            shard_train_state,
        )

        if spd > 1 and batch_size % mesh.shape[DATA_AXIS]:
            raise ValueError(
                f"steps_per_dispatch with mesh requires batch_size divisible by the data axis "
                f"({mesh.shape[DATA_AXIS]})"
            )
        state = shard_train_state(state, mesh)
    # on a mesh across processes rank 0 writes for every rank
    writer = mesh is None or not mesh.spans_processes or mesh.rank == 0
    if not writer:
        callbacks, metrics_log, verbose = None, None, 0
    if isinstance(metrics_log, (str, bytes)) or hasattr(metrics_log, "__fspath__"):
        from debvader_tpu_torch.utils.profiling import MetricsLog

        metrics_log = MetricsLog(metrics_log)
    use_loader = hasattr(training_data, "next_batch")
    if not use_loader:
        x_tr, y_tr = training_data
    x_va, y_va = validation_data
    if scan_epochs:
        _check_scan_epochs(use_loader, None if use_loader else len(x_tr), batch_size, callbacks, mesh)
    dev = state.device

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x_dev = y_dev = None
    if spd > 1 and not use_loader:
        if device_dataset is None:
            device_dataset = np.asarray(x_tr).nbytes + np.asarray(y_tr).nbytes <= (4 << 30)
        if device_dataset:
            x_dev, y_dev = upload(x_tr), upload(y_tr)

    def train_batch(idx):
        if x_dev is None:
            return upload(x_tr[idx]), upload(y_tr[idx])
        ix = torch.from_numpy(idx).to(dev)
        return x_dev[ix], y_dev[ix]

    if mesh is None:
        train_step, eval_step = make_train_step(train_cfg), make_eval_step(train_cfg)
    else:
        train_step, eval_step = make_sharded_train_step(mesh, train_cfg), make_sharded_eval_step(mesh, train_cfg)
    shuffle_rng = np.random.default_rng(train_cfg.seed)
    history: dict[str, list[float]] = {}
    for epoch in range(epochs):
        # running sums stay on the device and are read once an epoch; each
        # batch counts by its size (Keras fit's sample-weighted means)
        sums, n_samples = None, 0

        def add(terms, n):
            nonlocal sums, n_samples
            terms = {k: v * n for k, v in terms.items()}
            sums = terms if sums is None else {k: sums[k] + terms[k] for k in sums}
            n_samples += n

        if use_loader:
            for _ in range(len(training_data)):
                bx, by = training_data.next_batch()
                state, terms = train_step(state, upload(bx), upload(by))
                add(terms, len(bx))
        else:
            for idx in _batches(len(x_tr), batch_size, shuffle_rng if train_cfg.shuffle else None):
                state, terms = train_step(state, *train_batch(idx))
                add(terms, len(idx))

        val_sums, n_val = None, 0
        # int(n/bs) full batches, as the reference's validation_steps; one
        # partial batch when the set is smaller than a batch
        n_val_steps = max(int(len(x_va) / batch_size), 1)
        for i, idx in enumerate(_batches(len(x_va), batch_size, None, drop_remainder=len(x_va) >= batch_size)):
            if i >= n_val_steps:
                break
            terms = eval_step(state, upload(x_va[idx]), upload(y_va[idx]), _validation_generator(
                train_cfg.seed, epoch, i, dev))
            val_sums = terms if val_sums is None else {k: val_sums[k] + terms[k] for k in val_sums}
            n_val += 1

        # keys sorted, as JAX's device_get of the terms dict gives them
        logs = {k: float(v) / n_samples for k, v in sorted(sums.items())} if sums else {}
        if val_sums:
            logs.update({f"val_{k}": float(v) / n_val for k, v in sorted(val_sums.items())})
        for k, v in logs.items():
            history.setdefault(k, []).append(v)
        if verbose == 1:
            print(f"epoch {epoch + 1}/{epochs}: " + " ".join(f"{k}={v:.4f}" for k, v in logs.items()))
        if metrics_log is not None:
            metrics_log.log(epoch, **logs)
        for cb in callbacks or []:
            cb.on_epoch_end(epoch, logs, state)
        if mesh is not None and mesh.spans_processes:
            from debvader_tpu_torch.parallel.distributed import barrier

            barrier()
    return state, history


def train_deblender(
    survey_name: str,
    from_survey: str | None,
    epochs: int,
    training_data_vae: tuple,
    validation_data_vae: tuple,
    training_data_deblender: tuple,
    validation_data_deblender: tuple,
    nb_of_bands: int = 6,
    channel_last: bool = True,
    batch_size: int = 5,
    with_callbacks: bool = False,
    verbose: int = 2,
    train_cfg: TrainConfig | None = None,
    model_cfg: ModelConfig | None = None,
    weights_dir: str | Path | None = None,
    mesh=None,
    metrics_log=None,
    steps_per_dispatch: int = 1,
    device_dataset: bool | None = None,
    scan_epochs: bool = False,
    device="cuda",
):
    """The reference's two-stage trainer: stage 1 trains the whole VAE on
    the "vae" pairs, stage 2 a fresh state with the decoder frozen on the
    "deblender" pairs.  Returns (hist_vae, hist_deblender, state, model),
    ``model`` the trained module (``state.module``).

    ``from_survey`` warm-starts from that survey's weights
    (checkpoint.load_weights), through ``transfer.transfer_band_count`` when
    its band count is not ``nb_of_bands``.  ``with_callbacks`` saves the
    best validation mse and loss of each stage under
    ``<weights_dir>/<survey_name>/<vae|deblender>/<monitor>/ckpt.npz``.
    ``mesh``: both stages data-parallel over a parallel.Mesh (train_network),
    the states on this rank's first device of it (``device`` is not read);
    on a mesh across processes every rank calls this with the same
    arguments, and rank 0 writes the checkpoints."""
    from debvader_tpu_torch.training import checkpoint as ckpt

    model_cfg = model_cfg or ModelConfig(nb_of_bands=nb_of_bands)
    train_cfg = train_cfg or TrainConfig(batch_size=batch_size)
    if mesh is not None:
        device = mesh.device
    data_axis = -1 if channel_last else 2
    if np.shape(training_data_vae[0])[data_axis] != nb_of_bands:
        raise ValueError("The number of bands in the data does not correspond to the number of filters in the network.")
    model = DeblenderVAE(model_cfg)
    variables = None
    if from_survey is not None:
        from debvader_tpu_torch.training.transfer import checkpoint_band_count, transfer_band_count

        variables = ckpt.load_weights(from_survey, weights_dir=weights_dir)
        if checkpoint_band_count(variables) != nb_of_bands:
            variables = transfer_band_count(variables, model_cfg, generator=_seed(train_cfg.seed, 0))
    state = create_train_state(model, train_cfg, variables=variables, device=device)
    run = dict(verbose=verbose, train_cfg=train_cfg, metrics_log=metrics_log, steps_per_dispatch=steps_per_dispatch,
               device_dataset=device_dataset, scan_epochs=scan_epochs, mesh=mesh)
    callbacks = ckpt.define_callbacks("vae", survey_name, weights_dir=weights_dir) if with_callbacks else None
    state, hist_vae = train_network(
        model, state, epochs, training_data_vae, validation_data_vae, batch_size, callbacks, **run
    )
    state2 = create_train_state(
        model, train_cfg, generator=state.generator, freeze_decoder=True, variables=state.variables(), device=device
    )
    callbacks = ckpt.define_callbacks("deblender", survey_name, weights_dir=weights_dir) if with_callbacks else None
    state2, hist_deblender = train_network(
        model, state2, epochs, training_data_deblender, validation_data_deblender, batch_size, callbacks, **run
    )
    return hist_vae, hist_deblender, state2, state2.module
