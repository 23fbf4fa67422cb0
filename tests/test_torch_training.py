"""The port's training held against the JAX package on the CPU, on JAX's
``TINY`` model (stamp 23, 3 bands, latent 4, filters (4, 8)) with the same
parameters carried across (``flatten_flax`` -> ``state_dict_from_flax``):
the losses, flax's train-mode BatchNorm, one step's terms, gradients,
BatchNorm statistics and parameters, optax's Adam on JAX's gradients, the
freezes, the KL anneal, two epochs of ``train_network`` with JAX's noise
replayed, checkpoints and resume, the weights format, band transfer and
the initializers.

Tolerances, and why they are not tighter:

- **Float32 reductions.** XLA's CPU mean of a float32 array is less exact
  than torch's: on the step batch's 12,696 squared residuals JAX's mean is
  4.2e-7 off the float64 mean and the port's 4.3e-8
  (``test_jax_mean_is_the_less_exact``); the step's mse reads 3.3e-6 off
  JAX's, its nll 1.3e-6.  So the terms are held to ``TERM_RTOL`` = 5e-6
  of JAX's, not 1e-6; the KL reads 2e-7.
- **Gradients** are held per leaf against that leaf's largest magnitude
  (``GRAD_TOL`` = 1e-3, read 3.9e-4 at most): the 1e-4 scale floor of the
  pixel Normal turns last-bit differences of the decoder's output into
  gradient differences, and a raw scale that sits on the ReLU's kink in
  one package and off it in the other moves a leaf's gradient by one
  pixel's share.
- **Adam's first step is a sign function**: for |g| >> eps each parameter
  moves by about lr sign(g), so a gradient element near 0 whose sign
  differs moves that parameter by 2 lr.  The updated parameters are held
  element by element within ``PARAM_ATOL`` (1e-6, read ~1e-8) except a
  share of sign flips of at most ``FLIP_SHARE`` (read 0 on TINY).  The
  rule itself is held on JAX's own gradients, within one float32 ulp.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.config import TrainConfig as JaxTrainConfig
from debvader_tpu.models import layers as jlayers
from debvader_tpu.models.distributions import MultivariateNormalTriL as JaxMVN
from debvader_tpu.models.distributions import PixelNormal as JaxPixelNormal
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae as jax_init_vae
from debvader_tpu.training import losses as jlosses
from debvader_tpu.training import train as jtrain
from debvader_tpu.training import transfer as jtransfer

import debvader_tpu_torch as dtt
from debvader_tpu_torch.config import ModelConfig, TrainConfig
from debvader_tpu_torch.models.distributions import MultivariateNormalTriL, PixelNormal
from debvader_tpu_torch.models.layers import BatchNorm
from debvader_tpu_torch.models.vae import DeblenderVAE, init_vae
from debvader_tpu_torch.training import checkpoint as ckpt
from debvader_tpu_torch.training import losses
from debvader_tpu_torch.training import train as tt
from debvader_tpu_torch.training import transfer
from debvader_tpu_torch.weights import flatten_flax, flax_from_state_dict, state_dict_from_flax

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
TINY = ModelConfig(**TINY_KW)
JTINY = JaxModelConfig(**TINY_KW)
TERM_RTOL = 5e-6
GRAD_TOL = 1e-3
PARAM_ATOL = 1e-6
FLIP_SHARE = 1e-3


def _toy_data(n=24, seed=0):
    """tests/test_training.py's blobs: Gaussian stamps plus noise -> the
    noiseless stamps."""
    rng = np.random.default_rng(seed)
    s = 23
    yy, xx = np.mgrid[:s, :s] - s // 2
    blob = np.exp(-(yy**2 + xx**2) / 12.0)
    amp = rng.uniform(0.5, 2.0, size=(n, 1, 1, 1))
    y = amp * blob[None, :, :, None] * np.ones((1, 1, 1, 3))
    x = y + 0.05 * rng.normal(size=y.shape)
    return x.astype(np.float32), y.astype(np.float32)


def _jax_variables(state) -> dict:
    return flatten_flax({"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)})


@functools.lru_cache(maxsize=None)
def _jax_tiny_init():
    """JAX's init_vae of TINY from split(PRNGKey(0))[0], as its
    create_train_state draws it; jitted, the same values as eager."""
    model = JaxVAE(JTINY)
    return jax.jit(lambda key: jax_init_vae(model, key))(jax.random.split(jax.random.PRNGKey(0))[0])


def _pair(lr=1e-4, freeze=None, **cfg):
    """A JAX train state from PRNGKey(0) and the port's state on the same
    variables."""
    jcfg, tcfg = JaxTrainConfig(learning_rate=lr, **cfg), TrainConfig(learning_rate=lr, **cfg)
    jstate = jtrain.create_train_state(JaxVAE(JTINY), jcfg, rng=jax.random.PRNGKey(0), freeze=freeze,
                                       variables=_jax_tiny_init())
    tstate = tt.create_train_state(DeblenderVAE(TINY), tcfg, variables=_jax_variables(jstate), freeze=freeze,
                                   device="cpu")
    return jcfg, jstate, tcfg, tstate


def _grads_as_flax(module, grads) -> dict:
    """Gradients of the module's trainable parameters, keyed by flax path."""
    names = [k for k, p in module.named_parameters() if p.requires_grad]
    return flax_from_state_dict(dict(zip(names, grads)), module.cfg)


def _replay(monkeypatch, jstate, seed=0):
    """Replace the port's noise with the JAX package's draws: a step's eps
    from the split chain of the train state's key, a validation batch's
    from fold_in(fold_in(PRNGKey(seed), epoch), batch)."""
    chain = {"key": jnp.array(jstate.rng)}  # a copy: JAX's steps donate the state

    def noise(generator, shape, like):
        if isinstance(generator, tuple):
            _, epoch, i = generator
            key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), epoch), i)
        else:
            key, chain["key"] = jax.random.split(chain["key"])
        return torch.from_numpy(np.asarray(jax.random.normal(key, shape)))

    monkeypatch.setattr(tt, "_latent_noise", noise)
    monkeypatch.setattr(tt, "_validation_generator", lambda seed, epoch, i, dev: ("val", epoch, i))


# --------------------------------------------------------------- losses


def _distributions(seed=0, n=6, latent=4, s=9, b=3):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(n, latent)).astype(np.float32)
    tril = np.tril(rng.normal(scale=0.3, size=(n, latent, latent))).astype(np.float32)
    idx = np.arange(latent)
    tril[:, idx, idx] = rng.uniform(0.3, 1.5, (n, latent)).astype(np.float32)
    z = rng.normal(size=(n, latent)).astype(np.float32)
    ploc = rng.normal(size=(n, s, s, b)).astype(np.float32)
    pscale = rng.uniform(0.05, 1.0, (n, s, s, b)).astype(np.float32)
    y = rng.normal(size=(n, s, s, b)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    w[1] = 0.0
    return loc, tril, z, ploc, pscale, y, w


@pytest.mark.parametrize("kl_mode", ["analytic", "mc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_equal_jax(kl_mode, weighted):
    """elbo_terms within TERM_RTOL of JAX's, or 1e-6 absolute (the MC KL
    is a small difference of log densities); the MVN log density, the
    analytic KL and the pixel log density element by element within 1e-6
    of their scale.  nll and mse are float32 means over 1,458 pixels,
    where XLA's sum is the less exact."""
    loc, tril, z, ploc, pscale, y, w = _distributions()
    jt = jlosses.elbo_terms(JaxPixelNormal(jnp.asarray(ploc), jnp.asarray(pscale)),
                            JaxMVN(jnp.asarray(loc), jnp.asarray(tril)), jnp.asarray(y), z=jnp.asarray(z),
                            kl_weight=0.01, kl_mode=kl_mode, weights=jnp.asarray(w) if weighted else None)
    t = losses.elbo_terms(PixelNormal(torch.from_numpy(ploc), torch.from_numpy(pscale)),
                          MultivariateNormalTriL(torch.from_numpy(loc), torch.from_numpy(tril)), torch.from_numpy(y),
                          z=torch.from_numpy(z), kl_weight=0.01, kl_mode=kl_mode,
                          weights=torch.from_numpy(w) if weighted else None)
    assert set(t) == set(jt) == {"nll", "kl", "loss", "mse"}
    for k in t:
        np.testing.assert_allclose(float(t[k]), float(jt[k]), rtol=TERM_RTOL, atol=1e-6, err_msg=k)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * float(np.abs(want).max()))

    close(PixelNormal(torch.from_numpy(ploc), torch.from_numpy(pscale)).log_prob(torch.from_numpy(y)),
          JaxPixelNormal(jnp.asarray(ploc), jnp.asarray(pscale)).log_prob(jnp.asarray(y)))
    jpost = JaxMVN(jnp.asarray(loc), jnp.asarray(tril))
    tpost = MultivariateNormalTriL(torch.from_numpy(loc), torch.from_numpy(tril))
    close(tpost.log_prob(torch.from_numpy(z)), jpost.log_prob(jnp.asarray(z)))
    close(tpost.kl_to_standard_normal(), jpost.kl_to_standard_normal())
    with pytest.raises(ValueError, match="requires the sampled latent"):
        losses.kl_divergence(tpost, None, mode="mc")
    with pytest.raises(ValueError, match="unknown kl mode"):
        losses.kl_divergence(tpost, torch.from_numpy(z), mode="exact")


def test_train_mode_batchnorm_equals_flax():
    """flax's BatchNorm(use_running_average=False, momentum 0.99, eps 1e-3):
    the output within 1e-5 of its scale, the running mean and the biased
    fast variance within 1e-6 relative; torch's own BatchNorm2d keeps an
    unbiased running variance, which fails that.  (The fast variance
    E[x^2] - E[x]^2 cancels where a channel's mean is large against its
    spread, and float32 summation order then moves it far more: inputs
    here are of the encoder's kind, means of the order of the spread.)"""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(5, 7, 7, 3)) * [1.0, 3.0, 0.5] + [0.5, -1.0, 0.3]).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    bias = rng.normal(size=3).astype(np.float32)
    mean0, var0 = rng.normal(size=3).astype(np.float32), rng.uniform(0.5, 2, 3).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    ours = BatchNorm(3)
    with torch.no_grad():
        ours.scale.copy_(torch.from_numpy(scale))
        ours.bias.copy_(torch.from_numpy(bias))
        ours.mean.copy_(torch.from_numpy(mean0))
        ours.var.copy_(torch.from_numpy(var0))
    got = ours(torch.from_numpy(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(ours.mean.numpy(), mutated["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(ours.var.numpy(), mutated["batch_stats"]["var"], rtol=1e-6)
    ref = torch.nn.BatchNorm2d(3, eps=1e-3, momentum=0.01)
    ref.running_mean.copy_(torch.from_numpy(mean0))
    ref.running_var.copy_(torch.from_numpy(var0))
    ref.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(ref.running_var.numpy(), mutated["batch_stats"]["var"], rtol=1e-6)
    # inference mode reads the running statistics and changes nothing
    before = ours.mean.clone()
    ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(ours.mean, before)


# ----------------------------------------------------------------- a step


def _jax_step_pieces(jcfg, jstate, x, y):
    rng_step = jax.random.split(jstate.rng)[0]
    eps = np.asarray(jax.random.normal(rng_step, (len(x), TINY.latent_dim)))
    grads, _ = jax.jit(jax.grad(jtrain.make_loss_fn(JaxVAE(JTINY), jcfg), has_aux=True))(
        jstate.params, jstate.batch_stats, jnp.asarray(x), jnp.asarray(y), rng_step, jstate.step)
    return eps, flatten_flax({"params": jax.device_get(grads)})


def test_jax_mean_is_the_less_exact():
    """Why the step's terms are held at TERM_RTOL: on the step's squared
    residuals XLA's float32 mean is further from the float64 mean than the
    port's (torch's)."""
    x, y = _toy_data(8)
    d2 = np.square(x - y)
    exact = d2.astype(np.float64).mean()
    jax_err = abs(float(jnp.mean(jnp.asarray(d2))) / exact - 1)
    port_err = abs(float(torch.from_numpy(d2).mean()) / exact - 1)
    print(f"float32 mean off the float64 mean: JAX {jax_err}, port {port_err}")
    assert port_err <= jax_err


def test_one_step_equals_jax(monkeypatch):
    """From the same parameters, batch and eps: the loss terms within
    TERM_RTOL, every gradient leaf within GRAD_TOL of its largest magnitude,
    the BatchNorm running statistics within 1e-6 relative, the step counter,
    and the updated parameters within PARAM_ATOL but for at most FLIP_SHARE
    of them (Adam's first step moves a parameter by about lr sign(g))."""
    jcfg, jstate, tcfg, tstate = _pair(batch_size=8)
    x, y = _toy_data(8)
    eps, jgrads = _jax_step_pieces(jcfg, jstate, x, y)
    module = copy.deepcopy(tstate.module)  # its train-mode forward moves the BatchNorm statistics
    loss, _ = tt.make_loss_fn(tcfg)(module, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(eps), 0)
    tgrads = _grads_as_flax(module, torch.autograd.grad(loss, [p for p in module.parameters() if p.requires_grad]))
    worst = 0.0
    for k, g in jgrads.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(tgrads[k] - g).max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (k, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    print(f"one step: largest gradient difference {worst} of the leaf's scale")
    # the port's step with JAX's eps
    monkeypatch.setattr(tt, "_latent_noise", lambda gen, shape, like: torch.from_numpy(eps))
    jnew, jterms = jtrain.make_train_step(JaxVAE(JTINY), jcfg, donate=False)(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, tterms = tt.make_train_step(tcfg)(tstate, torch.from_numpy(x), torch.from_numpy(y))
    for k in jterms:
        np.testing.assert_allclose(float(tterms[k]), float(jterms[k]), rtol=TERM_RTOL, err_msg=k)
        print(f"one step: {k} relative difference {abs(float(tterms[k]) / float(jterms[k]) - 1)}")
    assert tstate.step == int(jnew.step) == 1
    want = _jax_variables(jnew)
    got = tstate.variables()
    for k in ("batch_stats/encoder/BatchNorm_0/mean", "batch_stats/encoder/BatchNorm_0/var"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    n_flip = n_all = 0
    lr = tcfg.learning_rate
    for k in want:
        d = np.abs(got[k] - want[k])
        n_all += d.size
        n_flip += int((d > PARAM_ATOL).sum())
        # anything off by more than the tolerance is a sign flip: 2 lr
        assert np.all((d <= PARAM_ATOL) | (np.abs(d - 2 * lr) <= 0.1 * lr)), k
    print(f"one step: {n_flip} of {n_all} parameters moved the other way")
    assert n_flip <= FLIP_SHARE * n_all


def test_adam_rule_on_jax_gradients():
    """optax.adam applied to JAX's gradients over four steps, and the port's
    rule on the same gradients from the same parameters: every parameter
    within one float32 ulp of optax's (the rule's float32 ops in optax's
    order; XLA may contract a multiply-add)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (7,), (2, 3, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-9, 2, s)).astype(np.float32) for s in shapes]
             for _ in range(4)]
    tx = optax.adam(3e-4)
    jp = [jnp.asarray(p) for p in params]
    opt = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    mu = [torch.zeros_like(p) for p in tp]
    nu = [torch.zeros_like(p) for p in tp]
    for step, g in enumerate(grads, 1):
        upd, opt = tx.update([jnp.asarray(a) for a in g], opt, jp)
        jp = optax.apply_updates(jp, upd)
        tt._adam_update(tp, [torch.from_numpy(a) for a in g], mu, nu, step, 3e-4)
        for a, b in zip(tp, jp):
            b = np.asarray(b)
            ulp = np.spacing(np.abs(b).astype(np.float32))
            assert np.all(np.abs(a.numpy() - b) <= ulp), step
        for m, s in zip(mu, opt[0].mu):
            np.testing.assert_allclose(m.numpy(), s, rtol=2e-7, atol=0)


# ----------------------------------------------------------------- freezes


@pytest.mark.parametrize("freeze", ["decoder", "encoder"])
def test_freezes_as_jax(monkeypatch, freeze):
    """A frozen module's parameters stay bit for bit and hold no moments;
    the BatchNorm running statistics update even with the encoder frozen
    (flax's mutable batch_stats); the trainable parameters move as JAX's."""
    jcfg, jstate, tcfg, tstate = _pair(freeze=freeze, batch_size=8)
    x, y = _toy_data(8)
    jlabels = {
        "params/" + "/".join(p.key for p in path): label
        for path, label in jax.tree_util.tree_leaves_with_path(jtrain.freeze_labels(jstate.params, freeze))
    }
    names = dtt.weights._flax_names(TINY)
    assert {names[k][0]: v for k, v in tstate.labels.items()} == jlabels
    assert all(freeze not in k.split(".") for k in tstate.mu)
    if freeze == "decoder":
        assert tt.decoder_freeze_labels(tstate.module) == tstate.labels
    before = tstate.variables()
    _replay(monkeypatch, jstate)
    jnew, _ = jtrain.make_train_step(JaxVAE(JTINY), jcfg, donate=False)(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, _ = tt.make_train_step(tcfg)(tstate, torch.from_numpy(x), torch.from_numpy(y))
    got, want = tstate.variables(), _jax_variables(jnew)
    for k in got:
        if k.startswith(f"params/{freeze}/"):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            np.testing.assert_array_equal(want[k], before[k], err_msg=k)
        elif k.startswith("batch_stats/"):
            assert not np.array_equal(got[k], before[k])
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        else:
            d = np.abs(got[k] - want[k])
            assert np.all((d <= PARAM_ATOL) | (np.abs(d - 2 * tcfg.learning_rate) <= 1e-5)), k


def test_kl_anneal_as_jax():
    """The annealed KL weight, bit for bit, before, during and after the
    ramp, and fixed without it."""
    for cfg in (dict(kl_anneal_steps=7, kl_weight=0.03), dict(kl_weight=0.01)):
        for step in (0, 1, 3, 6, 7, 50):
            want = np.float32(jtrain._kl_weight_at(jnp.asarray(step, jnp.int32), JaxTrainConfig(**cfg)))
            assert np.float32(tt._kl_weight_at(step, TrainConfig(**cfg))) == want


# ----------------------------------------------------------- train_network


def test_batches_equal_jax():
    """The host shuffle and the partial block, index for index."""
    for drop in (False, True):
        a = list(jtrain._batches(23, 5, np.random.default_rng(4), drop_remainder=drop))
        b = list(tt._batches(23, 5, np.random.default_rng(4), drop_remainder=drop))
        assert len(a) == len(b) == (4 if drop else 5)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_train_network_history_equals_jax(monkeypatch):
    """Two epochs on 23 stamps at batch 5 (four full batches and a partial
    one a epoch, shuffled) and 7 validation stamps (one full batch): with
    JAX's noise replayed, the history has JAX's keys and values (within
    1e-4 relative: two epochs of sign-function Adam steps from float32
    gradients a few 1e-4 apart), the step count and the validation cap."""
    jcfg, jstate, tcfg, tstate = _pair(batch_size=5)
    x, y = _toy_data(23, seed=1)
    xv, yv = _toy_data(7, seed=2)
    _replay(monkeypatch, jstate)
    jnew, jhist = jtrain.train_network(JaxVAE(JTINY), jstate, 2, (x, y), (xv, yv), 5, verbose=0, train_cfg=jcfg)
    tstate, thist = tt.train_network(DeblenderVAE(TINY), tstate, 2, (x, y), (xv, yv), 5, verbose=0, train_cfg=tcfg)
    assert list(thist) == list(jhist)
    for k in jhist:
        np.testing.assert_allclose(thist[k], jhist[k], rtol=1e-4, err_msg=k)
    assert tstate.step == int(jnew.step) == 10


def test_validation_of_a_set_smaller_than_a_batch(monkeypatch):
    """One partial validation batch when there is no full one (JAX's
    exception to int(n / bs)), and sample-weighted training means."""
    jcfg, jstate, tcfg, tstate = _pair(batch_size=5)
    x, y = _toy_data(7)
    _replay(monkeypatch, jstate)
    _, jhist = jtrain.train_network(JaxVAE(JTINY), jstate, 1, (x, y), (x[:3], y[:3]), 5, verbose=0, train_cfg=jcfg)
    _, thist = tt.train_network(DeblenderVAE(TINY), tstate, 1, (x, y), (x[:3], y[:3]), 5, verbose=0, train_cfg=tcfg)
    for k in jhist:
        np.testing.assert_allclose(thist[k], jhist[k], rtol=1e-4, err_msg=k)


def test_dispatch_options_give_the_per_step_results(tmp_path):
    """steps_per_dispatch, device_dataset and scan_epochs give the per-step
    history bit for bit and the same best-validation checkpoint; their
    limits raise as JAX's do; mesh= over 5 shards gives the first epoch's
    history within rtol 1e-4, JAX's tolerance for its mesh histories
    (tests/test_torch_mesh_training.py holds the rest); a metrics log gets one record an epoch."""
    x, y = _toy_data(20)
    xv, yv = _toy_data(5, seed=3)
    cfg = TrainConfig(batch_size=5, learning_rate=1e-3)

    def run(**kw):
        state = tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu")
        return tt.train_network(DeblenderVAE(TINY), state, 2, (x, y), (xv, yv), 5, verbose=0, train_cfg=cfg, **kw)

    _, base = run()
    for kw in (dict(steps_per_dispatch=3), dict(steps_per_dispatch=2, device_dataset=True)):
        assert run(**kw)[1] == base
    cbs = {}
    for scan in (False, True):
        cbs[scan] = [ckpt.BestValCheckpoint(tmp_path / str(scan), "val_loss", verbose=0)]
        assert run(scan_epochs=scan, callbacks=cbs[scan], metrics_log=tmp_path / f"{scan}.jsonl")[1] == base
    a, b = (ckpt.load_weights_from(tmp_path / str(s) / "ckpt.npz") for s in (False, True))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert len((tmp_path / "True.jsonl").read_text().splitlines()) == 2
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
        run(steps_per_dispatch=0)
    with pytest.raises(ValueError, match="len\\(training_data\\) % batch_size"):
        state = tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu")
        tt.train_network(DeblenderVAE(TINY), state, 1, (x[:7], y[:7]), (xv, yv), 5, verbose=0, scan_epochs=True)
    with pytest.raises(ValueError, match="BestValCheckpoint-shaped"):
        run(scan_epochs=True, callbacks=[object()])
    from debvader_tpu_torch.parallel import make_mesh

    mesh_hist = run(mesh=make_mesh(5, devices=["cpu"] * 5))[1]
    for k in base:
        np.testing.assert_allclose(mesh_hist[k][0], base[k][0], rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="architecture"):
        tt.train_network(DeblenderVAE(dataclasses.replace(TINY, latent_dim=5)), run()[0], 1, (x, y), (xv, yv), 5)


def test_resume_is_bit_exact(tmp_path):
    """Save a train state after three steps, go on for three; restore it
    into a fresh state and go on for the same three: parameters, moments,
    BatchNorm statistics, step and noise bit for bit."""
    x, y = _toy_data(10)
    cfg = TrainConfig(batch_size=5, learning_rate=1e-3)
    step = tt.make_train_step(cfg)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)

    def go(state, n):
        for i in range(n):
            state, _ = step(state, xs[5 * (i % 2):5 * (i % 2) + 5], ys[5 * (i % 2):5 * (i % 2) + 5])
        return state

    a = go(tt.create_train_state(DeblenderVAE(TINY), cfg, freeze="decoder", device="cpu"), 3)
    ckpt.save_train_state(tmp_path / "state", a)
    a = go(a, 3)
    b = tt.create_train_state(DeblenderVAE(TINY), TrainConfig(seed=9), freeze="decoder", device="cpu")
    b = go(ckpt.restore_train_state(tmp_path / "state.npz", b), 3)
    assert a.step == b.step == 6
    for k, v in a.module.state_dict().items():
        assert torch.equal(v, b.module.state_dict()[k]), k
    for k in a.mu:
        assert torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    other = tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu")
    with pytest.raises(ValueError, match="another freeze"):
        ckpt.restore_train_state(tmp_path / "state.npz", other)


def test_two_seeded_runs_are_bit_identical():
    """create_train_state from a seed, then train_network: two runs give the
    same parameters bit for bit; another seed does not."""
    x, y = _toy_data(10)

    def run(seed):
        cfg = TrainConfig(batch_size=5, seed=seed)
        state = tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu")
        return tt.train_network(DeblenderVAE(TINY), state, 1, (x, y), (x, y), 5, verbose=0, train_cfg=cfg)[0]

    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(v, b.module.state_dict()[k]) for k, v in a.module.state_dict().items())
    assert not torch.equal(a.module.decoder.head.weight, c.module.decoder.head.weight)


# --------------------------------------------------- weights and transfer


def test_weights_round_trip_both_ways():
    """flatten_flax(JAX variables) -> state dict -> flax dict is the same
    arrays, bit for bit, for a fresh JAX TINY model and the packaged
    sim_demo weights; state dict -> flax -> state dict too."""
    jvars = flatten_flax(jax.device_get(_jax_tiny_init()))
    packed = dtt.weights.load_flax_npz(dtt.weights.default_weights_dir() / "sim_demo.npz")
    for flat, cfg in ((jvars, TINY), (packed, ModelConfig())):
        back = flax_from_state_dict(state_dict_from_flax(flat, cfg), cfg)
        assert set(back) == set(flat)
        for k in flat:
            assert back[k].dtype == np.float32 and np.array_equal(back[k], flat[k]), k
    net = init_vae(DeblenderVAE(TINY), 5)
    again = state_dict_from_flax(flax_from_state_dict(net.state_dict(), TINY), TINY)
    assert set(again) == set(net.state_dict())
    assert all(torch.equal(again[k], v) for k, v in net.state_dict().items())


def test_transfer_band_count_as_jax():
    """The same leaves carried and reinitialized as JAX's transfer from a
    6-band checkpoint to 3 bands; carried leaves equal the source, fresh
    ones have the target's shape; an unrelated checkpoint raises."""
    six = dataclasses.replace(TINY, nb_of_bands=6)
    src = flax_from_state_dict(init_vae(DeblenderVAE(six), 1).state_dict(), six)
    six_model = JaxVAE(dataclasses.replace(JTINY, nb_of_bands=6))
    jsrc = jax.jit(lambda key: jax_init_vae(six_model, key))(jax.random.PRNGKey(1))
    jinfo = {}

    def jax_transfer(v):  # jitted (eager flax init is slow); the paths are filled while tracing
        out, info = jtransfer.transfer_band_count(v, JTINY, return_info=True)
        jinfo.update(info)
        return out

    jax.jit(jax_transfer)(jsrc)
    out, info = transfer.transfer_band_count(src, TINY, generator=2, return_info=True)

    def path(keystr):
        return "/".join(p.strip("[]'") for p in keystr.split("]["))

    assert {path(k) for k in jinfo["transferred"]} == set(info["transferred"])
    assert {path(k) for k in jinfo["reinitialized"]} == set(info["reinitialized"])
    assert transfer.checkpoint_band_count(src) == 6 and transfer.checkpoint_band_count(out) == 3
    for k in info["transferred"]:
        assert np.array_equal(out[k], src[k])
    fresh = flax_from_state_dict(DeblenderVAE(TINY).state_dict(), TINY)
    assert {k: v.shape for k, v in out.items()} == {k: v.shape for k, v in fresh.items()}
    with pytest.raises(ValueError, match="no tensor carried over"):
        transfer.transfer_band_count({"params/x": np.zeros(3)}, TINY)


def test_init_distributions_as_jax():
    """A fresh model (stamp 23, 6 bands, latent 32, filters (32, 64)) drawn
    as the JAX package's init_vae: the same leaves, shapes, zeros and ones;
    each kernel's standard deviation within 5 sampling standard errors of
    flax's target (sqrt(1 / fan_in) for lecun_normal, limit / sqrt(3) for
    glorot_uniform), as JAX's own draw is, and its range inside the
    truncation at 2 raw standard deviations or the glorot limit; a seed
    gives the same model, another seed another."""
    kw = dict(stamp_size=23, nb_of_bands=6, latent_dim=32, filters=(32, 64), kernels=(3, 3))
    cfg = ModelConfig(**kw)
    jvars = jax.jit(lambda key: jax_init_vae(JaxVAE(JaxModelConfig(**kw)), key))(jax.random.PRNGKey(0))
    jvars = flatten_flax(jax.device_get(jvars))
    ours = flax_from_state_dict(init_vae(DeblenderVAE(cfg), 0).state_dict(), cfg)
    assert set(ours) == set(jvars)
    for k, w in jvars.items():
        o = ours[k]
        assert o.shape == w.shape, k
        if not k.endswith("kernel"):
            assert np.array_equal(o, w), k
            continue
        if "ConvTranspose" in k:  # (kh, kw, out, in): fans over in_axis 3, out_axis 2
            rf = w.shape[0] * w.shape[1]
            bound = np.sqrt(6.0 / (rf * (w.shape[2] + w.shape[3])))
            target = bound / np.sqrt(3.0)
        else:
            target = np.sqrt(1.0 / np.prod(w.shape[:-1]))
            bound = 2 * target / 0.87962566103423978
        for a in (o, w):
            assert abs(a.std() / target - 1) < 5 / np.sqrt(2 * a.size), (k, a.std(), target)
            assert np.abs(a).max() <= bound * (1 + 1e-6), k
    again = flax_from_state_dict(init_vae(DeblenderVAE(cfg), 0).state_dict(), cfg)
    assert all(np.array_equal(again[k], ours[k]) for k in ours)
    other = flax_from_state_dict(init_vae(DeblenderVAE(cfg), 1).state_dict(), cfg)
    assert not np.array_equal(other["params/encoder/Conv_0/kernel"], ours["params/encoder/Conv_0/kernel"])


# ---------------------------------------------- checkpoints and two stages


def test_train_deblender_two_stages(tmp_path):
    """Both stages on TINY: the histories' keys, the decoder bit for bit
    through stage 2, the best-validation checkpoints written and reloaded
    through load_deblender (also with return_encoder_decoder_z), a warm
    start from them, through band transfer from a 6-band checkpoint, and
    the channel check."""
    x, y = _toy_data(12)
    data = ((x, y), (x[:5], y[:5]))
    kw = dict(nb_of_bands=3, batch_size=5, model_cfg=TINY, weights_dir=tmp_path, verbose=0, device="cpu",
              train_cfg=TrainConfig(batch_size=5, learning_rate=1e-3))
    h1, h2, state, model = tt.train_deblender("toy", None, 2, *data, *data, with_callbacks=True, **kw)
    assert list(h1) == list(h2) == ["kl", "loss", "mse", "nll", "val_kl", "val_loss", "val_mse", "val_nll"]
    assert model is state.module and state.step == 6
    files = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("ckpt.npz"))
    assert files == [f"toy/{s}/{m}/ckpt.npz" for s in ("deblender", "vae") for m in ("val_loss", "val_mse")]
    net = dtt.load_deblender("toy", device="cpu", weights_dir=tmp_path, cfg=TINY)
    net2, encode, decode = dtt.load_deblender("toy", device="cpu", weights_dir=tmp_path, cfg=TINY,
                                              return_encoder_decoder_z=True)
    with torch.no_grad():
        post = net.encode(torch.from_numpy(x[:2]))
    assert torch.equal(encode(torch.from_numpy(x[:2])).loc, post.loc)
    assert torch.equal(decode(post.loc).loc, net.decode(post.loc).loc)
    # a decoder-frozen state trains the encoder and leaves the decoder bit for bit
    s1 = tt.create_train_state(DeblenderVAE(TINY), kw["train_cfg"], device="cpu")
    s2 = tt.create_train_state(DeblenderVAE(TINY), kw["train_cfg"], freeze_decoder=True,
                               variables=s1.variables(), device="cpu")
    dec = {k: v.clone() for k, v in s2.module.decoder.state_dict().items()}
    s2, _ = tt.train_network(DeblenderVAE(TINY), s2, 1, (x, y), (x, y), 5, verbose=0, train_cfg=kw["train_cfg"])
    assert all(torch.equal(v, s2.module.decoder.state_dict()[k]) for k, v in dec.items())
    assert not torch.equal(s2.module.encoder.convs[0].weight, s1.module.encoder.convs[0].weight)
    # warm starts: same bands, and from a 6-band checkpoint
    tt.train_deblender("toy2", "toy", 1, *data, *data, **kw)
    six = dataclasses.replace(TINY, nb_of_bands=6)
    ckpt.save_weights(tmp_path / "six" / "ckpt", flax_from_state_dict(init_vae(DeblenderVAE(six), 3).state_dict(), six))
    _, _, warm, _ = tt.train_deblender("toy3", "six", 1, *data, *data, **kw)
    assert warm.module.encoder.bn.scale.shape == (3,)
    with pytest.raises(ValueError, match="number of bands"):
        tt.train_deblender("toy4", None, 1, *data, *data, **dict(kw, nb_of_bands=6))
    with pytest.raises(FileNotFoundError):
        ckpt.load_weights("absent", weights_dir=tmp_path)


def test_metrics_log_and_trace(tmp_path):
    """MetricsLog appends JSONL records; trace writes a Chrome trace of the
    block's operators."""
    log = dtt.utils.profiling.MetricsLog(tmp_path / "m.jsonl")
    log.log(0, loss=2.0)
    log.log(1, loss=1.5, mse=0.1)
    assert log.series("loss") == [2.0, 1.5] and log.last() == {"step": 1, "loss": 1.5, "mse": 0.1}
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 2
    with dtt.utils.profiling.trace(tmp_path / "trace"):
        torch.ones(8) @ torch.ones(8)
    assert "aten::" in (tmp_path / "trace" / "trace.json").read_text()


def test_make_dataset():
    """Both stages' pairs share the clean targets, float32 at the asked
    shapes, the same for a seed."""
    from debvader_tpu_torch.data.simulate import make_dataset

    d = make_dataset(5, n_train=6, n_val=3, stamp=23, bands=3)
    (xv, yv), (xvv, yvv) = d["vae"]
    (xd, yd), (xdv, ydv) = d["deblender"]
    assert xv.shape == yd.shape == (6, 23, 23, 3) and xvv.shape == (3, 23, 23, 3) and xv.dtype == np.float32
    assert np.array_equal(yv, yd) and np.array_equal(yvv, ydv) and not np.array_equal(xv, xd)
    assert np.array_equal(make_dataset(5, n_train=6, n_val=3, stamp=23, bands=3)["vae"][0][0], xv)


def test_prelu_gradient_at_a_tie_as_jax():
    """At x = 0 JAX's PReLU passes half the gradient through each branch
    (jnp.maximum / jnp.minimum); so does the port's, for x and alpha."""
    x = np.array([[-1.5, 0.0, 0.0, 2.0]], np.float32)
    alpha = np.array([0.0, 0.0, 0.3, 0.3], np.float32)
    prelu = jlayers.PReLU()

    def f(a, v):
        return jnp.sum(prelu.apply({"params": {"alpha": a}}, v) * jnp.arange(1.0, 5.0))

    ga, gx = jax.grad(f, argnums=(0, 1))(jnp.asarray(alpha), jnp.asarray(x))
    ours = dtt.models.layers.PReLU((4,))
    with torch.no_grad():
        ours.alpha.copy_(torch.from_numpy(alpha))
    tx = torch.from_numpy(x).requires_grad_(True)
    (ours(tx) * torch.arange(1.0, 5.0)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), gx)
    np.testing.assert_array_equal(ours.alpha.grad.numpy(), ga)
