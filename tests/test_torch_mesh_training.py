"""Data-parallel (and tensor-parallel) training on the port's
single-controller mesh (parallel/sharded.py, training/train.py mesh=),
held against the JAX package's sharded steps on its 8 virtual CPU devices
and against the port's own single-device steps.

JAX's noise is replayed into the port through ``training/train
._latent_noise`` (tests/test_torch_training.py's ``_replay``): threefry's
stream is not torch's.  The tolerances are JAX's own for its sharded step
against its single-device step (tests/test_parallel.py: loss rtol 1e-4,
parameters atol 2e-4 after three steps; tests/test_mesh_training.py:
histories rtol 1e-4, parameters atol 5e-3 after two epochs); against JAX a
parameter may also sit 2 lr off where Adam's first steps take the other
sign of a gradient near 0 (tests/test_torch_training.py's FLIP_SHARE).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.parallel import make_mesh as jax_make_mesh
from debvader_tpu.parallel import make_sharded_train_step as jax_sharded_step
from debvader_tpu.parallel import shard_batch as jax_shard_batch
from debvader_tpu.parallel import shard_train_state as jax_shard_state
from debvader_tpu.training import train as jtrain
from debvader_tpu_torch import parallel
from debvader_tpu_torch.config import ModelConfig, TrainConfig
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.training import train as tt
from test_torch_training import FLIP_SHARE, JTINY, TINY, _jax_variables, _pair, _replay, _toy_data

torch.set_num_threads(1)


def _mesh(n=8, model_parallel=1):
    return parallel.make_mesh(n, model_parallel=model_parallel, devices=["cpu"] * n)


def _params_close(got: dict, want: dict, atol: float, lr: float = 0.0):
    """Every parameter within ``atol``, but (with ``lr``) at most
    FLIP_SHARE of them off by about 2 lr a step, Adam's sign flips."""
    n_off = n_all = 0
    for k in want:
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))
        n_all += d.size
        n_off += int((d > atol).sum())
        if not lr:
            assert not (d > atol).any(), (k, float(d.max()))
    assert n_off <= FLIP_SHARE * n_all, (n_off, n_all)
    return n_off


def test_sharded_steps_match_jax_and_single_device(monkeypatch):
    """Three data-parallel steps on a batch of 16 over 8 shards (JAX's
    test_sharded_matches_single_device) from the same state and noise: the
    terms of each step within rtol 1e-4 of JAX's sharded steps and of the
    port's single-device steps, the parameters and BatchNorm statistics
    after them within atol 2e-4."""
    jcfg, jstate, tcfg, tstate = _pair(lr=1e-3, batch_size=16)
    x, y = _toy_data(16, seed=2)
    jmesh = jax_make_mesh()
    jstep = jax_sharded_step(JaxVAE(JTINY), jmesh, jcfg, donate=False)
    js = jax_shard_state(jstate, jmesh)
    xb, yb = jax_shard_batch(jnp.asarray(x), jmesh), jax_shard_batch(jnp.asarray(y), jmesh)
    jterms = []
    for _ in range(3):
        js, t = jstep(js, xb, yb)
        jterms.append({k: float(v) for k, v in t.items()})

    runs = {}
    for name, step, mesh in (("single", tt.make_train_step(tcfg), None),
                             ("mesh", parallel.make_sharded_train_step(_mesh(), tcfg), _mesh())):
        _replay(monkeypatch, jstate)
        state = tt.create_train_state(DeblenderVAE(TINY), tcfg, variables=_jax_variables(jstate), device="cpu")
        if mesh is not None:
            state = parallel.shard_train_state(state, mesh)
        terms = []
        for _ in range(3):
            state, t = step(state, torch.from_numpy(x), torch.from_numpy(y))
            terms.append({k: float(v) for k, v in t.items()})
        runs[name] = (state, terms)
    (single, sterms), (mesh_state, mterms) = runs["single"], runs["mesh"]
    assert mesh_state.step == single.step == int(js.step) == 3
    for m, s, j in zip(mterms, sterms, jterms):
        for k in j:
            np.testing.assert_allclose(m[k], j[k], rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(m[k], s[k], rtol=1e-4, err_msg=k)
    got = mesh_state.variables()
    _params_close(got, single.variables(), 2e-4)
    print(f"three steps: {_params_close(got, _jax_variables(js), 2e-4, lr=1e-3)} parameters 2 lr off JAX's")
    for k in ("batch_stats/encoder/BatchNorm_0/mean", "batch_stats/encoder/BatchNorm_0/var"):
        np.testing.assert_allclose(got[k], _jax_variables(js)[k], rtol=1e-5, err_msg=k)


def test_weighted_and_eval_steps_match_single_device():
    """The weighted step on an odd batch of 7 over 4 shards (one pad row,
    weight 0, out of the loss, the gradient and the BatchNorm statistics)
    is the single-device weighted step; the sharded validation step is the
    single-device one."""
    cfg = TrainConfig(learning_rate=1e-3, batch_size=7)
    x, y = (torch.from_numpy(a) for a in _toy_data(7, seed=5))
    w = torch.tensor([1.0, 0.0, 2.0, 1.0, 1.0, 0.5, 1.0])
    states = [tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu") for _ in range(2)]
    s1, t1 = tt.make_train_step(cfg, weighted=True)(states[0], x, y, w)
    s2, t2 = parallel.make_sharded_train_step(_mesh(4), cfg, weighted=True)(states[1], x, y, w)
    for k in t1:
        np.testing.assert_allclose(float(t2[k]), float(t1[k]), rtol=1e-5, err_msg=k)
    _params_close(s2.variables(), s1.variables(), 2e-5)
    g = torch.Generator().manual_seed(4)
    e1 = tt.make_eval_step(cfg)(s1, x, y, g)
    e2 = parallel.make_sharded_eval_step(_mesh(4), cfg)(s2, x, y, torch.Generator().manual_seed(4))
    for k in e1:
        np.testing.assert_allclose(float(e2[k]), float(e1[k]), rtol=1e-5, err_msg=k)
    with pytest.raises(TypeError, match="weighted"):
        parallel.make_sharded_train_step(_mesh(4), cfg)(s2, x, y, w)


def test_tp_dp_step_matches_single_device():
    """4-way data x 2-way model on the full-size architecture (JAX's
    test_sharded_tp_dp_train_step): the encoder head and the decoder's
    expansion compute their output columns share by share; one step's
    terms and parameters are the single-device step's."""
    cfg = TrainConfig(batch_size=8, seed=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 59, 59, 6)).astype(np.float32))
    model = DeblenderVAE(ModelConfig())
    s1 = tt.create_train_state(model, cfg, device="cpu")
    s2 = tt.create_train_state(model, cfg, device="cpu")
    s1, t1 = tt.make_train_step(cfg)(s1, x, x)
    s2, t2 = parallel.make_sharded_train_step(_mesh(8, 2), cfg)(s2, x, x)
    assert np.isfinite(float(t2["loss"]))
    for k in t1:
        np.testing.assert_allclose(float(t2[k]), float(t1[k]), rtol=1e-4, err_msg=k)
    _params_close(s2.variables(), s1.variables(), 2e-4, lr=cfg.learning_rate)


def test_train_network_mesh_matches_jax_and_single_device(monkeypatch):
    """Two epochs at batch 16 over 8 shards (JAX's
    test_train_network_mesh_matches_single_device): the history within
    rtol 1e-4 of JAX's mesh run and of the port's single-device run, the
    parameters within 5e-3."""
    jcfg, jstate, tcfg, _ = _pair(lr=1e-3, batch_size=16)
    x, y = _toy_data(32, seed=1)
    xv, yv = _toy_data(16, seed=2)
    # JAX's mesh run donates its state: keep what the port's runs start from
    start = SimpleNamespace(rng=jnp.array(jstate.rng))
    variables = _jax_variables(jstate)
    _replay(monkeypatch, start)
    jnew, jhist = jtrain.train_network(JaxVAE(JTINY), jstate, 2, (x, y), (xv, yv), 16, verbose=0, train_cfg=jcfg,
                                       mesh=jax_make_mesh())
    hists = {}
    for mesh in (None, _mesh()):
        _replay(monkeypatch, start)
        state = tt.create_train_state(DeblenderVAE(TINY), tcfg, variables=variables, device="cpu")
        hists[mesh is None] = tt.train_network(DeblenderVAE(TINY), state, 2, (x, y), (xv, yv), 16, verbose=0,
                                               train_cfg=tcfg, mesh=mesh)
    (s_mesh, h_mesh), (s_one, h_one) = hists[False], hists[True]
    assert list(h_mesh) == list(jhist)
    for k in jhist:
        np.testing.assert_allclose(h_mesh[k], jhist[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(h_mesh[k], h_one[k], rtol=1e-4, err_msg=k)
    _params_close(s_mesh.variables(), s_one.variables(), 5e-3)
    _params_close(s_mesh.variables(), _jax_variables(jnew), 5e-3)


def test_train_network_mesh_pads_odd_batches():
    """batch_size=5 on 8 shards, 23 samples (four full batches and a tail
    of 3, each padded with rows of weight 0): training runs and converges
    (JAX's test_train_network_mesh_pads_odd_batches), and its first
    epoch's history is the single-device run's within rtol 1e-5 (the pad
    rows are out of the BatchNorm statistics too).  Later epochs drift
    apart by more: on this toy's loss of about 1e6 Adam amplifies the
    sharded sums' reassociation, as it does between the JAX package's mesh
    and single-device runs.  A one-shard mesh, with the single-device sums,
    stays within rtol 1e-6 for every epoch."""
    cfg = TrainConfig(learning_rate=1e-3, batch_size=5, seed=0)
    x, y = _toy_data(23, seed=3)
    hists = []
    for mesh in (None, _mesh(), _mesh(1)):
        state = tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu")
        hists.append(tt.train_network(DeblenderVAE(TINY), state, 3, (x, y), (x[:5], y[:5]), 5, verbose=0,
                                      train_cfg=cfg, mesh=mesh)[1])
    single, eight, one = hists
    assert np.isfinite(eight["loss"]).all() and eight["loss"][-1] < eight["loss"][0]
    for k in single:
        np.testing.assert_allclose(eight[k][0], single[k][0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(one[k], single[k], rtol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="no loader, no mesh"):
        tt.train_network(DeblenderVAE(TINY), tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu"), 1,
                         (x[:20], y[:20]), (x, y), 5, verbose=0, mesh=_mesh(), scan_epochs=True)
    with pytest.raises(ValueError, match="divisible by the data axis"):
        tt.train_network(DeblenderVAE(TINY), tt.create_train_state(DeblenderVAE(TINY), cfg, device="cpu"), 1,
                         (x, y), (x, y), 5, verbose=0, mesh=_mesh(), steps_per_dispatch=2)


def test_train_deblender_mesh_one_call():
    """The two-stage trainer over 8 shards (JAX's
    test_train_deblender_mesh_one_call): both stages finite, the stage-2
    decoder frozen, the states on the mesh's first device; stage 1's
    first epoch the single-device run's within rtol 1e-5."""
    x, y = _toy_data(20, seed=4)
    cfg = TrainConfig(learning_rate=1e-3, batch_size=10)
    runs = [tt.train_deblender("toy", None, 2, (x, y), (x[:10], y[:10]), (x, y), (x[:10], y[:10]), nb_of_bands=3,
                               batch_size=10, verbose=0, train_cfg=cfg, model_cfg=TINY, mesh=mesh, device="cpu")
            for mesh in (None, _mesh())]
    (hv1, _, _, _), (hv2, hd2, s2, model) = runs
    assert np.isfinite(hv2["loss"]).all() and np.isfinite(hd2["loss"]).all()
    assert {k for k, v in s2.labels.items() if v == "frozen"} == {k for k in s2.labels if k.startswith("decoder.")}
    assert model is s2.module and s2.device == torch.device("cpu")
    for k in hv1:
        np.testing.assert_allclose(hv2[k][0], hv1[k][0], rtol=1e-5, err_msg=k)
