"""The port's single-controller mesh (parallel/) and the batch fan-out of
its serving entry points, held against the JAX package on the CPU and
against the port's own single-device route.

JAX runs on its 8 virtual CPU devices (conftest.py); the port's mesh
repeats the CPU device, so its shards run in turn.  Sizes are JAX's
(tests/test_parallel.py, tests/test_pipeline.py: the TINY model, 23 px,
3 bands).  With the same generator a mesh run and a single-device run
draw the same latent noise, so they agree to float reassociation; JAX's
sampled runs draw threefry noise, so they are compared under
``z_mode='mean'`` or with injected noise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import debvader_tpu_torch as dtt
from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae as jax_init_vae
from debvader_tpu.parallel import make_mesh as jax_make_mesh
from debvader_tpu.parallel import make_sharded_apply as jax_sharded_apply
from debvader_tpu.parallel import param_shardings as jax_param_shardings
from debvader_tpu.parallel import shard_batch as jax_shard_batch
from debvader_tpu_torch import parallel
from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.parallel import distributed
from debvader_tpu_torch.parallel import mesh as mesh_lib
from debvader_tpu_torch.parallel import sharded
from debvader_tpu_torch.weights import flatten_flax, state_dict_from_flax
from test_pipeline import _pipe_cfg, _tiny_field

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))


@functools.lru_cache(maxsize=None)
def _nets():
    jmodel = JaxVAE(JaxModelConfig(**TINY_KW))
    variables = jax.jit(lambda key: jax_init_vae(jmodel, key))(jax.random.PRNGKey(0))
    net = dtt.DeblenderVAE(ModelConfig(**TINY_KW)).eval()
    net.load_state_dict(state_dict_from_flax(flatten_flax(jax.tree_util.tree_map(np.asarray, variables)), net.cfg))
    return (jmodel, variables), net


def _mesh(n=4, model_parallel=1):
    return parallel.make_mesh(n, model_parallel=model_parallel, devices=["cpu"] * n)


def _toy(n, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 23, 23, 3))
    return (y + 0.1 * rng.normal(size=y.shape)).astype(np.float32)


# ------------------------------------------------------------ the mesh


def test_mesh_shapes_match_jax():
    """JAX's test_mesh_has_8_devices on a repeated CPU device, and its
    checks: asking for more devices than there are, or a count that
    model_parallel does not divide, is an error."""
    for kw in ({}, {"model_parallel": 2}):
        got, want = _mesh(8, **kw), jax_make_mesh(**kw)
        assert got.shape == dict(want.shape) and got.size == want.devices.size == 8
    assert _mesh(8, 2).data_devices == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="requested n_devices=4 but only 1 available"):
        parallel.make_mesh(4)
    with pytest.raises(ValueError, match="not divisible by model_parallel=3"):
        _mesh(8, 3)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        parallel.make_mesh(devices=["meta"])


def test_make_mesh_on_a_card_machine_never_falls_back(monkeypatch):
    """With one card, make_mesh(4) raises: no CPU mesh in its place; a
    card the process does not have is refused too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_lib._available() == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match=r"only 1 available \(cuda:0\)"):
        parallel.make_mesh(4)
    with pytest.raises(ValueError, match="has 1 card"):
        parallel.make_mesh(devices=["cuda:0", "cuda:1"])
    assert parallel.make_mesh(4, devices=["cuda"] * 4).flat == [torch.device("cuda", 0)] * 4


def test_rank_entries_of_this_process_build_a_mesh():
    """(rank, device) entries of this process's rank build a mesh of this
    process; an entry of another rank without an initialised process
    group raises (tests/test_torch_multiprocess.py runs the group)."""
    mesh = parallel.make_mesh(devices=[(0, "cpu"), (0, "cpu")])
    assert mesh.flat == [torch.device("cpu")] * 2 and mesh.ranks.tolist() == [[0], [0]]
    assert not mesh.spans_processes and mesh.local_shards == mesh.owned_shards == [0, 1]
    assert mesh.device == torch.device("cpu")
    parallel.require_single_process(mesh, "a route")
    with pytest.raises(ValueError, match="entry of rank 1 needs a process group"):
        parallel.make_mesh(devices=[(0, "cpu"), (1, "cpu")])


def test_distributed_is_a_no_op_on_one_process(monkeypatch):
    for key in distributed._ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize_distributed() is False
    assert distributed.is_multi_host() is False and distributed.process_index() == 0
    assert distributed.process_count() == 1 and distributed.global_devices() == [(0, torch.device("cpu"))]
    distributed.barrier()


@pytest.mark.parametrize("backend", [None, "gloo", "nccl"])
def test_initialize_distributed_backend_and_timeout(monkeypatch, backend):
    """backend= is passed as given (by default NCCL with a card, gloo
    without one; never a fall-back from one to the other), timeout= as a
    timedelta, and a 'host:port' coordinator as a tcp:// init method; an
    unknown backend raises.  (The call is recorded, not made.)"""
    import datetime

    import torch.distributed as dist

    want = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    assert distributed.initialize_distributed("localhost:1234", 2, 1, backend=backend, timeout=7.5) is True
    assert calls == [((want,), {"init_method": "tcp://localhost:1234", "timeout": datetime.timedelta(seconds=7.5),
                                "world_size": 2, "rank": 1})]
    distributed.initialize_distributed("file:///tmp/store", 2, 0, backend=backend)
    assert calls[1][1]["init_method"] == "file:///tmp/store"
    assert calls[1][1]["timeout"] == datetime.timedelta(seconds=distributed.DEFAULT_TIMEOUT_S)
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        distributed.initialize_distributed("localhost:1", 2, 0, backend="mpi")


def test_param_shardings_tp_rule_matches_jax():
    """JAX's rule on the full-size model: exactly the 2-D dense kernels of
    2^20 elements or more (the encoder head and the decoder's expansion)
    are column-sharded over 'model', the same leaves with the same
    shapes."""
    jmodel = JaxVAE(JaxModelConfig())
    shapes = jax.eval_shape(lambda k: jax_init_vae(jmodel, k), jax.random.PRNGKey(0))
    jspecs = jax_param_shardings(shapes["params"], jax_make_mesh(model_parallel=2))
    jflat = jax.tree_util.tree_leaves_with_path(shapes["params"])
    jtp = sorted(tuple(leaf.shape) for (_, leaf), s in zip(jflat, jax.tree_util.tree_leaves(jspecs))
                 if s.spec == jax.sharding.PartitionSpec(None, "model"))
    model = dtt.DeblenderVAE(ModelConfig())
    specs = parallel.param_shardings(model, _mesh(8, 2))
    params = dict(model.named_parameters())
    tp = {name for name, spec in specs.items() if spec == (None, "model")}
    assert tp == {"encoder.dense.kernel", "decoder.dense1.kernel"}
    assert sorted(tuple(params[n].shape) for n in tp) == jtp
    assert len(specs) == len(params) > len(tp)
    assert all(spec == () for name, spec in specs.items() if name not in tp)


def test_shard_variables_places_each_column_share():
    model = dtt.init_vae(dtt.DeblenderVAE(ModelConfig()), 0)
    mesh = _mesh(4, 2)
    states = parallel.shard_variables(model, mesh)
    sd = model.state_dict()
    assert len(states) == 4 and set(states[0]) == set(sd)
    for i, state in enumerate(states):
        j = i % 2
        for name in ("encoder.dense.kernel", "decoder.dense1.kernel"):
            full = sd[name]
            assert torch.equal(state[name], full[:, j * full.shape[1] // 2 : (j + 1) * full.shape[1] // 2])
        assert torch.equal(state["encoder.bn.mean"], sd["encoder.bn.mean"])
        assert torch.equal(state["decoder.dense0.kernel"], sd["decoder.dense0.kernel"])


def test_placement_helpers():
    x = torch.arange(24.0).reshape(8, 3)
    mesh = _mesh(4)
    parts = parallel.batch_sharding(x, mesh)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4 and torch.equal(torch.cat(parts), x)
    assert all(r is x for r in parallel.replicated(x, mesh))  # the shards' device is x's: no copies
    with pytest.raises(ValueError, match="does not split over 4"):
        parallel.batch_sharding(x[:7], mesh)
    net = _nets()[1]
    assert parallel.replicate_module(net, mesh) == [net] * 4


@pytest.mark.parametrize("target,blocking", [("cpu", True), ("cuda:0", False)])
def test_gather_blocks_only_into_host_memory(monkeypatch, target, blocking):
    """gather's copy onto the CPU blocks: a non-blocking copy from a card
    lands in pinned memory that torch.cat could read before it is filled.
    Onto a card the copies stay non-blocking.  (The copies are recorded,
    not made: this machine has no card.)"""
    calls = []

    def to(self, device, non_blocking=False, **kw):
        calls.append((torch.device(device), non_blocking))
        return self

    monkeypatch.setattr(torch.Tensor, "to", to)
    pieces = [torch.arange(3.0), torch.arange(3.0, 5.0)]
    assert torch.equal(sharded.gather(pieces, target), torch.arange(5.0))
    assert calls == [(torch.device(target), not blocking)] * 2


# ----------------------------------------------------- the batch fan-out


def test_sharded_apply_matches_jax_and_single_device():
    """make_sharded_apply / sharded_forward: under 'mean' JAX's sharded
    fan-out's locs (tests/test_parallel.py's test_sharded_inference_fanout,
    32 stamps on 8 shards); under 'sample' with one seeded generator the
    single-device forward's numbers, also for an odd batch that is padded
    to the data axis."""
    jnet, net = _nets()
    x = _toy(32)
    jmesh = jax_make_mesh()
    want = jax_sharded_apply(jnet[0], jmesh, z_mode="mean")(jnet[1], jax_shard_batch(jnp.asarray(x), jmesh))
    apply = parallel.make_sharded_apply(net, _mesh(8), z_mode="mean")
    got = apply(torch.from_numpy(x))
    assert tuple(got.loc.shape) == (32, 23, 23, 3)
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-5, atol=1e-6)
    for n in (32, 5):
        xs = torch.from_numpy(x[:n])
        single = dtt.api.deblend_tensor(net, xs, True, torch.Generator().manual_seed(3), "sample")
        mesh = _mesh(4)
        sharded = parallel.sharded_forward(parallel.make_sharded_apply(net, mesh), xs, mesh, normalise=True,
                                           generator=torch.Generator().manual_seed(3))
        np.testing.assert_allclose(sharded.loc.numpy(), single.loc.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sharded.scale.numpy(), single.scale.numpy(), rtol=1e-5, atol=1e-6)


def test_deblend_samples_on_a_mesh_match_single_device():
    """deblend_samples / deblend_sample_stats with mesh=: the tiled
    (replica, source) batch through the sharded forward, with the
    single-device draws (one generator, or injected noise)."""
    net = _nets()[1]
    x = _toy(3, seed=4)
    x[0, 2, 2, 1] = np.nan
    eps = np.random.default_rng(5).normal(size=(5, 3, 4)).astype(np.float32)
    mesh = _mesh(4)
    for kw in ({"eps": eps}, {"generator": "seeded"}):
        runs = []
        for m in (None, mesh):
            k = dict(kw)
            if "generator" in k:
                k["generator"] = torch.Generator().manual_seed(7)
            runs.append((dtt.deblend_samples(net, x, 5, normalise=True, max_chunk=6, device="cpu", mesh=m, **k),))
            if "generator" in k:
                k["generator"] = torch.Generator().manual_seed(7)
            runs[-1] += dtt.deblend_sample_stats(net, x, 5, normalise=True, max_chunk=6, device="cpu", mesh=m, **k)
        for a, b in zip(*runs):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)
        assert runs[0][0].shape == (5, 3, 23, 23, 3) and runs[0][2].max() > 0


def _field_pair(mesh=None, **kw):
    (jnet, net), (field, centers) = _nets(), _tiny_field()
    return dtt.DeblendField(net, field, cutout_size=23, nb_of_bands=3, cfg=dtt.PipelineConfig(
        cutout_size=23, nb_of_bands=3, epistemic_samples=8), mesh=mesh, device="cpu", **kw), centers


@pytest.mark.parametrize("z_mode", ["sample", "mean"])
def test_deblend_field_on_a_mesh_matches_single_device(z_mode):
    """DeblendField(mesh=) on both routes (JAX's
    test_deblend_field_mesh_sharded): the record array's stamps and the
    streaming route's catalogue and residual equal the single-device run's
    for the same generator, epistemic replicas included (they sample under
    z_mode='mean' too: JAX's test_mesh_epistemic_samples_under_z_mode_mean)."""
    runs = []
    for mesh in (None, _mesh(4)):
        df, centers = _field_pair(mesh, z_mode=z_mode, epistemic_uncertainty_estimation=True,
                                  generator=torch.Generator().manual_seed(11))
        res = df.deblend_field(centers)
        residual = df.get_residual_field()
        cat, stream_residual = df.deblend_and_render(centers)
        runs.append((res, residual, cat, stream_residual))
    (r0, f0, c0, s0), (r1, f1, c1, s1) = runs
    assert len(r1) == 3
    for col in ("output_images_mean", "output_images_stddev", "epistemic_uncertainty"):
        np.testing.assert_allclose(np.stack(list(r1[col])), np.stack(list(r0[col])), rtol=1e-5, atol=1e-6)
    assert np.stack(list(r1.epistemic_uncertainty)).max() > 0
    np.testing.assert_allclose(f1, f0, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(c1.list_idx, c0.list_idx)
    np.testing.assert_allclose(c1.mse_center, c0.mse_center, rtol=1e-4)
    np.testing.assert_allclose(c1.epistemic_norm, c0.epistemic_norm, rtol=1e-4)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-5)


def test_deblend_field_on_a_mesh_matches_jax_under_mean():
    """The mesh's streaming route against JAX's DeblendField(mesh=) on its
    8 devices, z_mode='mean'."""
    import debvader_tpu as dt

    jnet, _ = _nets()
    field, centers = _tiny_field()
    jdf = dt.DeblendField(jnet, field, cutout_size=23, nb_of_bands=3, cfg=_pipe_cfg(), mesh=jax_make_mesh(),
                          z_mode="mean")
    jc, jr = jdf.deblend_and_render(centers)
    df, _ = _field_pair(_mesh(8), z_mode="mean")
    tc, tr = df.deblend_and_render(centers)
    np.testing.assert_array_equal(tc.list_idx, jc.list_idx)
    np.testing.assert_allclose(tc.mse_center, jc.mse_center, rtol=1e-4)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=2e-5)


def test_artifact_stays_exclusive_with_a_mesh():
    with pytest.raises(ValueError, match="mutually exclusive"):
        _field_pair(_mesh(2), artifact=lambda x, g: (x, x))
