"""The port's mesh across processes (parallel/, training/train.py mesh=):
two ranks on a gloo process group, each with two shards of the CPU, held
bit for bit against the port's single-process mesh of the same shape, and
against the JAX package's own run of two processes with two virtual CPU
devices each.

One module fixture starts every process once, together: this file run as
a worker (``python tests/test_torch_multiprocess.py port|fail|jax ...``)
for the port's two ranks, for a pair whose rank 1 raises, and for the
JAX package's two processes.  Each worker runs its scenarios and writes
its results to an ``.npz`` (and its messages to a ``.json``); every
process group has a timeout and every worker a wall limit, and a worker
that fails fails the tests that read it.

The JAX package's noise is replayed into the port through
``training/train._latent_noise`` as tests/test_torch_mesh_training.py
does: the test process draws it from JAX's keys and hands it to the port's
workers in a file.  Layout moves the last bits of JAX's own runs and Adam
amplifies them (JAX's two-process history drifts from its one-process
history of the same mesh shape after the first epoch), so the port is
held to JAX at a first step and a first epoch only.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
WORKER_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
# the failing pair's group timeout: a rank whose peer died fails within it
FAIL_TIMEOUT_S = 10
LR = 1e-3
# a kernel of the tiny model's two dense layers (288 x 14, 14 x 288) is
# tensor-parallel under this threshold, as the full model's are under 2^20
TP_MIN_ELEMENTS = 4000
# single-process meshes of the shapes the ranks form together
LAYOUTS = {
    "dp": ([(0, "cpu")] * 2 + [(1, "cpu")] * 2, 1),
    "tp_within": ([(0, "cpu"), (0, "cpu"), (1, "cpu"), (1, "cpu")], 2),
    "tp_across": ([(0, "cpu"), (1, "cpu"), (0, "cpu"), (1, "cpu")], 2),
}


def _blobs(n, seed):
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


def _state_arrays(prefix, state) -> dict:
    out = {f"{prefix}/module/{k}": v.detach().numpy().copy() for k, v in state.module.state_dict().items()}
    out.update({f"{prefix}/mu/{k}": v.numpy().copy() for k, v in state.mu.items()})
    out.update({f"{prefix}/nu/{k}": v.numpy().copy() for k, v in state.nu.items()})
    return out


def _terms(prefix, terms) -> dict:
    return {f"{prefix}/{k}": np.float32(v) for k, v in terms.items()}


def _history(prefix, hist) -> dict:
    return {f"{prefix}/{k}": np.asarray(v, np.float64) for k, v in hist.items()}


# ----------------------------------------------- the port's scenarios


def _port_scenarios(mesh_of, jax_inputs=None) -> dict:
    """Every scenario of a mesh, on one process or on each rank of two:
    ``mesh_of(layout)`` builds the mesh of a LAYOUTS entry.  Returns
    {name: array}."""
    from debvader_tpu_torch import parallel
    from debvader_tpu_torch.config import ModelConfig, TrainConfig
    from debvader_tpu_torch.models.vae import DeblenderVAE, init_vae
    from debvader_tpu_torch.parallel import mesh as mesh_lib
    from debvader_tpu_torch.training import train as tt

    tiny = ModelConfig(**TINY_KW)
    out = {}
    cfg = TrainConfig(learning_rate=LR, batch_size=16)
    x, y = (torch.from_numpy(a) for a in _blobs(16, seed=2))

    # three steps, an eval step and a weighted step on a batch of 7
    mesh = mesh_of("dp")
    step = parallel.make_sharded_train_step(mesh, cfg)
    state = parallel.create_sharded_train_state(DeblenderVAE(tiny), mesh, cfg)
    for k in range(3):
        state, t = step(state, x, y)
        out.update(_terms(f"steps/{k}", t))
    out.update(_terms("eval", parallel.make_sharded_eval_step(mesh, cfg)(state, x, y, torch.Generator().manual_seed(4))))
    w = torch.tensor([1.0, 0.0, 2.0, 1.0, 1.0, 0.5, 1.0])
    state, t = parallel.make_sharded_train_step(mesh, cfg, weighted=True)(state, x[:7], y[:7], w)
    out.update(_terms("weighted", t))
    out.update(_state_arrays("steps/state", state))

    # train_network: a batch the data axis divides, pad rows, and two steps
    # a dispatch
    xt, yt = _blobs(16, seed=1)
    xv, yv = _blobs(8, seed=3)
    for name, bs, n, spd in (("divisible", 8, 16, 1), ("pad_rows", 5, 13, 1), ("dispatch2", 4, 16, 2)):
        state = tt.create_train_state(DeblenderVAE(tiny), TrainConfig(learning_rate=LR, batch_size=bs), device="cpu")
        state, hist = tt.train_network(DeblenderVAE(tiny), state, 2, (xt[:n], yt[:n]), (xv, yv), bs, verbose=0,
                                       train_cfg=TrainConfig(learning_rate=LR, batch_size=bs), mesh=mesh_of("dp"),
                                       steps_per_dispatch=spd)
        out.update(_history(f"train_network/{name}", hist))
        out.update(_state_arrays(f"train_network/{name}/state", state))

    # tensor-parallel rows within a rank and across ranks
    threshold = mesh_lib._TP_MIN_ELEMENTS
    mesh_lib._TP_MIN_ELEMENTS = TP_MIN_ELEMENTS
    try:
        for layout in ("tp_within", "tp_across"):
            mesh = mesh_of(layout)
            step = parallel.make_sharded_train_step(mesh, cfg)
            state = parallel.create_sharded_train_state(DeblenderVAE(tiny), mesh, cfg)
            for k in range(2):
                state, t = step(state, x, y)
                out.update(_terms(f"{layout}/{k}", t))
            out.update(_terms(f"{layout}/eval", parallel.make_sharded_eval_step(mesh, cfg)(
                state, x, y, torch.Generator().manual_seed(4))))
            out.update(_state_arrays(f"{layout}/state", state))
    finally:
        mesh_lib._TP_MIN_ELEMENTS = threshold

    # the batch fan-out: each rank's own rows and their indices (not
    # denormalised: sinh and cosh over another number of rows can round
    # their vector loop's tail otherwise)
    net = init_vae(DeblenderVAE(tiny), 0).eval()
    mesh = mesh_of("dp")
    got = parallel.sharded_forward(parallel.make_sharded_apply(net, mesh, z_mode="mean"), x[:7], mesh)
    dist, index = got if mesh.spans_processes else (got, torch.arange(7))
    out.update({"apply/loc": dist.loc.numpy(), "apply/scale": dist.scale.numpy(), "apply/index": index.numpy()})

    if jax_inputs is not None:
        out.update(_port_against_jax(mesh_of, jax_inputs))
    return out


def _replayed_noise(tt, noise: dict) -> None:
    """training/train's noise taken from ``noise`` (the JAX package's
    draws): the step draws in order, a validation batch's by (epoch,
    batch)."""
    steps = iter(range(10**6))

    def draw(generator, shape, like):
        key = f"val/{generator[1]}/{generator[2]}" if isinstance(generator, tuple) else f"step/{next(steps)}"
        got = torch.from_numpy(noise[key])
        assert tuple(got.shape) == tuple(shape), (key, got.shape, shape)
        return got

    tt._latent_noise = draw
    tt._validation_generator = lambda seed, epoch, i, dev: ("val", epoch, i)


def _port_against_jax(mesh_of, inputs: dict) -> dict:
    """The first step and the first epoch from JAX's initial variables,
    with JAX's noise replayed."""
    from debvader_tpu_torch import parallel
    from debvader_tpu_torch.config import ModelConfig, TrainConfig
    from debvader_tpu_torch.models.vae import DeblenderVAE
    from debvader_tpu_torch.training import train as tt

    tiny = ModelConfig(**TINY_KW)
    variables = {k[len("var/"):]: v for k, v in inputs.items() if k.startswith("var/")}
    noise = {k[len("noise/"):]: v for k, v in inputs.items() if k.startswith("noise/")}
    saved = tt._latent_noise, tt._validation_generator
    out = {}
    try:
        _replayed_noise(tt, {k.replace("first_step/", ""): v for k, v in noise.items() if k.startswith("first_step/")})
        cfg = TrainConfig(learning_rate=LR, batch_size=16)
        mesh = mesh_of("dp")
        state = parallel.create_sharded_train_state(DeblenderVAE(tiny), mesh, cfg, variables=variables)
        x, y = (torch.from_numpy(a) for a in _blobs(16, seed=2))
        state, t = parallel.make_sharded_train_step(mesh, cfg)(state, x, y)
        out.update(_terms("jax_first_step", t))
        out.update({f"jax_first_step/var/{k}": v for k, v in state.variables().items()})
        _replayed_noise(tt, {k.replace("epoch/", ""): v for k, v in noise.items() if k.startswith("epoch/")})
        cfg = TrainConfig(learning_rate=LR, batch_size=8)
        state = tt.create_train_state(DeblenderVAE(tiny), cfg, variables=variables, device="cpu")
        xt, yt = _blobs(16, seed=1)
        xv, yv = _blobs(8, seed=3)
        _, hist = tt.train_network(DeblenderVAE(tiny), state, 1, (xt, yt), (xv, yv), 8, verbose=0, train_cfg=cfg,
                                   mesh=mesh_of("dp"))
        out.update(_history("jax_epoch", hist))
    finally:
        tt._latent_noise, tt._validation_generator = saved
    return out


def _cross_process_only(rank: int, out_dir: Path) -> tuple[dict, dict]:
    """What only a mesh across processes shows: the global device table,
    the collectives, each serving route's refusal, and rank 0 alone
    writing the checkpoints and the metrics log."""
    from debvader_tpu_torch import parallel
    from debvader_tpu_torch.config import ModelConfig, TrainConfig
    from debvader_tpu_torch.models.vae import DeblenderVAE
    from debvader_tpu_torch.training import checkpoint as ckpt
    from debvader_tpu_torch.training import train as tt

    arrays, messages = {}, {}
    table = parallel.global_devices()
    default = parallel.make_mesh()
    messages["global_devices"] = [[r, str(d)] for r, d in table]
    messages["default_mesh"] = {"shape": default.shape, "ranks": default.ranks.reshape(-1).tolist(),
                                "devices": [str(d) for d in default.flat], "spans": default.spans_processes,
                                "process_count": parallel.process_count()}
    mesh = parallel.make_mesh(devices=LAYOUTS["dp"][0])
    messages["dp_mesh"] = {"local_shards": mesh.local_shards, "owned_shards": mesh.owned_shards,
                           "owners": [mesh.owner(i) for i in range(4)]}
    mine = {i: torch.full((3,), float(10 * i + rank), dtype=torch.float32) for i in mesh.local_shards}
    arrays["collectives/all_gather"] = torch.stack(parallel.all_gather(mine, mesh, "cpu")).numpy()
    arrays["collectives/psum"] = parallel.psum({i: [t, t[:1] * 2] for i, t in mine.items()}, mesh, "cpu")[0].numpy()
    arrays["collectives/broadcast"] = parallel.broadcast(torch.full((2,), float(rank + 5)), mesh, src=1).numpy()

    # each serving route refuses the mesh
    import debvader_tpu_torch as dtt
    from debvader_tpu_torch.models.quantized import make_sharded_quantized_forward
    from debvader_tpu_torch.ops.detection import detect_sources_batched

    tiny = ModelConfig(**TINY_KW)
    net = DeblenderVAE(tiny).eval()
    field = np.zeros((1, 64, 64, 3), np.float32)
    routes = {
        "DeblendField": lambda: dtt.DeblendField(net, field, cutout_size=23, nb_of_bands=3, mesh=mesh, device="cpu"),
        "deblend_samples": lambda: dtt.deblend_samples(net, _blobs(2, 0)[0], 2, device="cpu", mesh=mesh),
        "make_sharded_quantized_forward": lambda: make_sharded_quantized_forward(None, mesh),
        "detect_sources_batched": lambda: detect_sources_batched(np.zeros((4, 32, 32), np.float32), mesh=mesh,
                                                                 device="cpu"),
        "ShardedFieldDeblender": lambda: dtt.ShardedFieldDeblender(net, field, mesh, cutout_size=23, nb_of_bands=3),
    }
    for name, route in routes.items():
        try:
            route()
        except ValueError as e:
            messages[f"refused/{name}"] = str(e)

    # rank 0 alone writes the checkpoints and the metrics log
    cfg = TrainConfig(learning_rate=LR, batch_size=8)
    state = tt.create_train_state(DeblenderVAE(tiny), cfg, device="cpu")
    xt, yt = _blobs(16, seed=1)
    base = out_dir / f"written_by_rank{rank}"
    base.mkdir()
    tt.train_network(DeblenderVAE(tiny), state, 1, (xt, yt), (xt[:8], yt[:8]), 8, verbose=0, train_cfg=cfg,
                     mesh=mesh, callbacks=ckpt.define_callbacks("vae", "toy", weights_dir=base),
                     metrics_log=base / "metrics.jsonl")
    messages["written"] = sorted(str(p.relative_to(base)) for p in base.rglob("*") if p.is_file())
    return arrays, messages


# ------------------------------------------------------------- fixtures


def _jax_inputs() -> dict:
    """JAX's initial variables of the tiny model and its noise for the
    first step and the first epoch, as its train state's key draws them
    (tests/test_torch_training.py's ``_replay``)."""
    import jax

    from debvader_tpu.config import ModelConfig as JaxModelConfig
    from debvader_tpu.config import TrainConfig as JaxTrainConfig
    from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
    from debvader_tpu.models.vae import init_vae as jax_init_vae
    from debvader_tpu.training import train as jtrain
    from debvader_tpu_torch.weights import flatten_flax

    jcfg = JaxModelConfig(**TINY_KW)
    init = jax.jit(lambda key: jax_init_vae(JaxVAE(jcfg), key))(jax.random.split(jax.random.PRNGKey(0))[0])
    jstate = jtrain.create_train_state(JaxVAE(jcfg), JaxTrainConfig(learning_rate=LR), rng=jax.random.PRNGKey(0),
                                       variables=init)
    out = {f"var/{k}": v for k, v in flatten_flax({"params": jax.device_get(jstate.params),
                                                    "batch_stats": jax.device_get(jstate.batch_stats)}).items()}
    latent = TINY_KW["latent_dim"]
    for prefix, steps, val in (("first_step", [16], []), ("epoch", [8, 8], [(0, 0, 8)])):
        chain = jstate.rng
        for k, n in enumerate(steps):
            key, chain = jax.random.split(chain)
            out[f"noise/{prefix}/step/{k}"] = np.asarray(jax.random.normal(key, (n, latent)))
        for epoch, i, n in val:
            key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), epoch), i)
            out[f"noise/{prefix}/val/{epoch}/{i}"] = np.asarray(jax.random.normal(key, (n, latent)))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker, started together, and the port's single-process
    meshes of the same shapes run here meanwhile."""
    from debvader_tpu_torch import parallel

    out = tmp_path_factory.mktemp("multiprocess")
    inputs = _jax_inputs()
    np.savez(out / "jax_inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parents[1]), os.environ.get("PYTHONPATH", "")]))
    jax_port = _free_port()
    plan = [("port", r, f"file://{out / 'store_port'}") for r in (0, 1)]
    plan += [("fail", r, f"file://{out / 'store_fail'}") for r in (0, 1)]
    plan += [("jax", r, str(jax_port)) for r in (0, 1)]
    t0 = time.monotonic()
    procs = {}
    for mode, rank, rendezvous in plan:
        log = open(out / f"{mode}_rank{rank}.log", "w")
        procs[(mode, rank)] = (subprocess.Popen([sys.executable, __file__, mode, str(rank), rendezvous, str(out)],
                                                env=env, stdout=log, stderr=subprocess.STDOUT), log)
    try:
        reference = _port_scenarios(lambda layout: parallel.make_mesh(devices=["cpu"] * 4,
                                                                      model_parallel=LAYOUTS[layout][1]), inputs)
        rcs, seconds = {}, {}
        for key, (proc, log) in procs.items():
            try:
                rcs[key] = proc.wait(timeout=max(WORKER_TIMEOUT_S - (time.monotonic() - t0), 1))
            except subprocess.TimeoutExpired:
                rcs[key] = None  # killed below
            seconds[key] = time.monotonic() - t0
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()
    logs = {key: (out / f"{key[0]}_rank{key[1]}.log").read_text() for key in procs}

    def results(mode):
        for rank in (0, 1):
            assert rcs[(mode, rank)] == 0, f"{mode} rank {rank} exited {rcs[(mode, rank)]}:\n{logs[(mode, rank)][-4000:]}"
        arrays = []
        for rank in (0, 1):
            with np.load(out / f"{mode}_rank{rank}.npz") as z:
                arrays.append({k: z[k] for k in z.files})
        return arrays, [json.loads((out / f"{mode}_rank{rank}.json").read_text()) for rank in (0, 1)]

    return {"reference": reference, "rcs": rcs, "seconds": seconds, "logs": logs, "out": out, "results": results}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize]) if a.dtype.kind == "f" else a


GROUPS = ["steps/0", "steps/1", "steps/2", "eval", "weighted", "steps/state", "train_network/divisible",
          "train_network/pad_rows", "train_network/dispatch2", "tp_within", "tp_across"]


@pytest.mark.parametrize("group", GROUPS)
def test_two_ranks_are_the_single_process_mesh_bit_for_bit(runs, group):
    """Each scenario's terms, histories, parameters, BatchNorm statistics
    and Adam moments on both ranks, bit for bit the single-process mesh of
    the same shape: three steps, the eval step, a weighted step on a batch
    of 7 (pad rows), train_network at a batch the data axis divides, with
    pad rows and at two steps a dispatch, and the tensor-parallel (2, 2)
    meshes whose model rows lie within a rank and span the ranks."""
    (r0, r1), _ = runs["results"]("port")
    ref = runs["reference"]
    keys = [k for k in ref if k == group or k.startswith(group + "/")]
    assert len(keys) >= 3
    for k in keys:
        assert np.array_equal(_bits(r0[k]), _bits(ref[k])), k
        assert np.array_equal(_bits(r1[k]), _bits(r0[k])), k
    if group.startswith("train_network"):
        assert np.isfinite(ref[f"{group}/loss"]).all() and len(ref[f"{group}/loss"]) == 2


def test_batch_fanout_gives_each_rank_its_rows(runs):
    """make_sharded_apply / sharded_forward on the mesh across processes:
    each rank gets the rows of the shards it owns (7 rows padded to 8,
    two a shard; the pad row dropped) and their indices, bit for bit those
    rows of the single-process mesh's output."""
    (r0, r1), _ = runs["results"]("port")
    ref = runs["reference"]
    assert r0["apply/index"].tolist() == [0, 1, 2, 3] and r1["apply/index"].tolist() == [4, 5, 6]
    for r in (r0, r1):
        for k in ("loc", "scale"):
            assert np.array_equal(_bits(r[f"apply/{k}"]), _bits(ref[f"apply/{k}"][r["apply/index"]]))


def test_against_jax_two_processes(runs):
    """The port's two ranks against the JAX package's two processes of two
    virtual devices each, from JAX's initial variables with its noise
    replayed: the first step's terms within rtol 1e-4 and the parameters
    after it within atol 2e-4 (Adam's sign flips counted, as
    tests/test_torch_mesh_training.py counts them), the first epoch's
    history within rtol 1e-4; JAX's two processes agree with each other."""
    from test_torch_mesh_training import _params_close

    (p0, p1), _ = runs["results"]("port")
    (j0, j1), jmsg = runs["results"]("jax")
    assert jmsg[0]["mesh_shape"] == {"data": 4, "model": 1} and jmsg[0]["process_count"] == 2
    for k in j0:
        np.testing.assert_array_equal(j1[k], j0[k], err_msg=k)
    for k in ("nll", "kl", "loss", "mse"):
        np.testing.assert_allclose(p0[f"jax_first_step/{k}"], j0[f"jax_first_step/{k}"], rtol=1e-4, err_msg=k)
    got = {k[len("jax_first_step/var/"):]: v for k, v in p0.items() if k.startswith("jax_first_step/var/")}
    want = {k[len("jax_first_step/var/"):]: v for k, v in j0.items() if k.startswith("jax_first_step/var/")}
    assert set(got) == set(want)
    _params_close(got, want, 2e-4, lr=LR)
    hist = [k for k in j0 if k.startswith("jax_epoch/")]
    assert len(hist) == 8
    for k in hist:
        np.testing.assert_allclose(p0[k], j0[k], rtol=1e-4, err_msg=k)
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)


def test_serving_routes_refuse_a_mesh_across_processes(runs):
    """Every serving route raises ValueError on the mesh across processes,
    saying that it reads its results on the host; the JAX package's routes
    fail there too, on reading make_sharded_apply's output."""
    _, msgs = runs["results"]("port")
    _, jmsgs = runs["results"]("jax")
    for name in ("DeblendField", "deblend_samples", "make_sharded_quantized_forward", "detect_sources_batched",
                 "ShardedFieldDeblender"):
        for m in msgs:
            assert "reads its results on the host" in m.get(f"refused/{name}", ""), (name, m)
    for m in jmsgs:
        assert "non-addressable" in m["fetch_error"], m


def test_a_failing_rank_fails_the_group(runs):
    """Rank 1 raises once the group is up: rank 0, inside a step's
    reduction, fails too (exit code not 0) well inside the workers' wall
    limit instead of waiting on its peer."""
    for rank in (0, 1):
        assert runs["rcs"][("fail", rank)] not in (0, None), runs["logs"][("fail", rank)][-2000:]
        assert runs["seconds"][("fail", rank)] < WORKER_TIMEOUT_S
    assert "fails on purpose" in runs["logs"][("fail", 1)]
    assert not (runs["out"] / "fail_rank0_finished").exists()


def test_only_rank0_writes_checkpoints_and_metrics(runs):
    _, msgs = runs["results"]("port")
    assert msgs[0]["written"] == ["metrics.jsonl", "toy/vae/val_loss/ckpt.npz", "toy/vae/val_mse/ckpt.npz"]
    assert msgs[1]["written"] == []


def test_make_mesh_over_the_global_device_table(runs):
    """After initialisation the device table is every rank's devices in
    rank order and make_mesh() spans it; each rank computes and owns its
    own shards; all_gather, psum and broadcast across the ranks."""
    (r0, r1), msgs = runs["results"]("port")
    for rank, m in enumerate(msgs):
        assert m["global_devices"] == [[0, "cpu"], [1, "cpu"]]
        assert m["default_mesh"] == {"shape": {"data": 2, "model": 1}, "ranks": [0, 1], "devices": ["cpu", "cpu"],
                                     "spans": True, "process_count": 2}
        assert m["dp_mesh"] == {"local_shards": [2 * rank, 2 * rank + 1], "owned_shards": [2 * rank, 2 * rank + 1],
                                "owners": [0, 0, 1, 1]}
    want = np.array([[0.0] * 3, [10.0] * 3, [21.0] * 3, [31.0] * 3], np.float32)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["collectives/all_gather"], want)
        np.testing.assert_array_equal(r["collectives/psum"], want.sum(0))
        np.testing.assert_array_equal(r["collectives/broadcast"], [6.0, 6.0])


# ------------------------------------------------------------ workers


def _port_worker(rank: int, store: str, out_dir: Path) -> None:
    from debvader_tpu_torch import parallel

    parallel.initialize_distributed(store, 2, rank, backend="gloo", timeout=GROUP_TIMEOUT_S)
    with np.load(out_dir / "jax_inputs.npz") as z:
        jax_inputs = {k: z[k] for k in z.files}
    results = _port_scenarios(lambda layout: parallel.make_mesh(devices=LAYOUTS[layout][0],
                                                                model_parallel=LAYOUTS[layout][1]), jax_inputs)
    arrays, messages = _cross_process_only(rank, out_dir)
    results.update(arrays)
    np.savez(out_dir / f"port_rank{rank}.npz", **results)
    (out_dir / f"port_rank{rank}.json").write_text(json.dumps(messages))
    parallel.barrier()
    torch.distributed.destroy_process_group()


def _fail_worker(rank: int, store: str, out_dir: Path) -> None:
    """Rank 1 raises once the group is up; rank 0 goes on into a step's
    reduction, which must fail, not wait for ever."""
    from debvader_tpu_torch import parallel
    from debvader_tpu_torch.config import ModelConfig, TrainConfig
    from debvader_tpu_torch.models.vae import DeblenderVAE

    parallel.initialize_distributed(store, 2, rank, backend="gloo", timeout=FAIL_TIMEOUT_S)
    mesh = parallel.make_mesh(devices=LAYOUTS["dp"][0])
    parallel.barrier()
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    cfg = TrainConfig(learning_rate=LR, batch_size=16)
    state = parallel.create_sharded_train_state(DeblenderVAE(ModelConfig(**TINY_KW)), mesh, cfg)
    x, y = (torch.from_numpy(a) for a in _blobs(16, seed=2))
    parallel.make_sharded_train_step(mesh, cfg)(state, x, y)
    (out_dir / "fail_rank0_finished").write_text("the step returned")


def _jax_worker(rank: int, port: str, out_dir: Path) -> None:
    """The JAX package's own run on two processes with two virtual CPU
    devices each: the first step, the first epoch, and reading the
    sharded fan-out's output."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import jax.numpy as jnp

    from debvader_tpu.config import ModelConfig as JaxModelConfig
    from debvader_tpu.config import TrainConfig as JaxTrainConfig
    from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
    from debvader_tpu.models.vae import init_vae as jax_init_vae
    from debvader_tpu.parallel import make_mesh, make_sharded_apply, make_sharded_train_step, shard_batch
    from debvader_tpu.parallel import shard_train_state
    from debvader_tpu.parallel.distributed import initialize_distributed
    from debvader_tpu.training import train as jtrain
    from debvader_tpu_torch.weights import flatten_flax

    initialize_distributed(f"localhost:{port}", 2, rank)
    mesh = make_mesh()
    jcfg = JaxModelConfig(**TINY_KW)
    init = jax.jit(lambda key: jax_init_vae(JaxVAE(jcfg), key))(jax.random.split(jax.random.PRNGKey(0))[0])
    out, messages = {}, {"mesh_shape": dict(mesh.shape), "process_count": jax.process_count()}

    def flat(state):
        return flatten_flax({"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)})

    tcfg = JaxTrainConfig(learning_rate=LR, batch_size=16)
    jstate = jtrain.create_train_state(JaxVAE(jcfg), tcfg, rng=jax.random.PRNGKey(0), variables=init)
    step = make_sharded_train_step(JaxVAE(jcfg), mesh, tcfg, donate=False)
    x, y = _blobs(16, seed=2)
    js, t = step(shard_train_state(jstate, mesh), shard_batch(jnp.asarray(x), mesh), shard_batch(jnp.asarray(y), mesh))
    out.update({f"jax_first_step/{k}": np.float32(v) for k, v in t.items()})
    out.update({f"jax_first_step/var/{k}": v for k, v in flat(js).items()})

    tcfg = JaxTrainConfig(learning_rate=LR, batch_size=8)
    jstate = jtrain.create_train_state(JaxVAE(jcfg), tcfg, rng=jax.random.PRNGKey(0), variables=init)
    xt, yt = _blobs(16, seed=1)
    xv, yv = _blobs(8, seed=3)
    _, hist = jtrain.train_network(JaxVAE(jcfg), jstate, 1, (xt, yt), (xv, yv), 8, verbose=0, train_cfg=tcfg,
                                   mesh=mesh)
    out.update({f"jax_epoch/{k}": np.asarray(v, np.float64) for k, v in hist.items()})

    fan = make_sharded_apply(JaxVAE(jcfg), mesh, z_mode="mean")(init, shard_batch(jnp.asarray(x), mesh))
    try:
        np.asarray(fan.loc)
    except RuntimeError as e:
        messages["fetch_error"] = str(e)
    np.savez(out_dir / f"jax_rank{rank}.npz", **out)
    (out_dir / f"jax_rank{rank}.json").write_text(json.dumps(messages))


def _main(argv) -> int:
    mode, rank, rendezvous, out_dir = argv[0], int(argv[1]), argv[2], Path(argv[3])
    torch.set_num_threads(1)
    {"port": _port_worker, "fail": _fail_worker, "jax": _jax_worker}[mode](rank, rendezvous, out_dir)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(_main(sys.argv[1:]))
