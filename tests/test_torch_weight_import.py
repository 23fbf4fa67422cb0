"""The port's reference-checkpoint import (debvader_tpu_torch/utils/
tf_checkpoint.py, weight_import.py, parity.py and the CLI's
``import-weights``) held against the JAX package's on the CPU.

No test here reads the reference's files: every checkpoint is a real
TensorBundle that ``tf_checkpoint.write_bundle`` writes from
``export_to_tensors`` of JAX variables (an SSTable index with the header
entry, prefix-compressed keys with a restart every 16, several data
blocks, masked CRC32C trailers, footer and magic; ``.data-0000S-of-0000N``
shards).  Readers, name maps and imports are held bit for bit; the
imported forward against JAX's within ``FWD_TOL`` (float32 summation
order of two frameworks)."""

import dataclasses
import functools
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debvader_tpu.config import ModelConfig as JaxModelConfig
from debvader_tpu.models.vae import DeblenderVAE as JaxVAE
from debvader_tpu.models.vae import init_vae as jax_init_vae
from debvader_tpu.utils import parity as jparity
from debvader_tpu.utils import tf_checkpoint as jtf
from debvader_tpu.utils import weight_import as jwi

from debvader_tpu_torch.cli import main
from debvader_tpu_torch.config import ModelConfig
from debvader_tpu_torch.utils import parity as tparity
from debvader_tpu_torch.utils import tf_checkpoint as ttf
from debvader_tpu_torch.utils import weight_import as twi
from debvader_tpu_torch.weights import flatten_flax, load_deblender, load_flax_npz, state_dict_from_flax

torch.set_num_threads(1)

TINY_KW = dict(stamp_size=23, nb_of_bands=3, latent_dim=8, filters=(8, 16), kernels=(3, 3))
FWD_TOL = 2e-5
# the one tensor stored as bfloat16 (an encoder conv kernel)
BF16_KEY = "layer_with_weights-0/layer_with_weights-1/kernel/.ATTRIBUTES/VARIABLE_VALUE"


@functools.lru_cache(maxsize=None)
def _variables(tiny: bool):
    """JAX variables from PRNGKey(0) (jitted init: the same values as
    eager), the BatchNorm statistics moved off their init so that every
    tensor is distinct."""
    cfg = JaxModelConfig(**TINY_KW) if tiny else JaxModelConfig()
    v = jax.jit(lambda key: jax_init_vae(JaxVAE(cfg), key))(jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, v)
    bn = v["batch_stats"]["encoder"]["BatchNorm_0"]
    rng = np.random.default_rng(1)
    bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return cfg, v


def _write(tmp_path, tiny=True, shards=1, bf16=(), extra=None):
    cfg, v = _variables(tiny)
    tensors = dict(jwi.export_to_tensors(v, cfg))
    tensors.update(extra or {})
    prefix = tmp_path / "weights.ckpt"
    ttf.write_bundle(prefix, tensors, shards=shards, bfloat16=bf16)
    return prefix, cfg, v


def _entries_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert dataclasses.astuple(a[k]) == dataclasses.astuple(b[k]), k


def _index_blocks(prefix) -> int:
    """The number of data blocks the index file's index block lists."""
    data = (prefix.parent / (prefix.name + ".index")).read_bytes()
    footer = data[-48:]
    _, _, pos = ttf._read_handle(footer, 0)
    off, size, _ = ttf._read_handle(footer, pos)
    return sum(1 for _ in ttf._iter_block_entries(ttf._read_block(data, off, size)))


@pytest.mark.parametrize("tiny, shards", [(True, 1), (False, 3)], ids=["tiny_1_shard", "full_3_shards"])
def test_bundle_reader_matches_jax(tmp_path, tiny, shards):
    """The port's read_index and load_available_tensors give JAX's
    entries and arrays, bit for bit: int8, int32 and float64 extras beside
    the float32 weights, one bfloat16 tensor widened, keys
    prefix-compressed with a restart every 16 (the full model's index
    spans several data blocks)."""
    extra = {"optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE": np.array(7, np.int64),
             "save_counter/.ATTRIBUTES/VARIABLE_VALUE": np.arange(6, dtype=np.int32).reshape(2, 3),
             "z/int8": np.arange(-5, 5, dtype=np.int8), "z/f64": np.linspace(0, 1, 4)}
    prefix, cfg, v = _write(tmp_path, tiny, shards, bf16=(BF16_KEY,), extra=extra)
    je, te = jtf.read_index(str(prefix) + ".index"), ttf.read_index(str(prefix) + ".index")
    _entries_equal(je, te)
    assert len(te) == len(jwi.keras_name_map(cfg)) + len(extra)
    assert {e.shard_id for e in te.values()} == set(range(shards))
    assert te[BF16_KEY].dtype == 14
    if not tiny:
        assert _index_blocks(prefix) > 1
    ja, ta = jtf.load_available_tensors(prefix), ttf.load_available_tensors(prefix)
    assert list(ja) == list(ta)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].shape == ja[k].shape, k
        np.testing.assert_array_equal(ta[k].view(np.uint8), ja[k].view(np.uint8), err_msg=k)
    # the bfloat16 tensor is the float32 one rounded to nearest even
    want = np.asarray(jnp.asarray(jwi.export_to_tensors(v, cfg)[BF16_KEY]).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(ta[BF16_KEY], want)
    assert not np.array_equal(ta[BF16_KEY], jwi.export_to_tensors(v, cfg)[BF16_KEY])


def test_bf16_tensor_decodes_by_widening(tmp_path):
    """JAX's test_bf16_tensor_decodes_by_widening on the port's reader."""
    want = np.array([1.5, -2.0, 0.0, 3.25], np.float32)
    bf16_bits = (want.view(np.uint32) >> 16).astype("<u2")
    (tmp_path / "w.ckpt.data-00000-of-00001").write_bytes(bf16_bits.tobytes())
    entries = {"t": ttf.BundleEntry(dtype=14, shape=(4,), shard_id=0, offset=0, size=8)}
    got = ttf.read_tensor(tmp_path / "w.ckpt", "t", entries)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_keras_name_map_and_export_match_jax(tiny):
    """keras_name_map equals JAX's; export_to_tensors of the nested tree
    and of its flat key-path dict equal JAX's export, and import inverts
    it (JAX's test_export_import_roundtrip and test_import_applies_values
    on the port)."""
    cfg, v = _variables(tiny)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    assert twi.keras_name_map(tcfg) == jwi.keras_name_map(cfg)
    want = jwi.export_to_tensors(v, cfg)
    for src in (v, flatten_flax(v)):
        got = twi.export_to_tensors(src, tcfg)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    back = twi.import_from_tensors({k: a + 1.0 for k, a in want.items()}, tcfg)
    assert flatten_flax(back).keys() == flatten_flax(v).keys()
    for path, a in flatten_flax(v).items():
        np.testing.assert_array_equal(flatten_flax(back)[path], a + 1.0)


def test_import_reference_checkpoint_matches_jax(tmp_path):
    """The port's import_reference_checkpoint is exactly the state dict of
    the JAX variables the bundle was written from; with a bfloat16 tensor
    in it, exactly the state dict of JAX's import of the same bundle."""
    prefix, cfg, v = _write(tmp_path, tiny=True, shards=2)
    tcfg = ModelConfig(**TINY_KW)
    got = twi.import_reference_checkpoint(str(prefix), tcfg)
    want = state_dict_from_flax(flatten_flax(v), tcfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    other = tmp_path / "bf16"
    other.mkdir()
    prefix, _, _ = _write(other, tiny=True, shards=2, bf16=(BF16_KEY,))
    got = twi.import_reference_checkpoint(str(prefix), tcfg)
    want = state_dict_from_flax(flatten_flax(jwi.import_reference_checkpoint(str(prefix), cfg)), tcfg)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert not torch.equal(got["encoder.convs.0.weight"], state_dict_from_flax(flatten_flax(v), tcfg)[
        "encoder.convs.0.weight"])


def test_import_weights_cli_serves_the_checkpoint(tmp_path):
    """import-weights (the default architecture, as the JAX CLI's) writes
    a weights file that load_deblender serves: its forward within FWD_TOL
    of JAX's forward of the same variables, and bit for bit the port's
    forward of those variables."""
    prefix, cfg, v = _write(tmp_path, tiny=False, shards=3)
    assert main(["import-weights", "--ckpt", str(prefix), "--out", str(tmp_path / "imported")]) == 0
    tcfg = ModelConfig()
    flat = load_flax_npz(tmp_path / "imported.npz")
    assert flat.keys() == flatten_flax(v).keys()
    net = load_deblender("imported", device="cpu", weights_dir=tmp_path)
    x = np.abs(np.random.default_rng(3).normal(size=(3, 59, 59, 6))).astype(np.float32)
    with torch.no_grad():
        loc = net(torch.from_numpy(x), z_mode="mean")[0].loc.numpy()
    jloc = np.asarray(JaxVAE(cfg).apply(v, jnp.asarray(x), z_mode="mean")[0].loc)
    err = float(np.abs(loc - jloc).max())
    print(f"imported forward against JAX's: {err} (scale {float(np.abs(jloc).max())})")
    assert err <= FWD_TOL
    from debvader_tpu_torch.models.vae import DeblenderVAE

    ref = DeblenderVAE(tcfg)
    ref.load_state_dict(state_dict_from_flax(flatten_flax(v), tcfg))
    with torch.no_grad():
        np.testing.assert_array_equal(ref.eval()(torch.from_numpy(x), z_mode="mean")[0].loc.numpy(), loc)


def test_partial_snapshot_loads_the_shards_present(tmp_path):
    """JAX's test_partial_snapshot_loads_shard0_only on a 3-shard bundle
    with shard 1 deleted: both packages load the same subset, strict
    imports raise KeyError, and import-weights --partial writes the subset
    (without --partial it raises)."""
    prefix, cfg, v = _write(tmp_path, tiny=False, shards=3)
    (tmp_path / "weights.ckpt.data-00001-of-00003").unlink()
    ja, ta = jtf.load_available_tensors(prefix), ttf.load_available_tensors(prefix)
    assert list(ja) == list(ta) and 0 < len(ta) < len(jwi.keras_name_map(cfg))
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])
    tcfg = ModelConfig()
    with pytest.raises(KeyError):
        jwi.import_from_tensors(ja, cfg, strict=True)
    with pytest.raises(KeyError):
        twi.import_from_tensors(ta, tcfg, strict=True)
    with pytest.raises(KeyError):
        twi.import_reference_checkpoint(str(prefix), tcfg)
    part = twi.import_reference_checkpoint(str(prefix), tcfg, strict=False)
    want = state_dict_from_flax(flatten_flax(jwi.import_from_tensors(ja, cfg, strict=False)), tcfg)
    assert list(part) == list(want) and 0 < len(part)
    with pytest.raises(KeyError):
        main(["import-weights", "--ckpt", str(prefix), "--out", str(tmp_path / "w")])
    assert main(["import-weights", "--ckpt", str(prefix), "--out", str(tmp_path / "w"), "--partial"]) == 0
    assert len(load_flax_npz(tmp_path / "w.npz")) == len(part)


def test_bad_magic_and_snappy_raise_as_jax(tmp_path):
    """A file that is not an SSTable (bad magic) raises ValueError, and a
    snappy-compressed block RuntimeError without the snappy module, in
    both packages."""
    prefix, _, _ = _write(tmp_path)
    index = tmp_path / "weights.ckpt.index"
    good = index.read_bytes()
    index.write_bytes(good[:-8] + struct.pack("<Q", 0x0123456789ABCDEF))
    for reader in (jtf.read_index, ttf.read_index):
        with pytest.raises(ValueError, match="bad magic"):
            reader(index)
    # the index block's trailer says snappy
    _, _, pos = ttf._read_handle(good[-48:], 0)
    off, size, _ = ttf._read_handle(good[-48:], pos)
    data = bytearray(good)
    data[off + size] = 1
    index.write_bytes(bytes(data))
    if "snappy" in sys.modules or _importable("snappy"):
        pytest.skip("snappy is installed")
    for reader in (jtf.read_index, ttf.read_index):
        with pytest.raises(RuntimeError, match="snappy missing"):
            reader(index)


def _importable(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


# -------------------------------------------------------------- parity


def test_dc2_parity_check_against_reference_outputs(tmp_path):
    """dc2_parity_check on a bundle of full-size variables against a
    precomputed reference-outputs file (here JAX's forward of those
    variables stands in for the Keras model's): both packages pass with
    the same per-stamp flux errors within FWD_TOL; a reference 1% off
    fails both."""
    prefix, cfg, v = _write(tmp_path, tiny=False, shards=2)
    stamps = np.abs(np.random.default_rng(4).normal(size=(3, 59, 59, 6))).astype(np.float32)
    ref = np.asarray(JaxVAE(cfg).apply(v, jnp.asarray(stamps), z_mode="mean")[0].mean())
    np.save(tmp_path / "ref.npy", ref)
    got = tparity.dc2_parity_check(str(prefix), stamps, str(tmp_path / "ref.npy"), device="cpu")
    want = jparity.dc2_parity_check(str(prefix), stamps, str(tmp_path / "ref.npy"))
    print(f"dc2_parity_check: port {got['max_rel_flux']}, JAX {want['max_rel_flux']}")
    assert got["max_rel_flux"] <= 1e-5 and want["max_rel_flux"] <= 1e-5
    assert got["max_abs_pix"] <= FWD_TOL
    np.testing.assert_allclose(got["rel_flux"], want["rel_flux"], atol=1e-5)
    for check in (lambda r: tparity.dc2_parity_check(str(prefix), stamps, r, device="cpu"),
                  lambda r: jparity.dc2_parity_check(str(prefix), stamps, r)):
        with pytest.raises(AssertionError, match="DC2 flux parity FAILED"):
            check(ref * 1.01)


def test_dc2_stamps_and_live_reference_need_their_files(tmp_path, monkeypatch):
    """bundled_dc2_stamps reads DEBVADER_DC2_STAMPS as JAX's does (and the
    reference's source tree under DEBVADER_REFERENCE_SRC); without either
    the port raises FileNotFoundError.  reference_forward_mean raises
    ImportError in both packages when the reference's model builder
    cannot be imported."""
    stamps = np.random.default_rng(5).normal(size=(2, 59, 59, 6))
    np.save(tmp_path / "s.npy", stamps)
    monkeypatch.setenv("DEBVADER_DC2_STAMPS", str(tmp_path / "s.npy"))
    got = tparity.bundled_dc2_stamps()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jparity.bundled_dc2_stamps())
    monkeypatch.delenv("DEBVADER_DC2_STAMPS")
    monkeypatch.delenv("DEBVADER_REFERENCE_SRC", raising=False)
    with pytest.raises(FileNotFoundError, match="DEBVADER_DC2_STAMPS"):
        tparity.bundled_dc2_stamps()
    src = tmp_path / "src"
    (src / "debvader" / "data" / "dc2_imgs").mkdir(parents=True)
    np.save(src / "debvader" / "data" / "dc2_imgs" / "imgs_dc2.npy", stamps[:1])
    monkeypatch.setenv("DEBVADER_REFERENCE_SRC", str(tmp_path / "empty"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    for fn in (tparity.reference_forward_mean, jparity.reference_forward_mean):
        with pytest.raises(ImportError):
            fn(got, str(tmp_path / "none.ckpt"))
    monkeypatch.setenv("DEBVADER_REFERENCE_SRC", str(src))
    np.testing.assert_array_equal(tparity.bundled_dc2_stamps(), stamps[:1].astype(np.float32))
