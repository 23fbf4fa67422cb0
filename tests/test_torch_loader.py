"""The port's native data loader (csrc/dataloader.cpp, built by
runtime/loader.py): its source is the JAX package's below the header, its
batches are the .npy source's rows converted to float32, a shuffled epoch
covers distinct rows, and a missing or failing compiler raises instead of
falling back to numpy."""

from pathlib import Path

import numpy as np
import pytest
import torch

from debvader_tpu.runtime import loader as jloader
from debvader_tpu_torch.config import ModelConfig, TrainConfig
from debvader_tpu_torch.models.vae import DeblenderVAE
from debvader_tpu_torch.runtime import loader
from debvader_tpu_torch.training import train as tt

torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def archive(tmp_path):
    """23 rows of (4, 5, 3) float64 inputs (the first element of row i is
    i) and float32 labels."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(23, 4, 5, 3))
    x[:, 0, 0, 0] = np.arange(23)
    y = rng.normal(size=(23, 4, 5, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    return tmp_path / "x.npy", tmp_path / "y.npy", x, y


def test_the_library_is_built_from_the_ports_copy():
    path = loader.build()
    assert loader.SOURCE == _ROOT / "debvader_tpu_torch" / "csrc" / "dataloader.cpp"
    assert path.parent == _ROOT / "debvader_tpu_torch" / "_build" and path.name.startswith("libdvloader-")
    ours = loader.SOURCE.read_text().splitlines()
    theirs = (_ROOT / "debvader_tpu" / "runtime" / "dataloader.cpp").read_text().splitlines()
    assert ours[ours.index("#include <atomic>"):] == theirs[theirs.index("#include <atomic>"):]


def test_batches_are_the_sources_rows(archive):
    """Unshuffled, batch k is rows 5k..5k+4, float32 of the float64 source;
    len is the full batches of a pass; the next pass starts over."""
    xp, yp, x, y = archive
    with loader.make_loader(xp, yp, 5, shuffle=False) as ld:
        assert isinstance(ld, loader.NativeNpyLoader) and len(ld) == 4
        assert ld.x_shape == x.shape and ld.y_shape == y.shape
        for k in range(6):
            bx, by = ld.next_batch()
            r = (k % 4) * 5
            assert bx.dtype == by.dtype == np.float32 and bx.shape == (5, 4, 5, 3)
            np.testing.assert_array_equal(bx, x[r : r + 5].astype(np.float32))
            np.testing.assert_array_equal(by, y[r : r + 5])


def test_a_shuffled_epoch_covers_distinct_rows_in_jaxs_order(archive):
    """One pass of len() batches takes len * bs distinct rows, each batch
    the source's rows; a seed gives the same order again, another seed
    another.  (The order is the JAX package's native loader's by
    construction: the source below the header is its.  Its library is not
    opened here: it builds next to its source, where the JAX package's own
    tests may be building it at the same time.)"""
    xp, yp, x, y = archive

    def order(ld, n):
        seen = []
        for _ in range(n):
            bx, by = ld.next_batch()
            for a, b in zip(bx, by):
                i = int(a[0, 0, 0])
                np.testing.assert_array_equal(a, x[i].astype(np.float32))
                np.testing.assert_array_equal(b, y[i])
                seen.append(i)
        return seen

    with loader.NativeNpyLoader(xp, yp, 5, seed=7) as ld:
        seen = order(ld, 8)
    assert len(set(seen[:20])) == 20 and len(set(seen[20:])) == 20 and seen[:20] != seen[20:]
    with loader.NativeNpyLoader(xp, yp, 5, seed=7) as ld:
        assert order(ld, 8) == seen
    with loader.NativeNpyLoader(xp, yp, 5, seed=8) as ld:
        assert order(ld, 4) != seen[:20]


@pytest.mark.parametrize("cxx, match", [("/nonexistent/g++", "No such file"), ("false", "exit 1")])
def test_a_failed_build_raises(monkeypatch, tmp_path, archive, cxx, match):
    """No silent fallback: with the compiler missing or failing, building,
    opening a loader and make_loader on .npy paths all raise, naming the
    source; no library is left behind."""
    xp, yp, _, _ = archive
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(loader, "CXX", cxx)
    with pytest.raises(RuntimeError, match=match) as info:
        loader.build()
    assert "dataloader.cpp" in str(info.value)
    for make in (lambda: loader.NativeNpyLoader(xp, yp, 5), lambda: loader.make_loader(xp, yp, 5)):
        with pytest.raises(RuntimeError, match="dataloader.cpp"):
            make()
    assert not list((tmp_path / "build").glob("*.so"))


def test_bad_archives_and_arguments_raise(archive, tmp_path):
    xp, yp, x, _ = archive
    np.save(tmp_path / "short.npy", x[:4])
    with pytest.raises(RuntimeError, match="row mismatch"):
        loader.NativeNpyLoader(xp, tmp_path / "short.npy", 5)
    np.save(tmp_path / "i8.npy", np.zeros((23, 2), np.int64))
    with pytest.raises(RuntimeError, match="unsupported dtype"):
        loader.NativeNpyLoader(tmp_path / "i8.npy", yp, 5)
    with pytest.raises(TypeError, match="NumpyLoader takes arrays"):
        loader.NumpyLoader(xp, yp, 5)
    ld = loader.NativeNpyLoader(xp, yp, 5)
    ld.close()
    with pytest.raises(RuntimeError, match="closed"):
        ld.next_batch()


def test_numpy_loader_over_arrays(archive):
    """make_loader over arrays is the NumpyLoader, with the JAX package's
    order for the same seed."""
    _, _, x, y = archive
    ours, theirs = loader.make_loader(x, y, 5, seed=3), jloader.NumpyLoader(x, y, 5, seed=3)
    assert isinstance(ours, loader.NumpyLoader) and len(ours) == 4
    for _ in range(6):
        (a, b), (c, d) = ours.next_batch(), theirs.next_batch()
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_train_network_takes_the_native_loader(tmp_path):
    """train_network over a loader: len(loader) steps an epoch from its
    batches, validation from arrays."""
    cfg = ModelConfig(stamp_size=23, nb_of_bands=3, latent_dim=4, filters=(4, 8), kernels=(3, 3))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (12, 23, 23, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", x)
    tcfg = TrainConfig(batch_size=5)
    state = tt.create_train_state(DeblenderVAE(cfg), tcfg, device="cpu")
    with loader.make_loader(tmp_path / "x.npy", tmp_path / "y.npy", 5) as ld:
        state, hist = tt.train_network(DeblenderVAE(cfg), state, 2, ld, (x, x), 5, verbose=0, train_cfg=tcfg)
    assert state.step == 4 and all(len(v) == 2 and np.isfinite(v).all() for v in hist.values())
