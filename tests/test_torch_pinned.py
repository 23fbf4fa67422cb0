"""Two faults found in the port against the JAX package, shown on the CPU
to be the JAX package's own behaviour and pinned here (ROADMAP.md Queue 3,
standing traps):

- **bfloat16 iterative serving splits from float32 on faint sources.**
  On the 128^2 crop at (384, 0) of chip_smoke.py's 4096^2 field (the
  smallest window found where the port's two routes differ), the JAX
  package's own float32 and bfloat16 ``iterative_deblend_and_render``
  find the same two step-1 sources by one route only as the port's do,
  and each route's catalogue is the other package's.
- **Default-threshold fluxes.**  The JAX package's two background routes
  (the XLA sort and the Pallas kernel in interpret mode, which a TPU runs)
  give noise-peak fluxes up to 2.4e-6 apart; the port's plain box sums
  meet rtol 1e-6 against the Pallas route.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import debvader_tpu as dt
import debvader_tpu_torch as dtt
from debvader_tpu.config import DetectionConfig as JaxDetectionConfig
from debvader_tpu.config import PipelineConfig as JaxPipelineConfig
from debvader_tpu.ops import detection as jd
from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.ops import detection as td
from test_torch_tiles import FLUX_RTOL_DEFAULT, _stack

torch.set_num_threads(1)

SERVING = dict(thresh=5.0, threshold_scaling="matched")
TILES = dict(tile_size=1024, tile_overlap=64, interp_order=1, source_chunk=128)


def _rows(cat) -> set:
    if cat is None:
        return set()
    return set(zip(cat.iteration.tolist(), cat.galaxy_distances_to_center_x.tolist(),
                   cat.galaxy_distances_to_center_y.tolist()))


def test_bfloat16_iterative_split_is_the_jax_packages_own():
    field = chip_smoke.make_field(size=4096, n_gal=4800, crop=(384, 0, 128))
    jnet, tnet = dt.load_deblender("sim_demo"), dtt.load_deblender("sim_demo", device="cpu")

    def port(**kw):
        idf = dtt.IterativeDeblendField(tnet, field, z_mode="mean", cfg=dtt.PipelineConfig(**TILES), device="cpu",
                                        **kw)
        return _rows(idf.iterative_deblend_and_render(det_cfg=DetectionConfig(**SERVING), max_iterations=3)[0])

    def jax_(**kw):
        idf = dt.IterativeDeblendField(jnet, field, z_mode="mean", cfg=JaxPipelineConfig(**TILES), **kw)
        det = JaxDetectionConfig(use_pallas_fused=True, **SERVING)
        return _rows(idf.iterative_deblend_and_render(det_cfg=det, max_iterations=3)[0])

    p32, p16, j32, j16 = port(), port(device_dtype="bfloat16"), jax_(), jax_(device_dtype="bfloat16")
    assert p32 == j32 and p16 == j16
    assert p32 ^ p16 == j32 ^ j16 == {(1, 29.0, -1.0), (1, 31.0, -1.0)}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
def test_default_threshold_flux_spread_is_the_jax_packages_own(fused):
    """The 3-tile stack at the default threshold (hundreds of noise peaks a
    tile): JAX's XLA and Pallas background routes give the same peaks with
    fluxes more than 1e-6 apart (read 2.4e-6, within FLUX_RTOL_DEFAULT);
    the port's catalogue is within 1e-6 of the Pallas route's."""
    tiles = _stack()

    def jax_cat(clip):
        return jd.detect_sources_batched(tiles, JaxDetectionConfig(use_pallas_fused=fused, use_pallas_clip=clip))

    xla, pallas = jax_cat(False), jax_cat(True)
    port = td.detect_sources_batched(tiles, DetectionConfig(use_pallas_fused=fused), device="cpu")

    def spread(a, b):
        for g, w in zip(a, b):
            np.testing.assert_array_equal(g["peak_yx"], w["peak_yx"])
            np.testing.assert_array_equal(g["area"], w["area"])
        return max(float(np.max(np.abs(g["flux"] / w["flux"] - 1))) for g, w in zip(a, b))

    own, ours = spread(xla, pallas), spread(port, pallas)
    print(f"{'fused' if fused else 'chain'}: JAX's two routes {own}, the port against the Pallas route {ours}")
    assert 1e-6 < own <= FLUX_RTOL_DEFAULT
    assert ours <= 1e-6
