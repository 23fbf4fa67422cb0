"""Tiled processing for fields larger than one detection tile (4k x 4k
coadds and beyond), in PyTorch.

Port of debvader_tpu.pipeline.tiles:

- **Detection** runs over a stack of overlapping square tiles
  (``PipelineConfig.tile_size``, ``tile_overlap``): the field is cut into
  the stack on the device in one gather, ``detect_sources_batched`` runs
  the core over the whole stack at once, and each tile keeps only the
  sources inside its *core* (cut at the midpoints of the overlaps), so the
  cores partition the plane and every source is reported once.
- **Deblending** and the residual reuse DeblendField's routes, which are
  size-generic.
"""

from __future__ import annotations

import numpy as np
import torch

from debvader_tpu_torch.config import DetectionConfig
from debvader_tpu_torch.device import resolve_device
from debvader_tpu_torch.ops.detection import _on_device, detect_sources_batched
from debvader_tpu_torch.pipeline.field import DeblendField
from debvader_tpu_torch.utils.profiling import stage_timer

__all__ = ["tile_origins", "detect_objects_tiled", "TiledDeblendField"]


def _tile_stack(band: torch.Tensor, origins: list[int], tile: int) -> torch.Tensor:
    """The (len(origins)**2, tile, tile) stack of the tiles at origins x
    origins (row-major) of a 2D band, in one gather on its device."""
    n = len(origins)
    r = torch.arange(tile, device=band.device)
    starts = torch.as_tensor(origins, device=band.device)[:, None] + r
    rows, cols = starts.repeat_interleave(n, dim=0), starts.repeat(n, 1)
    return band[rows[:, :, None], cols[:, None, :]]


def tile_origins(field_size: int, tile: int, overlap: int) -> list[int]:
    """Start offsets of overlapping tiles covering [0, field_size)."""
    if tile >= field_size:
        return [0]
    stride = tile - overlap
    starts = list(range(0, field_size - tile, stride))
    starts.append(field_size - tile)  # the last tile flush with the edge
    return starts


def _core_bounds(origins: list[int], tile: int, lo: int, hi: int) -> np.ndarray:
    """(len(origins), 2) [lo, hi) of each tile's core: an exact partition
    of the band [lo, hi) (the whole field, or a row band's own rows) cut
    at the midpoints of consecutive tiles' overlaps, clamped to the band
    (robust to the shorter stride of the last tile)."""
    mids = [min(max((a + b + tile) / 2.0, lo), hi) for a, b in zip(origins[:-1], origins[1:])]
    cuts = [float(lo)] + mids + [float(hi)]
    return np.stack([cuts[:-1], cuts[1:]], -1)


def _select_in_cores(objs: list[dict], tiles: list, half: int) -> np.ndarray:
    """Each tile's detections inside its core, in the order of ``objs``:
    (N, 2) offsets from the field centre, round(-half + y).  ``tiles``
    gives each detection dict its (y origin, (y_lo, y_hi), x origin,
    (x_lo, x_hi)); an empty core keeps nothing."""
    out = []
    for obj, (oy, (y_lo, y_hi), ox, (x_lo, x_hi)) in zip(objs, tiles):
        gy, gx = obj["y"] + oy, obj["x"] + ox
        keep = (gy >= y_lo) & (gy < y_hi) & (gx >= x_lo) & (gx < x_hi)
        if keep.any():
            out.append(np.stack([np.round(-half + gy[keep]), np.round(-half + gx[keep])], -1))
    if not out:
        return np.zeros((0, 2))
    return np.concatenate(out)


def _detection_band(field_image, det_cfg: DetectionConfig, dev: torch.device) -> torch.Tensor:
    """The detection band of a field (1, F, F, B), (F, F, B) or (F, F) as a
    2D float32 tensor on ``dev``.  A tensor already on the device is
    sliced there (the running residual, the memoized field: nothing
    crosses to the host; a bfloat16 band is widened there); a host field
    is band-selected in numpy and only that band is uploaded."""
    img = field_image if isinstance(field_image, torch.Tensor) else np.asarray(field_image, np.float32)
    if img.ndim == 4:
        img = img[0]
    if img.ndim == 3:
        img = img[..., det_cfg.detection_band if img.shape[-1] > det_cfg.detection_band else 0]
    if img.ndim != 2 or img.shape[0] != img.shape[1]:
        raise ValueError(
            f"detection requires a square field (got {tuple(img.shape)}); the tiling grid and the "
            f"centre-offset convention are single-axis: crop or zero-pad to square (a rectangular "
            f"field would silently drop sources outside the leading-axis extent)"
        )
    return _on_device(img, dev)


def detect_objects_tiled(
    field_image,
    det_cfg: DetectionConfig | None = None,
    tile: int = 1024,
    overlap: int = 64,
    mesh=None,
    timings=None,
    device="cuda",
) -> np.ndarray:
    """Tiled counterpart of detect_objects: (N, 2) offsets from the field
    centre, round(-int(F/2) + y).

    ``field_image``: a host array or a tensor on ``device`` (a bfloat16
    field is widened to float32 for detection).  All tiles run as one
    stack through ``detect_sources_batched`` (a field no larger than one
    tile as a stack of one); each tile's detections are kept only inside
    its core, so every source is reported once.  ``timings`` accumulates
    the seconds of 'tile_stack' (the detection band and the tile stack
    gathered on the device, synchronised), the batched detection's stages
    and its ``count.masked_px`` (``detect_sources_batched``), then
    'tile_select' (each tile's core kept, on the host).  ``mesh`` splits
    the tile stack over the mesh's 'data' axis
    (``detect_sources_batched``)."""
    det_cfg = det_cfg or DetectionConfig()
    dev = resolve_device(device)
    t = timings if timings is not None else {}
    with stage_timer(t, "tile_stack", dev):
        band = _detection_band(field_image, det_cfg, dev)
        f = band.shape[0]
        origins = tile_origins(f, tile, overlap)
        size = min(tile, f)
        subs = _tile_stack(band, origins, size)
    # catalog only: no tile's dense label map is rebuilt
    objs = detect_sources_batched(subs, det_cfg, mesh=mesh, timings=t, want_map=False, device=dev)
    cores = _core_bounds(origins, size, 0, f)
    tiles = [(oy, yb, ox, xb) for oy, yb in zip(origins, cores) for ox, xb in zip(origins, cores)]
    with stage_timer(t, "tile_select"):
        return _select_in_cores(objs, tiles, int(f / 2))


class TiledDeblendField(DeblendField):
    """DeblendField for fields larger than one detection tile: tiled
    detection, and ``detect_and_deblend`` / ``detect_deblend_render``
    entry points over the record-array and the streaming routes."""

    def __init__(self, *args, det_cfg: DetectionConfig | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.det_cfg = det_cfg or DetectionConfig()
        self.detect_timings: dict = {}

    def detect(self, timings=None, field=None) -> np.ndarray:
        """Tiled detection at ``cfg.tile_size`` / ``cfg.tile_overlap``;
        stage seconds land in ``timings`` (or a new dict), kept as
        ``self.detect_timings``: 'tile_stack', 'core', 'download', 'merge',
        'segstats', 'clean', 'tile_select' and the count
        ``count.masked_px`` (``detect_objects_tiled``); the first entry
        call's dict also takes the constructor's 'field_copy'.
        ``field``: a device-resident field to detect on instead of
        uploading the detection band of ``self.field_image``."""
        t = self._timings(timings)
        centers = detect_objects_tiled(
            self.field_image if field is None else field,
            self.det_cfg,
            tile=self.cfg.tile_size,
            overlap=self.cfg.tile_overlap,
            mesh=self.mesh,
            timings=t,
            device=self.device,
        )
        self.detect_timings = t
        return centers

    def detect_and_deblend(self, **kwargs):
        """Tiled detection on the memoized device field, then
        ``deblend_field``; None when nothing is detected."""
        centers = self.detect(field=self._device_field(self.field_image))
        if len(centers) == 0:
            return None
        return self.deblend_field(centers, **kwargs)

    def detect_deblend_render(self, timings=None, **kwargs):
        """Survey serving: tiled detection on the memoized device field (the
        streaming route's own input, so detection uploads nothing), then
        ``deblend_and_render`` at the detected centres.

        One stage dict, ``timings`` or a new one, takes the whole call and
        is both ``self.detect_timings`` and ``self.serving_timings``:
        'field_copy' (first entry call only), 'field_checksum' (each of the
        memo's two look-ups), 'upload' (when the memo misses), detection's
        stages (``detect``), then ``deblend_and_render``'s."""
        t = self._timings(timings)
        self.serving_timings = t
        centers = self.detect(timings=t, field=self._device_field(self.field_image, t))
        if len(centers) == 0:
            if kwargs.get("return_model"):
                return None, self._residual_field(), np.zeros_like(self.field_image[0])
            return None, self._residual_field()
        return self.deblend_and_render(centers, timings=t, **kwargs)
