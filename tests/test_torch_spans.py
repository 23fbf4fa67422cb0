"""The program's spans (``utils/profiling.stage_timer``): annotations on the
profiler's timeline, the event spans that do not wait for the card, and
the stage dict of a whole survey field (``TiledDeblendField``)."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import debvader_tpu_torch as dtt
from debvader_tpu_torch.ops import detection
from debvader_tpu_torch.parallel import make_mesh
from debvader_tpu_torch.pipeline.sharded_field import ShardedFieldDeblender
from debvader_tpu_torch.pipeline.tiles import TiledDeblendField
from debvader_tpu_torch.utils import profiling
from debvader_tpu_torch.utils.profiling import settle_spans, stage_timer

# the top-level stages of one detect_deblend_render call, in call order
FIELD_STAGES = {"field_copy", "field_checksum", "upload", "tile_stack", "core", "download", "merge", "segstats",
                "clean", "tile_select", "deblend_render", "field_download", "catalog", "residual_copy"}
CHUNK_STAGES = {"cutouts", "forward", "render"}  # nested in 'deblend_render'
# detection's counts: the masked-pixel COO, and the watershed merge's
# boundary pixel pairs and distinct saddle edges
COUNTERS = {"count.masked_px", "count.saddle_pairs", "count.segment_edges"}


def _annotations(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("name", "").startswith("dvt.")]


def test_spans_are_user_annotations_that_nest(tmp_path):
    times = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage_timer(times, "outer"):
            with stage_timer(times, "inner"):
                torch.ones(64).sum()
    spans = {e["name"]: e for e in _annotations(prof, tmp_path)}
    assert set(spans) == {"dvt.outer", "dvt.inner"}
    outer, inner = spans["dvt.outer"], spans["dvt.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert set(times) == {"outer", "inner"} and 0 < times["inner"] <= times["outer"]


def test_spans_open_no_annotation_without_a_profiler(monkeypatch):
    import torch.profiler

    def refuse(name):
        raise AssertionError(f"annotation {name} opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    times = {}
    with stage_timer(times, "stage"):
        pass
    with stage_timer(times, "stage", pending=[]):
        pass
    assert times["stage"] > 0


def test_event_spans_fall_back_to_the_wall_clock():
    """Off a card the event mode adds the wall seconds at once and leaves
    nothing pending."""
    times, pending = {}, []
    with stage_timer(times, "forward", "cpu", pending):
        torch.ones(64).sum()
    assert pending == [] and times["forward"] > 0
    before = dict(times)
    settle_spans(times, pending)
    assert times == before


class _Event:
    """A stand-in for a recorded CUDA event: ``ms`` past a common origin."""

    def __init__(self, ms):
        self.ms, self.waited = ms, 0

    def synchronize(self):
        self.waited += 1

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_settle_spans_adds_each_event_span_once():
    times = {"forward": 1.0}
    end = _Event(7.5)
    pending = [("forward", _Event(2.5), end), ("render", _Event(8.0), _Event(8.25)), ("forward", _Event(9.0),
                                                                                       _Event(10.0))]
    settle_spans(times, pending)
    assert times == {"forward": 1.0 + 0.005 + 0.001, "render": 0.00025}
    assert pending == [] and end.waited == 1
    settle_spans(times, pending)
    assert times == {"forward": 1.0 + 0.005 + 0.001, "render": 0.00025}


def _field(size=256, bands=6, n=12, seed=0):
    """(1, size, size, bands): n Gaussian galaxies with a band SED over
    noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    f = 0.02 * rng.normal(size=(size, size, bands))
    for cy, cx in rng.uniform(-90, 90, (n, 2)):
        s = rng.uniform(1.5, 3.0)
        sed = np.exp(rng.uniform(-0.15, 0.15) * np.arange(bands))
        prof = np.exp(-((yy - size // 2 - cy) ** 2 + (xx - size // 2 - cx) ** 2) / (2 * s * s))
        f += rng.uniform(0.5, 2.0) * prof[..., None] * sed
    return f[None].astype(np.float32)


@pytest.fixture(scope="module")
def net():
    return dtt.load_deblender("sim_demo", device="cpu")


def _tiled(net, field):
    cfg = dtt.PipelineConfig(tile_size=128, tile_overlap=32, interp_order=3, source_chunk=4)
    det = dtt.DetectionConfig(thresh=5.0, threshold_scaling="matched")
    return TiledDeblendField(net, field, z_mode="mean", cfg=cfg, det_cfg=det, device="cpu")


def test_survey_field_records_every_stage_once(net, monkeypatch, tmp_path):
    """One detect_deblend_render: one dict for detection and serving, so
    the benchmark's merge of the two drops nothing; every top-level stage
    in it, the chunk spans inside 'deblend_render', 'field_checksum' once
    for each of the memo's look-ups (two: detection's and the serve's),
    'upload' on its miss only, ``count.masked_px`` the length of the
    masked-pixel COO that detection downloaded, and the watershed merge's
    ``count.saddle_pairs`` and ``count.segment_edges``, fewer than it.  A
    second call on the same object hits the memo: no 'upload', no
    'field_copy'."""
    coo, lookups = [], []
    compact = detection._compact_masked

    def counted_compact(labels, filt):
        out = compact(labels, filt)
        coo.append(len(out[0]))
        return out

    monkeypatch.setattr(detection, "_compact_masked", counted_compact)
    df = _tiled(net, _field())
    device_field = df._device_field

    def counted_device_field(field_np, timings=None):
        lookups.append(timings)
        return device_field(field_np, timings)

    df._device_field = counted_device_field
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        catalog, residual = df.detect_deblend_render()
    assert catalog is not None and len(catalog) > 4 and np.isfinite(residual).all()
    t = df.serving_timings
    assert df.detect_timings is t
    merged = dict(df.detect_timings, **df.serving_timings)
    assert set(merged) == FIELD_STAGES | CHUNK_STAGES | COUNTERS
    assert all(v > 0 for v in merged.values())
    assert all(t[k] <= t["deblend_render"] for k in CHUNK_STAGES)
    assert sum(t[k] for k in CHUNK_STAGES) <= t["deblend_render"]
    assert len(lookups) == 2 and all(d is t for d in lookups)
    assert t["count.masked_px"] == sum(coo) > t["count.saddle_pairs"] >= t["count.segment_edges"] > 0
    names = [e["name"] for e in _annotations(prof, tmp_path)]
    assert names.count("dvt.field_checksum") == 2 and names.count("dvt.upload") == 1
    assert names.count("dvt.field_copy") == 0  # the constructor ran before the profiler
    assert {f"dvt.{k}" for k in FIELD_STAGES - {"field_copy"} | CHUNK_STAGES} <= set(names)
    chunks = -(-len(catalog) // 4)
    assert all(names.count(f"dvt.{k}") == chunks for k in ("forward", "render"))

    again = df.detect_deblend_render()[0]
    np.testing.assert_array_equal(again.list_idx, catalog.list_idx)
    assert set(df.serving_timings) == set(merged) - {"upload", "field_copy"}
    assert all(df.serving_timings[k] == t[k] for k in COUNTERS)


def test_first_entry_call_takes_the_field_copy(net):
    """The constructor's 'field_copy' goes into the first entry call's
    dict, whichever it is, and into no later one."""
    df = _tiled(net, _field(size=160, n=4, seed=1))
    first, later = {}, {}
    df.detect(timings=first)
    df.detect(timings=later)
    assert first["field_copy"] > 0 and "field_copy" not in later
    assert {"tile_stack", "core", "download", "tile_select"} | COUNTERS <= set(later)


class _RecordedEvent:
    """A stand-in for ``torch.cuda.Event``: ``record`` reads the host's
    clock, and each event counts its records and waits."""

    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.ms, self.records, self.waits = None, 0, 0
        _RecordedEvent.made.append(self)

    def record(self, stream=None):
        self.ms, self.records = time.perf_counter() * 1e3, self.records + 1

    def synchronize(self):
        self.waits += 1

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.mark.parametrize("route", ["single", "bands"])
def test_event_spans_reach_the_serving_dict(net, monkeypatch, route):
    """The event mode's plumbing on both serving routes, with stand-in CUDA
    events on the CPU: each chunk span records one pair of events and waits
    for nothing, the owning call settles every pair once into its own dict,
    and the nested spans sum to no more than 'deblend_render'."""
    monkeypatch.setattr(profiling, "_on_card", lambda device: device is not None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _RecordedEvent)
    _RecordedEvent.made = []
    field = _field(size=192, n=8, seed=2)
    centers = _tiled(net, field).detect()
    cfg = dtt.PipelineConfig(interp_order=3, source_chunk=3)
    if route == "single":
        df = dtt.DeblendField(net, field, z_mode="mean", cfg=cfg, device="cpu")
    else:
        df = ShardedFieldDeblender(net, field, make_mesh(2, devices=["cpu"] * 2), cfg=cfg, z_mode="mean")
    t = {}
    catalog, _ = df.deblend_and_render(centers, timings=t)
    assert catalog is not None and len(catalog) > 3
    assert CHUNK_STAGES <= set(t) and sum(t[k] for k in CHUNK_STAGES) <= t["deblend_render"]
    made = _RecordedEvent.made
    assert made and len(made) % 2 == 0 and all(e.records == 1 for e in made)
    ends = made[1::2]
    assert all(e.waits == 1 for e in ends) and not any(e.waits for e in made[0::2])
