"""The readers of the program's spans and counters over the survey field:
each reads a finite number in a traced tiny run of the field cell on the
CPU, none is reported by the stamp cells, and the span readers find
nothing in a program that has no such span."""

import math
import types

import pytest
from bench_cells import SEED, cells, tiny

from portbench.harness import load_manifest, load_module, per_layer_names, run_cell

FIELD = "f32-field4k"
READERS = ["host_copies_s.field", "cutouts_s.field", "forward_s.field", "render_s.field", "unspanned_s.field",
           "merge_ns_per_px.field", "idle_unattributed.field"]


@pytest.fixture(scope="module")
def field_line():
    manifest, cell, overrides = tiny(FIELD)
    return run_cell(manifest, cell, SEED, 0.5, True, device="cpu", mix_overrides=overrides)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_traced_field(field_line, name):
    assert name in per_layer_names(load_manifest(), FIELD)
    value = field_line["metrics"][name]["value"]
    assert math.isfinite(value) and value >= 0


def test_chunk_spans_lie_inside_the_chunk_loop(field_line):
    m = field_line["metrics"]
    assert m["cutouts_s.field"]["value"] + m["forward_s.field"]["value"] + m["render_s.field"]["value"] <= (
        m["serve_s.field"]["value"])


@pytest.mark.parametrize("workload", [w for w in cells() if w != FIELD])
def test_stamp_cells_report_none_of_them(workload):
    manifest, cell, overrides = tiny(workload)
    assert not set(READERS) & set(per_layer_names(manifest, workload))
    line = run_cell(manifest, cell, SEED, 0.3, True, device="cpu", mix_overrides=overrides)
    assert not set(READERS) & set(line["metrics"])


@pytest.mark.parametrize("name", [r for r in READERS if r != "idle_unattributed.field"])
def test_span_readers_find_nothing_without_the_spans(name):
    """A program with only the four older field metrics' stages (as before
    these spans existed) gives these readers nothing to read."""
    stages = {"upload": 0.1, "deblend_render": 0.8, "field_download": 0.2, "core": 0.02, "download": 0.01,
              "tile_select": 0.01, "merge": 1.1, "segstats": 0.05, "clean": 0.01}
    ctx = types.SimpleNamespace(stats={"stages_s": stages, "fields": 1, "window_s": 3.1}, trace=None)
    assert load_module("metrics", name).read(ctx) is None
