"""BENCHMARK.json against the benchmark's contract: every name resolves to
its file, names and units use the allowed characters, and every cell
reports what it must."""

import json
import re

import pytest

from portbench.harness import REPO, ROOT, end_to_end_names, load_manifest, per_layer_names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest()
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_text(w) for w in MANIFEST["command"])
    assert MANIFEST["paths"] == ["portbench"]


def test_run_seconds_fits_the_full_check_with_24_cells():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and _text(config["why"]) and _text(config["source"])
    assert config["source"].startswith("https://")
    path = REPO / config["file"]
    assert path.is_file() and path.resolve().is_relative_to(ROOT)
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
    assert (REPO / data["weights"]).is_file()
    assert data["reference_precision"] == data["model"]["dtype"]
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _text(cell["why"])
    assert cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    mix = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "drivers" / f"{mix['driver']}.py").is_file()
    assert (ROOT / "limits" / f"{cell['name']}.json").is_file()
    e2e = end_to_end_names(MANIFEST, cell["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert per_layer_names(MANIFEST, cell["name"])


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(set(names)) == len(names)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", [])) <= cells
    if metric in MANIFEST["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(metric["layer"])
        assert (ROOT / "metrics" / f"{metric['name']}.py").is_file()
        for cell in metric.get("workloads", cells):
            assert metric["moves"] in end_to_end_names(MANIFEST, cell)


def test_setup_bound():
    (setup,) = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup


def test_layers_are_spelt_alike():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
