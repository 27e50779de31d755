"""BENCHMARK.json against the benchmark's own rules, and the data-driven
layout: every cell finds its files by name, and a new cell or metric is
only new files and entries."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_full_check_fits_its_budget_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_entries()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_keys(key, entry):
    assert NAME.match(entry["name"])
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[key]
    assert set(entry) <= allowed
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("wl", MAN["workloads"], ids=lambda w: w["name"])
def test_every_workload_resolves_its_files(wl):
    cfg = harness.config(wl["config"])
    mix = harness.traffic(wl["traffic"])
    lim = harness.limits(wl["name"])
    assert harness.driver(mix).run
    assert lim and all("limit" in v and "lower" in v and "upper" in v
                       for v in lim.values())
    assert all(v["lower"] < v["limit"] < v["upper"] for v in lim.values())
    entry = next(c for c in MAN["configs"] if c["name"] == wl["config"])
    assert entry["file"] == f"benchmark/configs/{wl['config']}.json"
    assert cfg["source"] == entry["source"] and cfg["reduced"] == []
    assert wl["chips"] in (1, 4)
    names = {m["name"] for m in harness.end_to_end(MAN, wl)}
    assert "setup_s" in names and len(names) >= 2
    assert harness.per_layer(MAN, wl)
    for m in harness.per_layer(MAN, wl):
        harness.metric_module(m["name"])


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_files_declare_their_entry(m):
    mod = harness.metric_module(m["name"])
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        m["name"], m["unit"], m["layer"], m["source"], m["moves"])
    assert getattr(mod, "WORKLOADS", None) == m.get("workloads")
    assert mod.read({}) is None        # nothing to read: no value


def test_moves_is_reported_wherever_the_metric_is():
    for m in MAN["per_layer"]:
        for wl in MAN["workloads"]:
            if m in harness.per_layer(MAN, wl):
                names = {e["name"] for e in harness.end_to_end(MAN, wl)}
                assert m["moves"] in names, (m["name"], wl["name"])


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A later change adds a mix, a cell's limits and a metric as files,
    and entries in BENCHMARK.json: the harness picks them up unchanged."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".run",
                                                  "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = dict(harness.traffic("serve-b8"), batch=4)
    (tmp_path / "benchmark/traffic/serve-b4.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/limits/salsanext-kitti.serve-b4.json").write_text(
        json.dumps(harness.limits("salsanext-kitti.serve-b8")))
    (tmp_path / "benchmark/metrics/batch_scans.serve.py").write_text(
        'NAME = "batch_scans.serve"\nUNIT = "scans"\nLAYER = "device"\n'
        'SOURCE = "host_clock"\nMOVES = "serve_scans_per_s"\n\n\n'
        'def read(ctx):\n    return ctx["mix"]["batch"] if ctx else None\n')
    man["workloads"].append({"name": "salsanext-kitti.serve-b4",
                             "config": "salsanext-kitti",
                             "traffic": "serve-b4", "chips": 1,
                             "why": "a test cell"})
    man["per_layer"].append({"name": "batch_scans.serve", "unit": "scans",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "serve_scans_per_s"})
    for m in man["end_to_end"]:
        if "serve" in m["name"]:
            m["workloads"].append("salsanext-kitti.serve-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    got = harness.manifest(tmp_path)
    wl = harness.cell(got, "salsanext-kitti.serve-b4")
    assert harness.traffic(wl["traffic"], tmp_path)["batch"] == 4
    assert harness.limits(wl["name"], tmp_path)
    names = [m["name"] for m in harness.per_layer(got, wl)]
    assert "batch_scans.serve" in names
    read = harness.read_per_layer(got, wl, {"mix": {"batch": 8},
                                            "kind": "none"}, tmp_path)
    assert read["batch_scans.serve"] == {"value": 8.0, "unit": "scans"}
    # the old cells are untouched by the addition
    old = harness.cell(got, "sqsgv3_21-kitti.train-b4")
    assert "batch_scans.serve" not in [m["name"]
                                       for m in harness.per_layer(got, old)]
