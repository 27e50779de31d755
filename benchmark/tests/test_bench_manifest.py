"""BENCHMARK.json against the benchmark's own rules, and the data-driven
layout: every cell finds its files by name, and a new cell or metric is
only new files and entries."""

import hashlib
import importlib
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
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
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


SERVE_LAYER = ["idle_pct.serve", "mfu.serve", "k1_roofline", "k2_roofline",
               "project_ms.serve", "backbone_ms.serve", "knn_ms.serve",
               "idle_copy_pct.serve", "idle_outside_pct.serve"]
TRAIN_LAYER = ["idle_pct.train", "mfu.train", "k3_roofline",
               "data_wait_ms.train", "host_step_ms.train",
               "idle_data_pct.train", "idle_step_pct.train", "proto_ms.train"]
ACCEPTED = {"salsanext-kitti.serve-b8": SERVE_LAYER,
            "sqsgv3_21-kitti.serve-b8": SERVE_LAYER,
            "sqsgv3_21-kitti.train-b4": TRAIN_LAYER}


@pytest.mark.parametrize("workload", sorted(ACCEPTED))
def test_accepted_cells_keep_their_per_layer_metrics(workload):
    """Each accepted cell reports the per-layer metrics it reported when
    the readers still listed their cells by name; metrics added later may
    join them."""
    wl = harness.cell(MAN, workload)
    known = set(SERVE_LAYER + TRAIN_LAYER)
    assert [m["name"] for m in harness.per_layer(MAN, wl)
            if m["name"] in known] == ACCEPTED[workload]


TOY = '''"""Two convolutions: the least a family needs to be served."""

import torch
import torch.nn.functional as F

from benchmark.reference import models


class Toy(torch.nn.Module):
    def __init__(self, n_classes, in_channels, width):
        super().__init__()
        self.conv1 = models.Conv2d(in_channels, width, 3, padding=1)
        self.bn1 = models.bn(width)
        self.dropout = models.Dropout2d(0.1)
        self.conv2 = models.Conv2d(width, n_classes, 1)

    def forward(self, x, return_feat=False, generator=None):
        feat = self.dropout(F.relu(self.bn1(self.conv1(x))), generator)
        out = {"logits": self.conv2(feat)}
        if return_feat:
            out["embedding"] = F.normalize(feat, dim=1)
        return out


def build(model_cfg, n_classes, proj_dim):
    return Toy(n_classes, model_cfg["in_channels"], model_cfg["width"])
'''


def _digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()
                                                        ).hexdigest()
            for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy_as_benchmark(tmp_path, monkeypatch):
    """A copy of ``benchmark/`` and ``BENCHMARK.json`` under ``tmp_path``,
    imported in this process as the package ``benchmark`` in place of the
    tree's; the tree's modules come back afterwards."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".run",
                                                  "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")

    def ours(name):
        return name == "benchmark" or name.startswith("benchmark.")

    saved = {n: m for n, m in sys.modules.items() if ours(n)}
    for n in saved:
        del sys.modules[n]
    monkeypatch.syspath_prepend(str(tmp_path))
    yield tmp_path
    for n in [n for n in sys.modules if ours(n)]:
        del sys.modules[n]
    sys.modules.update(saved)


def test_a_new_family_is_new_files_only(copy_as_benchmark):
    """A later change adds a model family as ``reference/<net_type>.py``,
    a configuration, a serving cell and its limits: the reference, the
    FLOP count, the readers, the float8 control and the control's
    readings reach it with no file of the harness edited."""
    import torch

    root = copy_as_benchmark
    before = _digests(root / "benchmark")
    (root / "benchmark/reference/toynet.py").write_text(TOY)
    cfg = json.loads((root / "benchmark/configs/salsanext-kitti.json")
                     .read_text())
    cfg.update(name="toy-kitti", source="a test family", reduced=[],
               model={"net_type": "toynet", "in_channels": 5, "width": 8})
    (root / "benchmark/configs/toy-kitti.json").write_text(json.dumps(cfg))
    shutil.copy(root / "benchmark/limits/salsanext-kitti.serve-b8.json",
                root / "benchmark/limits/toy-kitti.serve-b8.json")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy-kitti", "source": "a test family",
                           "file": "benchmark/configs/toy-kitti.json",
                           "reduced": [], "why": "a test family"})
    man["workloads"].append({"name": "toy-kitti.serve-b8",
                             "config": "toy-kitti", "traffic": "serve-b8",
                             "chips": 1, "why": "a test cell"})
    for m in man["end_to_end"]:
        if "serve" in m["name"]:
            m["workloads"].append("toy-kitti.serve-b8")
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    h = importlib.import_module("benchmark.harness")
    models = importlib.import_module("benchmark.reference.models")
    flops = importlib.import_module("benchmark.roofline.flops")
    peaks = importlib.import_module("benchmark.roofline.peaks")
    control = importlib.import_module("benchmark.control")
    assert Path(h.__file__).parent == root / "benchmark"
    man = h.manifest()
    wl = h.cell(man, "toy-kitti.serve-b8")
    cfg = h.config(wl["config"])
    assert h.limits(wl["name"])

    model = models.build(cfg["model"], 20, 256).eval()
    assert type(model).__name__ == "Toy"
    # every key of the model block reaches the count, the family's own too
    hw = cfg["sensor"]["proj_h"] * cfg["sensor"]["proj_w"]
    for width in (8, 16):
        wide = dict(cfg, model=dict(cfg["model"], width=width))
        assert flops.forward_flops(wide) == 2 * hw * width * (5 * 9 + 20)
    got = h.metric_module("mfu.serve").read(
        {"kind": "serve", "cfg": cfg, "scans_per_s": 100.0})
    assert got == pytest.approx(
        100 * 100.0 * 2 * hw * 8 * (5 * 9 + 20) / peaks.BF16_FLOPS)

    x = torch.randn(2, 5, 8, 16, generator=torch.Generator().manual_seed(0))
    want = model(x)["logits"]
    assert set(model(x, return_feat=True)) == {"logits", "embedding"}
    models.set_fp8(model, True)
    convs = [m for m in model.modules() if isinstance(m, models.Conv2d)]
    assert len(convs) == 2 and all(c.fp8 for c in convs)
    assert not torch.equal(model(x)["logits"], want)

    names = [m["name"] for m in h.per_layer(man, wl)]
    assert names == [m["name"] for m in h.per_layer(
        man, h.cell(man, "salsanext-kitti.serve-b8"))]

    def small_cfg(c):
        c = json.loads(json.dumps(c))
        c["sensor"].update(proj_h=16, proj_w=64)
        c["data"].update(max_points=4096)
        return c

    def small_mix(m):
        return dict(m, points_min=2000, points_max=3000, batch=2,
                    pool_batches=2)

    torch.set_num_threads(2)
    read = control.readings(wl["name"], 2**31 + 17, dev="cpu", root=root,
                            cfg_patch=small_cfg, mix_patch=small_mix)["fp8"]
    assert 0.0 <= read["fp8_mismatch"] <= 1.0

    with pytest.raises(ValueError,
                       match=r"'nosuchnet'.*benchmark/reference/nosuchnet"):
        models.build({"net_type": "nosuchnet"}, 20, 256)
    after = _digests(root / "benchmark")
    assert {k: after[k] for k in before} == before
