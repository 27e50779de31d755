"""The readers of the program's spans (benchmark/spans.py and the
``program_span`` metrics that read ``serve.*`` and ``train.*``): exact
idle shares on a hand-made timeline, nothing read without spans, and a
small traced run on the CPU that reads them beside the metrics that were
there, which the spans leave as they were."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, spans  # noqa: E402
from coarse3d_tpu_torch.utils import profiling  # noqa: E402

NEW = ["project_ms.serve", "backbone_ms.serve", "knn_ms.serve",
       "idle_copy_pct.serve", "idle_outside_pct.serve",
       "idle_data_pct.train", "idle_step_pct.train", "proto_ms.train"]
BASE = 1_790_000_000          # seconds: the profiler's clock is Unix time


def _span(sid, name, a, b, parent=None, device_ms=0.0, rid=0):
    return {"name": name, "id": sid, "parent": parent, "rid": rid,
            "start_ns": int((BASE + a) * 1e9),
            "end_ns": int((BASE + b) * 1e9), "device_ms": device_ms}


# device busy [1, 3], [4, 6], [8, 10]; the window is 10 s, so it starts
# at 0 and is idle over [0, 1], [3, 4], [6, 8]: 40 %
TRACE = {"device": [("k", BASE + 1, 2.0), ("k", BASE + 4, 1.0),
                    ("k", BASE + 5, 1.0), ("k", BASE + 8, 2.0)],
         "window_s": 10.0, "busy_s": 6.0}
SERVE = [_span(0, "serve.batch", 0.5, 7.0),
         _span(1, "serve.copy_in", 0.5, 3.5, 0, device_ms=2.0),
         _span(2, "serve.project", 3.5, 7.0, 0, device_ms=3.0),
         _span(3, "serve.batch", 9.0, 9.5, rid=1),
         _span(4, "serve.project", 9.0, 9.5, 3, device_ms=5.0, rid=1)]
TRAIN = [_span(0, "train.step", 0.2, 9.5),
         _span(1, "train.data", 0.2, 2.0, 0),
         _span(2, "train.prototypes", 5.0, 5.5, 0, device_ms=0.25)]


@pytest.fixture
def fake(monkeypatch):
    def put(found):
        monkeypatch.setattr(profiling, "traced_spans", lambda: list(found))
    return put


def read(name, ctx):
    return harness.metric_module(name).read(ctx)


def test_idle_shares_on_a_hand_made_timeline(fake):
    ctx = {"trace": TRACE}
    fake(SERVE)
    # copy-in [0.5, 1] and [3, 3.5]; outside any span [0, 0.5] and [7, 8]
    assert read("idle_copy_pct.serve", ctx) == pytest.approx(10.0)
    assert read("idle_outside_pct.serve", ctx) == pytest.approx(15.0)
    rows = {r["span"]: r for r in spans.table(ctx)}
    assert rows["serve.project"]["idle_ms"] == pytest.approx(1.5e3 / 2)
    assert sum(r["idle_ms"] for r in rows.values()) * 2 == pytest.approx(
        1e3 * (TRACE["window_s"] - TRACE["busy_s"]))
    assert rows["serve.batch"]["host_self_ms"] == pytest.approx(0.0)
    assert rows["serve.copy_in"]["host_self_ms"] == pytest.approx(1.5e3)
    fake(TRAIN)
    # data [0.2, 1]; the step outside data [3, 4] and [6, 8]
    assert read("idle_data_pct.train", ctx) == pytest.approx(8.0)
    assert read("idle_step_pct.train", ctx) == pytest.approx(30.0)
    assert spans.idle_pct(ctx, None) == pytest.approx(2.0)


def test_device_ms_is_the_mean_over_the_slice(fake):
    ctx = {"trace": TRACE}
    fake(SERVE)
    assert read("project_ms.serve", ctx) == pytest.approx(4.0)
    assert read("knn_ms.serve", ctx) is None
    fake(TRAIN)
    assert read("proto_ms.train", ctx) == pytest.approx(0.25)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, fake, monkeypatch):
    assert read(name, {}) is None              # no traced slice
    fake([])
    assert read(name, {"trace": TRACE}) is None
    # a program older than its spans
    monkeypatch.delattr(profiling, "traced_spans")
    assert read(name, {"trace": TRACE}) is None


@pytest.mark.parametrize("workload", ["salsanext-kitti.serve-b8",
                                      "sqsgv3_21-kitti.train-b4"])
def test_a_traced_cpu_run_reads_them_and_leaves_the_others(
        workload, monkeypatch):
    from test_bench_runs import run

    seen = {}
    read_per_layer = harness.read_per_layer

    def keep(man, wl, ctx, root=ROOT):
        seen.update(ctx)
        return read_per_layer(man, wl, ctx, root)

    monkeypatch.setattr(harness, "read_per_layer", keep)
    res = run(workload, trace=True)
    assert res["correct"], res["checks"]
    man = harness.manifest()
    wl = harness.cell(man, workload)
    mine = {m["name"] for m in harness.per_layer(man, wl)} & set(NEW)
    read_ = {k: v["value"] for k, v in res["metrics"].items()}
    # no card: no device operations, so no idle share; device times are
    # the host's, since the work ran inside the spans
    assert {n for n in mine if "_ms." in n} <= set(read_)
    assert not {n for n in read_ if n.startswith("idle_")}
    # the same slice without the program's spans reads the rest alike
    monkeypatch.delattr(profiling, "traced_spans")
    before = read_per_layer(man, wl, seen)
    assert {k: v["value"] for k, v in before.items()} == {
        k: v for k, v in read_.items() if k not in NEW}
