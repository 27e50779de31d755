"""The port's spans (coarse3d_tpu_torch/utils/profiling.py) on the CPU:
they record only under a profiler, nest on one thread, share their
batch's or step's id, lie on the clock of the profiler's own events, and
the serving path and the Trainer give the named spans of each batch and
step, with the Trainer's DT and PT read from the same clock reads as the
spans' edges."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data.pipeline import DataPipeline
from coarse3d_tpu_torch.data.synthetic import (
    SyntheticDataset,
    pad_points,
    synthetic_scan,
)
from coarse3d_tpu_torch.eval.inference import make_inference_fn
from coarse3d_tpu_torch.train.setup import build_model
from coarse3d_tpu_torch.train.trainer import Trainer
from coarse3d_tpu_torch.utils import Recorder
from coarse3d_tpu_torch.utils.profiling import (
    NO_SPAN,
    add_spans_to_chrome_trace,
    span,
    traced_spans,
)

SERVE = ["serve.batch", "serve.copy_in", "serve.project", "serve.backbone",
         "serve.knn"]
STEP = ["train.step", "train.data", "train.inputs", "train.forward",
        "train.losses", "train.backward", "train.optimizer",
        "train.prototypes", "train.metrics"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def infer_and_batch():
    cfg = preset("tiny")
    model = build_model(cfg, device="cpu")
    scans = [pad_points(synthetic_scan(np.random.default_rng(s), 1500, 8,
                                       cfg.sensor)["points"], 2048)
             for s in range(2)]
    points = torch.from_numpy(np.stack([p for p, _ in scans]))
    valid = torch.from_numpy(np.stack([v for _, v in scans]))
    return make_inference_fn(model, cfg), points, valid


def test_nothing_is_recorded_without_a_profiler(infer_and_batch):
    infer, points, valid = infer_and_batch
    before = [s["id"] for s in traced_spans()]
    assert span("serve.batch") is NO_SPAN
    infer(points, valid)
    assert [s["id"] for s in traced_spans()] == before


def test_spans_nest_and_share_their_request_id():
    with _cpu_profile():
        with span("a", rid=7):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e", rid=8):
            pass
    spans = traced_spans()
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["a", "b", "c", "d", "e"]
    assert by["a"]["parent"] is None and by["e"]["parent"] is None
    assert by["b"]["parent"] == by["d"]["parent"] == by["a"]["id"]
    assert by["c"]["parent"] == by["b"]["id"]
    assert {by[n]["rid"] for n in "abcd"} == {7} and by["e"]["rid"] == 8
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] == pytest.approx(
            (s["end_ns"] - s["start_ns"]) * 1e-6)
    assert by["a"]["start_ns"] <= by["b"]["start_ns"] <= by["c"]["start_ns"]
    assert by["c"]["end_ns"] <= by["b"]["end_ns"] <= by["d"]["start_ns"]
    assert by["d"]["end_ns"] <= by["a"]["end_ns"] <= by["e"]["start_ns"]


def test_a_span_and_the_ops_inside_it_share_one_clock():
    x = torch.randn(64, 64)
    with _cpu_profile() as prof:
        with span("mm"):
            x.mul(2.0)
    (s,) = traced_spans()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul"]
    assert ops
    for e in ops:
        assert s["start_ns"] <= e.start_ns() <= e.end_ns() <= s["end_ns"]


def test_infer_gives_the_serving_spans_of_each_batch(infer_and_batch):
    infer, points, valid = infer_and_batch
    with _cpu_profile():
        for _ in range(2):
            infer(points, valid)
    spans = traced_spans()
    assert [s["name"] for s in spans] == SERVE * 2
    for batch in (spans[:5], spans[5:]):
        root = batch[0]
        assert root["parent"] is None
        assert all(s["parent"] == root["id"] for s in batch[1:])
        assert {s["rid"] for s in batch} == {root["rid"]}
    assert spans[5]["rid"] == spans[0]["rid"] + 1


@pytest.fixture(scope="module")
def traced_epoch(tmp_path_factory):
    """A two-step contrast epoch of the Trainer on the CPU under a CPU
    profiler, its Chrome trace with the spans written in, as the Trainer's
    profile window writes it (tests/test_torch_trainer.py runs the window
    itself)."""
    tmp = tmp_path_factory.mktemp("tracing")
    cfg = preset("tiny")
    cfg = dataclasses.replace(
        cfg, save_path=str(tmp / "run"),
        train=dataclasses.replace(cfg.train, n_epochs=1),
        contrast=dataclasses.replace(cfg.contrast, contrast_warmup=0))
    ds = SyntheticDataset(8, 2000, cfg.data.n_classes, cfg.sensor,
                          weak_ratio=0.01)
    pipe = DataPipeline(ds, cfg, batch_size=4, train=True, num_workers=2)
    trainer = Trainer(cfg, pipe, None, device="cpu",
                      recorder=Recorder(cfg.save_path, enabled=False))
    with _cpu_profile() as prof:
        trainer.run_epoch(0, "Train")
    spans = traced_spans()
    path = str(tmp / "trace.json")
    prof.export_chrome_trace(path)
    add_spans_to_chrome_trace(path, spans)
    return trainer, spans, path


def test_trainer_gives_the_step_spans_in_order(traced_epoch):
    trainer, spans, _ = traced_epoch
    assert trainer.last_epoch_timing["steps"] == 2
    names = [s["name"] for s in spans]
    assert names == STEP + ["train.log"] + STEP
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["train.step"] * 2
    assert [r["rid"] for r in roots] == [0, 1]
    for root, steps in ((roots[0], spans[:10]), (roots[1], spans[10:])):
        assert all(s["parent"] == root["id"] for s in steps[1:])
        assert {s["rid"] for s in steps} == {root["rid"]}
    # one iteration ends where the next begins
    assert roots[0]["end_ns"] == roots[1]["start_ns"]


def test_dt_and_pt_are_read_at_the_spans_edges(traced_epoch):
    trainer, spans, _ = traced_epoch
    t = trainer.last_epoch_timing
    data = [s for s in spans if s["name"] == "train.data"]
    done = [s for s in spans if s["name"] == "train.metrics"]
    (log,) = [s for s in spans if s["name"] == "train.log"]
    # DT of a step holds the log of the step before it (the JAX Trainer's
    # order), PT runs from the end of train.data to the end of train.metrics
    dt = [data[0]["end_ns"] - data[0]["start_ns"],
          data[1]["end_ns"] - log["start_ns"]]
    assert log["end_ns"] == data[1]["start_ns"]
    pt = [m["end_ns"] - d["end_ns"] for d, m in zip(data, done)]
    assert t["data_first_s"] == pytest.approx(dt[0] * 1e-9, rel=1e-12)
    assert t["data_s"] == pytest.approx(np.mean(dt) * 1e-9, rel=1e-12)
    assert t["proc_s"] == pytest.approx(np.mean(pt) * 1e-9, rel=1e-12)
    # the Trainer's accumulators extend the step's own train.metrics
    steps = [s for s in spans if s["name"] == "train.step"]
    assert done[0]["end_ns"] <= log["start_ns"] <= steps[0]["end_ns"]


def test_the_spans_are_written_into_the_chrome_trace(traced_epoch):
    _, spans, path = traced_epoch
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    marked = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    assert [e["name"] for e in marked] == [s["name"] for s in spans]
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops
    first = min(e["ts"] for e in marked)
    last = max(e["ts"] + e["dur"] for e in marked)
    assert marked[0]["ts"] == pytest.approx(
        (spans[0]["start_ns"] - base) / 1e3)
    # the operators of the window lie inside the spans' time on that base
    inside = [e for e in ops if first <= e["ts"] and e["ts"] <= last]
    assert len(inside) > 0.5 * len(ops)
