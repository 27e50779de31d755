"""Whole runs on the CPU at a small size, with the look for a card skipped:
a sound run is correct; each fault a cell can have, planted in the timed
path, and the lower-precision control come out not correct."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control, harness  # noqa: E402
from benchmark import run as brun  # noqa: E402

SERVE = ["salsanext-kitti.serve-b8", "sqsgv3_21-kitti.serve-b8"]
TRAIN = ["sqsgv3_21-kitti.train-b4"]


def small_cfg(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["sensor"].update(proj_h=16, proj_w=64)
    cfg["data"].update(max_points=4096, weak_ratio=0.01)
    cfg["contrast"].update(proj_dim=32, sub_proto_size=4,
                           max_pixels_per_class=128, num_anchor=32)
    cfg["model"]["compute_dtype"] = "float32"
    return cfg


def small_mix(mix):
    mix = dict(mix, points_min=2000, points_max=3000)
    if mix["driver"] == "serve":
        mix.update(batch=2, pool_batches=2, warmup_batches=1, trace_batches=2)
    else:
        mix.update(batch=2, catalog=8, workers=2, warmup_steps=1,
                   trace_steps=2)
    return mix


def run(workload, hooks=None, trace=False, seed=2**31 + 11):
    torch.set_num_threads(2)
    return brun.run_cell(workload, seed, 1.0, trace, device="cpu",
                         hooks=hooks, cfg_patch=small_cfg,
                         mix_patch=small_mix)


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_sound_run_is_correct(workload):
    res = run(workload, trace=workload in TRAIN)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(harness.limits(workload))


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("batch,slot", [(2, 0), (8, 3)],
                         ids=["slot_0_of_2", "slot_3_of_8"])
def test_altered_answer_is_caught(workload, batch, slot):
    """One scan of the batch served with every label altered; in a batch
    of eight that is an eighth of the points, which the batch's total may
    let pass on a sensitive seed, and the scan's own ratio does not."""
    from coarse3d_tpu_torch.eval.inference import make_inference_fn

    def altered(model, cfg):
        infer = make_inference_fn(model, cfg)

        def wrong(points, valid):
            labels = infer(points, valid).clone()
            labels[slot] = labels[slot] % (cfg.data.n_classes - 1) + 1
            return labels
        return wrong

    torch.set_num_threads(2)
    res = brun.run_cell(workload, 2**31 + 11, 1.0, False, device="cpu",
                        hooks={"make_inference_fn": altered},
                        cfg_patch=small_cfg,
                        mix_patch=lambda m: dict(small_mix(m), batch=batch))
    assert not res["correct"], res["checks"]
    scan = res["checks"]["scan_mismatch_rel_max"]
    assert scan["value"] > scan["limit"], res["checks"]


def test_one_wrong_slot_passes_the_total_but_not_the_scan_on_a_sensitive_seed():
    """The case the batch's total cannot see: float8 flips 30 % of every
    scan's labels, the program 2 %, and one slot of eight is all wrong:
    the total's ratio stays under its limit, the scan's does not."""
    from benchmark.drivers import serve

    gen = torch.Generator().manual_seed(3)
    n, p = 8, 1000
    want = torch.randint(1, 20, (n, p), generator=gen)

    def flip(share, rows=range(n)):
        out = want.clone()
        for r in rows:
            k = int(share * p)
            out[r, :k] = out[r, :k] % 19 + 1
        return out

    got = flip(0.02)
    got[3] = want[3] % 19 + 1
    valid = np.ones((n, p), dtype=bool)
    pool = [(None, valid)]
    numbers = serve.mismatch_numbers({0: got}, {0: want}, {0: flip(0.3)},
                                     pool)
    lim = harness.limits("salsanext-kitti.serve-b8")
    assert numbers["label_mismatch_rel"] < lim["label_mismatch_rel"]["limit"]
    assert (numbers["scan_mismatch_rel_max"]
            > lim["scan_mismatch_rel_max"]["limit"])


def _trainer_with(wrap):
    from coarse3d_tpu_torch.train.trainer import Trainer

    class Broken(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self._step_contrast = wrap(self._step_contrast)
    return Broken


def unchanged(step):
    def run_step(state, batch, ratio):
        model = copy.deepcopy(state.model.state_dict())
        opt = copy.deepcopy(state.optimizer.state_dict())
        protos = state.prototypes.clone()
        state, metrics = step(state, batch, ratio)
        state.model.load_state_dict(model)
        state.optimizer.load_state_dict(opt)
        state.prototypes = protos
        return state, metrics
    return run_step


def half_batch(step):
    def run_step(state, batch, ratio):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step(state, half, ratio)
    return run_step


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_training_fault_is_caught(workload, fault):
    res = run(workload, {"trainer_cls": _trainer_with(fault)})
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_lower_precision_control_is_not_correct(workload):
    torch.set_num_threads(2)
    lim = harness.limits(workload)
    got = control.readings(workload, 7, "cpu", cfg_patch=small_cfg,
                           mix_patch=small_mix)
    numbers = got["fp8"]
    assert any(numbers[n] > lim[n]["limit"] for n in lim), numbers
