"""The frozen reference against the port at a small size on the CPU, and
the yardstick's counts against the figures the port's records give."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import generate, harness  # noqa: E402
from benchmark.reference import data as rd  # noqa: E402
from benchmark.reference import models as rm  # noqa: E402
from benchmark.reference import serve as rs  # noqa: E402
from benchmark.reference import train as rt  # noqa: E402
from benchmark.roofline import flops, kernels  # noqa: E402

FAMILIES = {"salsanext-kitti": 7.38978e6, "sqsgv3_21-kitti": 9.587956e6}


def small(name: str) -> dict:
    """The configuration at the ``tiny`` preset's sizes, in float32."""
    cfg = copy.deepcopy(harness.config(name))
    cfg["sensor"].update(proj_h=16, proj_w=64)
    cfg["data"].update(max_points=4096, weak_ratio=0.01)
    cfg["contrast"].update(proj_dim=32, sub_proto_size=4,
                           max_pixels_per_class=128, num_anchor=32)
    cfg["model"]["compute_dtype"] = "float32"
    return cfg


def models(name: str, seed: int = 3):
    from coarse3d_tpu_torch.train.setup import build_model

    cfg = small(name)
    ref = rm.build(cfg["model"], cfg["data"]["n_classes"],
                   cfg["contrast"]["proj_dim"])
    harness.make_weights(ref, seed, torch.device("cpu"))
    prog = build_model(harness.program_config(cfg, seed), device="cpu")
    prog.load_state_dict(ref.state_dict())
    return cfg, ref, prog


@pytest.mark.parametrize("name", list(FAMILIES))
def test_parameters_and_names_match_the_port(name):
    cfg, ref, prog = models(name)
    assert list(ref.state_dict()) == list(prog.state_dict())
    full = harness.config(name)
    n = sum(p.numel() for p in rm.build(full["model"], 20, 256).parameters())
    assert n == FAMILIES[name]


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("train", [False, True])
def test_forward_agrees_with_the_port(name, train):
    cfg, ref, prog = models(name)
    torch.manual_seed(0)
    x = torch.randn(2, 5, 16, 64)
    ref.train(train)
    prog.train(train)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    with torch.no_grad():
        a = ref(x, return_feat=True, generator=g1)
        b = prog(x, return_feat=True, generator=g2)
    for key in ("logits", "embedding"):
        torch.testing.assert_close(a[key], b[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_serving_labels_agree_with_the_port(name):
    from coarse3d_tpu_torch.eval.inference import make_inference_fn

    cfg, ref, prog = models(name)
    ref.eval()
    mix = dict(harness.traffic("serve-b8"), points_min=2000,
               points_max=3000)
    scans = generate.scans(4, 0, 3, mix, cfg)
    padded = [generate.pad_points(s["points"], 4096) for s in scans]
    pts = torch.from_numpy(np.stack([p for p, _ in padded]))
    val = torch.from_numpy(np.stack([v for _, v in padded]))
    got = make_inference_fn(prog, harness.program_config(cfg, 4))(pts, val)
    knn = {k: cfg["knn"][k] for k in ("knn", "search", "sigma", "cutoff")}
    want = rs.labels(ref, pts, val, cfg["sensor"], 20, knn)
    agree = float(((got == want) | ~val).float().mean())
    assert agree >= 0.999


@pytest.mark.parametrize("name", list(FAMILIES))
def test_training_step_agrees_with_the_port(name):
    from coarse3d_tpu_torch.data.pipeline import BATCH_KEYS, build_sample
    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import make_train_step
    from benchmark.drivers.train import hyper

    cfg = small(name)
    seed = 5
    pcfg = harness.program_config(cfg, seed)
    mix = dict(harness.traffic("train-b4"), points_min=2000, points_max=3000,
               batch=2, epoch_scans=8)
    scans = generate.scans(seed, 0, 2, mix, cfg)
    host = rd.batch(scans, cfg["sensor"], 4096, cfg["augment"], seed, 0,
                    [0, 1])
    # the port builds the same batch from the same raw scans and draws
    prog_host = [build_sample(s, pcfg.sensor, 4096, pcfg.augment,
                              np.random.default_rng((seed, 0, i)))
                 for i, s in enumerate(scans)]
    for k in ("train_label", "eval_label", "point_px", "point_py"):
        assert np.array_equal(host[k], np.stack([s[k] for s in prog_host]))
    np.testing.assert_allclose(
        host["features"], np.stack([s["features"] for s in prog_host]),
        rtol=1e-5, atol=1e-5)

    ref = rm.build(cfg["model"], 20, 32)
    harness.make_weights(ref, seed, torch.device("cpu"))
    memory = harness.memory_init(20, 4, 32, seed + 1, torch.device("cpu"))
    state = build_state(pcfg, device="cpu", seed=seed, steps_per_epoch=4)  # 8 scans, B=2
    state.model.load_state_dict(ref.state_dict())
    state.prototypes = memory.clone()
    batch = {k: torch.from_numpy(host[k]) for k in BATCH_KEYS}
    ratio = 0.5 * np.log(1 + 1 / 100) / np.log(2)
    step = make_train_step(pcfg, build_alpha(pcfg), with_contrast=True)
    opt = rt.AdamW(ref.parameters())
    gen = torch.Generator().manual_seed(seed + 2)
    hp = hyper(cfg, mix)
    for s in range(2):
        state, met = step(state, batch, ratio)
        loss, memory, grads = rt.step(ref, opt, memory, batch, gen, hp, s)
        for k in ("focal", "lovasz", "contrast", "total"):
            assert abs(float(met["losses"][k]) - loss[k]) <= 1e-4 * abs(loss[k])
        torch.testing.assert_close(state.prototypes, memory, rtol=1e-4,
                                   atol=1e-5)
        if s == 0:
            # the first gradient as AdamW holds it, by leaf norm; leaves
            # whose gradient is rounding alone (a bias ahead of a
            # BatchNorm) left out. Through some 40 BatchNorms with batch
            # statistics the backward loses digits: float32 against
            # float32 in two orders of summation differs by up to about
            # 2 % in a leaf here.
            held = {n: float(state.optimizer.state[p]["exp_avg"].norm())
                    / 0.1 for n, p in state.model.named_parameters()}
            norms = {n: float(g.norm()) for n, g in grads.items()}
            med = float(np.median(list(norms.values())))
            for n, g in norms.items():
                if g > 1e-3 * med:
                    assert abs(held[n] - g) <= 0.05 * max(g, med), n


def test_forward_flops_at_kitti_size():
    s = harness.config("salsanext-kitti")
    q = harness.config("sqsgv3_21-kitti")
    assert round(flops.forward_flops(s) / 1e9, 1) == 124.6
    assert round(flops.forward_flops(q) / 1e9, 1) == 392.3


def test_kernel_bytes_and_ops_at_kitti_size():
    hw = 64 * 2048
    k1, _ = kernels.k1_projection(16, 150000, 4, hw)
    assert round(k1 / 1e6, 1) == 116.3
    k2, ops2 = kernels.k2_knn_vote(16, 150000, hw, 5, 5)
    assert round(k2 / 1e6, 1) == 46.8
    assert round(ops2 / kernels.peaks.FP32_FLOPS * 1e3, 4) == 0.0073
    _, ops3 = kernels.k3_prototypes(16758, 20, 2048, 20, 256)
    assert round(ops3 / 1e9, 3) == 3.608
    _, ops3 = kernels.k3_prototypes(311, 20, 2048, 20, 256)
    assert round(ops3 / 1e9, 3) == 0.067
