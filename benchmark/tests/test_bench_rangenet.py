"""The RangeNet reference (``reference/rangenet.py``) against the port at a
small size on the CPU in float32, and its counts at the published size."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark import generate, harness  # noqa: E402
from benchmark.reference import models as rm  # noqa: E402
from benchmark.reference import serve as rs  # noqa: E402
from benchmark.roofline import flops  # noqa: E402
from test_bench_reference import models, small  # noqa: E402

NAME = "rangenet53-kitti"


@pytest.mark.parametrize("layers", [21, 53])
def test_state_dict_names_match_the_port(layers):
    from coarse3d_tpu_torch.train.setup import build_model

    cfg = small(NAME)
    cfg["model"]["layers"] = layers
    ref = rm.build(cfg["model"], 20, cfg["contrast"]["proj_dim"])
    prog = build_model(harness.program_config(cfg, 3), device="cpu")
    assert prog.layers == layers
    assert list(ref.state_dict()) == list(prog.state_dict())


def test_parameters_at_the_published_size():
    model = rm.build(harness.config(NAME)["model"], 20, 256)
    n = sum(p.numel() for p in model.parameters())
    proj = sum(p.numel() for p in model.projector.parameters())
    assert n == 50732340
    # without the contrastive projector: RangeNet++'s published 50.4 M
    assert round((n - proj) / 1e6, 1) == 50.4


@pytest.mark.parametrize("train", [False, True])
def test_forward_agrees_with_the_port(train):
    cfg, ref, prog = models(NAME)
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


def test_serving_labels_agree_with_the_port():
    from coarse3d_tpu_torch.eval.inference import make_inference_fn

    cfg, ref, prog = models(NAME)
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


def test_forward_flops_at_kitti_size():
    got = flops.forward_flops(harness.config(NAME)) / 1e9
    assert got == pytest.approx(719.4, rel=0.01)


def test_float8_reaches_every_convolution():
    cfg, ref, _ = models(NAME)
    ref.eval()
    x = torch.randn(1, 5, 16, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref(x)["logits"]
        rm.set_fp8(ref, True)
        got = ref(x)["logits"]
    convs = [m for m in ref.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    # 52 in the encoder, 15 in the decoder, the head, the projector's 2
    assert len(convs) == 70
    assert all(isinstance(m, rm._Fp8Mixin) and m.fp8 for m in convs)
    assert sum(isinstance(m, rm.ConvTranspose2d) for m in convs) == 5
    assert not torch.equal(got, want)
