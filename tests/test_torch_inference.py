"""Port serving path (coarse3d_tpu_torch.eval.inference, tools/infer.py) vs
the JAX package, on the CPU: the same JAX-initialised weights and the same
synthetic scans through JAX ``make_inference_fn`` and the port's; per-point
labels agree on >= 0.999 of points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs.config import preset as jax_preset
from coarse3d_tpu.eval.inference import make_inference_fn as jax_inference_fn
from coarse3d_tpu.eval.unproject import unproject_image as jax_unproject
from coarse3d_tpu.train.setup import build_model as jax_build_model
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data.synthetic import pad_points, synthetic_scan
from coarse3d_tpu_torch.eval.inference import make_inference_fn
from coarse3d_tpu_torch.eval.unproject import unproject_image
from coarse3d_tpu_torch.tools.convert_jax_params import state_dict_from_jax
from coarse3d_tpu_torch.train.setup import build_model

B, P = 2, 4096


def _bn_randomized(variables, rng):
    """Non-trivial BN statistics, so the carried batch_stats matter."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
        return out
    return {"params": jax.device_get(variables["params"]),
            "batch_stats": walk(jax.device_get(variables["batch_stats"]))}


@pytest.fixture(scope="module")
def served():
    jcfg = jax_preset("tiny")
    jmodel = jax_build_model(jcfg)
    variables = jmodel.init(
        {"params": jax.random.key(0)},
        jnp.zeros((B, jcfg.sensor.proj_h, jcfg.sensor.proj_w, 5)),
        train=False, return_feat=True)
    variables = _bn_randomized(variables, np.random.default_rng(0))

    cfg = preset("tiny")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)

    rng = np.random.default_rng(1)
    pts, valid = [], []
    for n in (3500, 4096):
        scan = synthetic_scan(rng, n, cfg.data.n_classes, cfg.sensor)
        pp, vv = pad_points(scan["points"], P, fill=0.0)
        pts.append(pp)
        valid.append(vv)
    return jcfg, jmodel, variables, cfg, model, np.stack(pts), np.stack(valid)


@pytest.mark.parametrize("use_knn", [True, False])
def test_inference_matches_jax(served, use_knn):
    jcfg, jmodel, variables, cfg, model, pts, valid = served
    want = np.asarray(jax_inference_fn(jmodel, variables, jcfg,
                                       use_knn=use_knn)(
        jnp.asarray(pts), jnp.asarray(valid)))
    got = make_inference_fn(model, cfg, use_knn=use_knn)(
        torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    assert got.shape == (B, P) and got.dtype == np.int32
    lo = 1 if use_knn else 0
    assert got.min() >= lo and got.max() <= cfg.data.n_classes - 1
    rate = (got == want).mean()
    print(f"end-to-end agreement (use_knn={use_knn}) {rate}")
    assert rate >= 0.999, rate
    assert len(np.unique(want)) > 1   # the weights give a non-trivial map


def test_unproject_matches_jax():
    rng = np.random.default_rng(5)
    image = rng.normal(size=(2, 16, 64, 3)).astype(np.float32)
    px = rng.integers(0, 64, (2, 300)).astype(np.int32)
    py = rng.integers(0, 16, (2, 300)).astype(np.int32)
    want = np.asarray(jax_unproject(jnp.asarray(image), jnp.asarray(px),
                                    jnp.asarray(py)))
    got = unproject_image(torch.from_numpy(image), torch.from_numpy(px),
                          torch.from_numpy(py)).numpy()
    np.testing.assert_array_equal(got, want)


def test_infer_cli(tmp_path):
    """Two tiny .bin scans -> .label files of the right length and ids."""
    from coarse3d_tpu_torch.tools.infer import main

    cfg = preset("tiny")
    rng = np.random.default_rng(3)
    scans = []
    for i, n in enumerate((1200, 2500)):
        path = tmp_path / f"{i:06d}.bin"
        synthetic_scan(rng, n, 8, cfg.sensor)["points"].tofile(path)
        scans.append((path, n))
    weights = tmp_path / "model.pth"
    torch.save(build_model(cfg, device="cpu", seed=2).state_dict(), weights)
    out = tmp_path / "preds"
    main(["--preset", "tiny", "--weights", str(weights), "--device", "cpu",
          "--scans", *[str(p) for p, _ in scans], "--out", str(out),
          "--batch_size", "1"])
    for path, n in scans:
        pred = np.fromfile(out / (path.stem + ".label"), dtype=np.int32)
        assert pred.shape == (n,)
        assert pred.min() >= 1 and pred.max() <= cfg.data.n_classes - 1


def test_infer_cli_raw_ids_and_no_knn(tmp_path):
    """A dataset with a label map writes raw ids; --no_knn still runs."""
    from coarse3d_tpu_torch.data.label_maps import get_label_spec
    from coarse3d_tpu_torch.tools.infer import main

    cfg = preset("tiny")
    kitti_tiny = ["--set", "data.dataset=semantic_kitti",
                  "--set", "data.n_classes=20"]
    path = tmp_path / "000000.bin"
    synthetic_scan(np.random.default_rng(4), 1000, 8, cfg.sensor)[
        "points"].tofile(path)
    kcfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset="semantic_kitti", n_classes=20))
    weights = tmp_path / "model.pth"
    torch.save(build_model(kcfg, device="cpu").state_dict(), weights)
    raw_ids = set(get_label_spec("semantic_kitti").lut_inv[1:].tolist())
    for extra in ([], ["--no_knn"]):
        out = tmp_path / f"preds{len(extra)}"
        main(["--preset", "tiny", *kitti_tiny, "--weights", str(weights),
              "--device", "cpu", "--scans", str(path), "--out", str(out),
              *extra])
        pred = np.fromfile(out / "000000.label", dtype=np.int32)
        assert pred.shape == (1000,)
        assert set(np.unique(pred).tolist()) <= raw_ids | {0}
