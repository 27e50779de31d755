"""Port projection (coarse3d_tpu_torch.ops.projection / proj_scatter) vs the
JAX package, on the CPU: the scatter-min twin of kernel K1 against the JAX
Pallas kernel in interpret mode, and the whole batched projection against
JAX ``range_project_batch``. The CUDA kernel itself is held against the twin
on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs.config import SensorSpec as JaxSensorSpec
from coarse3d_tpu.ops import projection as jproj
from coarse3d_tpu.ops.pallas.proj_scatter import _scatter_min_pallas
from coarse3d_tpu_torch.configs.config import SensorSpec
from coarse3d_tpu_torch.data.synthetic import pad_points, synthetic_scan
from coarse3d_tpu_torch.ops import projection as tproj
from coarse3d_tpu_torch.ops.proj_scatter import (
    BIG,
    scatter_min,
    scatter_min_reference,
)

HW = 1024


def _stream(rng, b, p, tie_values):
    """Flat pixel ids (some >= HW: dropped) and depths; with tie_values the
    depths come from a small set, so many pixels see exact-depth ties."""
    flat = rng.integers(0, HW + HW // 8, (b, p)).astype(np.int32)
    if tie_values:
        depth = rng.choice(np.linspace(1.0, 50.0, tie_values), (b, p))
    else:
        depth = rng.uniform(0.5, 80.0, (b, p))
    return flat, depth.astype(np.float32)


@pytest.mark.parametrize("tie_values", [0, 7, 40])
def test_scatter_min_twin_equals_pallas_kernel(tie_values):
    """K1's twin vs _scatter_min_pallas (interpret mode): exact."""
    rng = np.random.default_rng(11 + tie_values)
    b, p = 2, 3000
    flat, depth = _stream(rng, b, p, tie_values)
    want_d, want_w = (np.asarray(a) for a in _scatter_min_pallas(
        jnp.asarray(flat), jnp.asarray(depth), hw=HW, interpret=True))
    got_d, got_w = (t.numpy() for t in scatter_min(
        torch.from_numpy(flat), torch.from_numpy(depth), HW))

    hit = want_w < p       # the JAX kernel marks empty with >= P
    np.testing.assert_array_equal(hit, got_w < p)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(got_d[hit], want_d[hit])
    np.testing.assert_array_equal(got_w[hit], want_w[hit])
    np.testing.assert_array_equal(got_d[~hit], np.float32(BIG))
    np.testing.assert_array_equal(got_w[~hit], p)


def test_scatter_min_ties_go_to_lowest_index():
    flat = torch.tensor([[3, 3, 3, 5, 9]], dtype=torch.int32)
    depth = torch.tensor([[2.0, 1.0, 1.0, 4.0, 1.0]])
    md, win = scatter_min_reference(flat, depth, hw=8)   # pixel 9 dropped
    assert win[0, 3].item() == 1 and md[0, 3].item() == 1.0
    assert win[0, 5].item() == 3
    assert (win[0, [0, 1, 2, 4, 6, 7]] == 5).all()


def test_scatter_min_rejects_bad_inputs():
    flat = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        scatter_min(flat.long(), torch.zeros(2, 4), 8)
    with pytest.raises(ValueError):
        scatter_min(flat, torch.zeros(2, 5), 8)


def _clouds(seed, sensor, b=2, p=4096):
    """Synthetic scans plus off-FOV normal noise, padded to P."""
    rng = np.random.default_rng(seed)
    pts, valid = [], []
    for _ in range(b):
        scan = synthetic_scan(rng, 3000, 8, sensor)["points"]
        noise = rng.normal(0, 8, (500, 4)).astype(np.float32)
        cloud = np.concatenate([scan, noise])
        cloud[2900:2950] = cloud[100:150]      # exact depth ties
        pp, vv = pad_points(cloud, p, fill=0.0)
        pts.append(pp)
        valid.append(vv)
    return np.stack(pts), np.stack(valid)


SENSORS = {
    "tiny": dict(proj_h=16, proj_w=64),
    "poss_like": dict(proj_h=10, proj_w=90, fov_up=15.0, max_depth=30.0),
}


@pytest.mark.parametrize("mask_excludes_point0", [False, True])
@pytest.mark.parametrize("sensor_name", sorted(SENSORS))
def test_range_project_batch_matches_jax(sensor_name, mask_excludes_point0):
    """px/py/proj_idx agree on >= 0.999 of entries (torch and XLA atan2 /
    asin / norm may differ by an ulp at a pixel edge); where proj_idx
    agrees, proj_range / proj_points / proj_mask match to rtol 1e-6."""
    kw = SENSORS[sensor_name]
    sensor = SensorSpec(**kw)
    pts, valid = _clouds(5, sensor)
    want = {k: np.asarray(v) for k, v in jproj.range_project_batch(
        jnp.asarray(pts), jnp.asarray(valid), JaxSensorSpec(**kw),
        mask_excludes_point0=mask_excludes_point0).items()}
    got = {k: v.numpy() for k, v in tproj.range_project_batch(
        torch.from_numpy(pts), torch.from_numpy(valid), sensor,
        mask_excludes_point0=mask_excludes_point0).items()}

    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in ("px", "py", "proj_idx"):
        rate = (got[k] == want[k]).mean()
        print(f"{k} agreement {rate}")
        assert rate >= 0.999, (k, rate)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-6)
    same = got["proj_idx"] == want["proj_idx"]
    np.testing.assert_allclose(got["proj_range"][same],
                               want["proj_range"][same], rtol=1e-6)
    np.testing.assert_allclose(got["proj_points"][same],
                               want["proj_points"][same], rtol=1e-6)
    np.testing.assert_array_equal(got["proj_mask"][same],
                                  want["proj_mask"][same])
    if mask_excludes_point0:
        assert not got["proj_mask"][got["proj_idx"] == 0].any()


def test_features_match_jax():
    """build_range_features + normalize_features vs JAX, rtol 1e-6."""
    kw = SENSORS["tiny"]
    sensor = SensorSpec(**kw)
    pts, valid = _clouds(9, sensor)
    jp = jproj.range_project_batch(jnp.asarray(pts), jnp.asarray(valid),
                                   JaxSensorSpec(**kw))
    jfeat = jproj.build_range_features(jp["proj_points"], jp["proj_range"],
                                       xp=jnp)
    want = np.asarray(jproj.normalize_features(
        jfeat, jp["proj_idx"] >= 0, JaxSensorSpec(**kw), xp=jnp))
    # same projection on both sides: isolate the feature math
    proj_points = torch.from_numpy(np.array(jp["proj_points"]))
    proj_range = torch.from_numpy(np.array(jp["proj_range"]))
    feat = tproj.build_range_features(proj_points, proj_range)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=1e-6)
    got = tproj.normalize_features(
        feat, torch.from_numpy(np.array(jp["proj_idx"])) >= 0, sensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
