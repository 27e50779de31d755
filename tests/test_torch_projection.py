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


# -- the fused entry of K1 ----------------------------------------------------

from coarse3d_tpu.ops.pallas.proj_scatter import (  # noqa: E402
    range_project_batch_pallas,
)
from coarse3d_tpu_torch.ops.proj_scatter import (  # noqa: E402
    project_from_winner,
    project_scatter,
    project_scatter_reference,
)


@pytest.mark.parametrize("mask_excludes_point0", [False, True])
def test_project_scatter_reference_equals_pallas_projection(
        mask_excludes_point0):
    """K1's fused twin on JAX's own flat and depth vs
    range_project_batch_pallas (interpret mode): proj_idx, proj_range,
    proj_points and proj_mask exactly equal, with exact-depth ties, empty
    pixels and a winner at point 0."""
    kw = SENSORS["tiny"]
    h, w = kw["proj_h"], kw["proj_w"]
    pts, valid = _clouds(21, SensorSpec(**kw))
    valid[:, 700:] = False        # few enough points that pixels stay empty
    pts[:, 3] = pts[:, 0]         # point 0's twin farther along: 0 wins it
    pts[:, 3, :3] *= 1.5
    want = {k: np.asarray(v) for k, v in range_project_batch_pallas(
        jnp.asarray(pts), jnp.asarray(valid), JaxSensorSpec(**kw),
        mask_excludes_point0=mask_excludes_point0, interpret=True).items()}
    flat = np.where(valid, want["py"] * w + want["px"], h * w).astype(np.int32)
    got = project_scatter(
        torch.from_numpy(flat), torch.from_numpy(want["depth"].copy()),
        torch.from_numpy(pts), h * w, mask_excludes_point0)
    assert (want["proj_idx"] < 0).any() and (want["proj_idx"] == 0).any()
    for k, v in got.items():
        ref = want[k].reshape(v.shape)
        assert v.numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)
    if mask_excludes_point0:
        assert not got["proj_mask"][got["proj_idx"] == 0].any()


def test_project_scatter_is_its_reference_on_cpu_and_checks_inputs():
    rng = np.random.default_rng(3)
    flat, depth = (torch.from_numpy(a) for a in _stream(rng, 2, 500, 7))
    pts = torch.from_numpy(rng.normal(size=(2, 500, 5)).astype(np.float32))
    got = project_scatter(flat, depth, pts, HW, True)
    want = project_scatter_reference(flat, depth, pts, HW, True)
    again = project_from_winner(*scatter_min_reference(flat, depth, HW), pts,
                                True)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(again[k], want[k])
    assert got["proj_points"].shape == (2, HW, 5)
    with pytest.raises(ValueError):
        project_scatter(flat, depth, pts[:, :400], HW)
    with pytest.raises(ValueError):
        project_scatter(flat, depth, pts[0], HW)


def test_key_packing_orders_like_depth_then_index():
    """An int64 numpy mirror of the kernel's key,
    (float32 bits of depth << 32) | index: sorting the keys equals sorting
    by (depth, index), for +0, denormals, equal clamped depths and 3e38."""
    depths = np.array([0.0, 1e-45, 1e-39, 1.1754944e-38, 0.5, 80.0, 80.0,
                       80.0, 3.0e38, 3.0e38, 1.0, 1e-45], np.float32)
    rng = np.random.default_rng(0)
    depth = rng.choice(depths, 4000)
    index = rng.permutation(4000).astype(np.int64)
    key = (depth.view(np.uint32).astype(np.int64) << 32) | index
    assert (key >= 0).all()                 # below the empty key, all ones
    np.testing.assert_array_equal(np.argsort(key, kind="stable"),
                                  np.lexsort((index, depth)))
    # the decode is the inverse
    np.testing.assert_array_equal(
        (key >> 32).astype(np.uint32).view(np.float32), depth)
    np.testing.assert_array_equal(key & 0xFFFFFFFF, index)


def test_sensor_constants_are_made_once_per_device():
    """normalize_features reuses the mean / std tensors: building them on
    every call costs a card a host synchronisation each."""
    sensor = SensorSpec(**SENSORS["tiny"])
    args = (tuple(sensor.img_mean), tuple(sensor.img_stds),
            torch.device("cpu"))
    first = tproj._sensor_stats(*args)
    x = torch.zeros(1, 2, 2, 5)
    tproj.normalize_features(x, torch.ones(1, 2, 2, dtype=torch.bool), sensor)
    assert tproj._sensor_stats(*args)[0] is first[0]
