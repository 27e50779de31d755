"""The port's small jax-free copies against the JAX package's, on the CPU:
``data/synthetic.py:synthetic_scan``'s angular modes, ``data/camera.py``
and ``utils/tensor_ops.py``.

Tolerances: the copies are numpy, so the same inputs and seeds give
exactly equal outputs; the camera cases of ``tests/test_camera.py`` run on
both modules with that file's own tolerances; ``tensor_ops`` (torch against
jax.numpy) within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs.config import SensorSpec as JaxSensorSpec
from coarse3d_tpu.data import camera as jcam
from coarse3d_tpu.data import synthetic as jsyn
from coarse3d_tpu.utils import tensor_ops as jops
from coarse3d_tpu_torch.configs.config import SensorSpec
from coarse3d_tpu_torch.data import camera as tcam
from coarse3d_tpu_torch.data import synthetic as tsyn
from coarse3d_tpu_torch.ops.projection import range_project_np
from coarse3d_tpu_torch.utils import tensor_ops as tops

SMALL = SensorSpec(proj_h=16, proj_w=64)
CAMERAS = {"jax": jcam, "port": tcam}


# -- synthetic_scan's angular modes ---------------------------------------------

@pytest.mark.parametrize("angular", ["uniform", "grid", "clustered"])
def test_angular_modes_match_jax(angular):
    for n in (600, 7001):
        got = tsyn.synthetic_scan(np.random.default_rng(3), n, 6, SMALL,
                                  weak_ratio=0.01, angular=angular)
        want = jsyn.synthetic_scan(np.random.default_rng(3), n, 6,
                                   JaxSensorSpec(proj_h=16, proj_w=64),
                                   weak_ratio=0.01, angular=angular)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_angular_collision_rates_ordered():
    """As tests/test_data_pipeline.py holds the original: grid loses few
    points to a nearer one, clustered the most; uniform keeps the default
    rng stream; an unknown mode raises."""
    n = 600
    rates = {}
    for angular in ("grid", "uniform", "clustered"):
        scan = tsyn.synthetic_scan(np.random.default_rng(3), n, 6, SMALL,
                                   weak_ratio=0.01, angular=angular)
        assert scan["points"].shape == (n, 4)
        assert scan["labels"].min() >= 1 and scan["labels"].max() <= 5
        assert (scan["weak_labels"] > 0).sum() == 6
        proj = range_project_np(scan["points"], SMALL)
        winner = proj["proj_idx"][proj["py"], proj["px"]]
        rates[angular] = float(np.mean(winner != np.arange(n)))
    assert rates["grid"] < 0.10
    assert rates["grid"] < rates["uniform"] < rates["clustered"]
    a = tsyn.synthetic_scan(np.random.default_rng(5), 200, 4, SMALL)
    b = tsyn.synthetic_scan(np.random.default_rng(5), 200, 4, SMALL,
                            angular="uniform")
    np.testing.assert_array_equal(a["points"], b["points"])
    with pytest.raises(ValueError, match="angular"):
        tsyn.synthetic_scan(np.random.default_rng(0), 100, 4, SMALL,
                            angular="bogus")


# -- data/camera.py: tests/test_camera.py's four cases on both copies -------------

def _write_calib(path):
    # simple pinhole (fx=fy=700, cx=600, cy=180) + a lidar->cam rigid
    p2 = np.array([[700.0, 0, 600, 0], [0, 700, 180, 0], [0, 0, 1, 0]])
    tr = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.05], [1, 0, 0, -0.3]])
    with open(path, "w") as f:
        for key, mat in [("P0", p2), ("P1", p2), ("P2", p2), ("P3", p2),
                         ("Tr", tr)]:
            f.write(f"{key}: " + " ".join(str(v) for v in mat.reshape(-1))
                    + "\n")
    return p2, tr


@pytest.mark.parametrize("impl", sorted(CAMERAS))
def test_kitti_calib_and_projection(impl, tmp_path):
    cam = CAMERAS[impl]
    rng = np.random.default_rng(0)
    p2, tr = _write_calib(tmp_path / "calib.txt")
    calib = cam.read_kitti_calib(str(tmp_path / "calib.txt"))
    np.testing.assert_allclose(calib["P2"], p2)
    np.testing.assert_allclose(calib["Tr"][:3], tr)
    proj = cam.kitti_proj_matrix(calib)
    np.testing.assert_allclose(proj, p2 @ calib["Tr"])

    pts = rng.uniform(-20, 20, (500, 4)).astype(np.float32)
    pts[0, :3] = [10.0, 0.0, 0.0]   # dead ahead -> near principal point
    pts[1, 0] = -5.0                # behind the vehicle -> dropped
    # the reference's bound quirk: x against img_h, y against img_w
    mapped, keep = cam.kitti_lidar_to_camera(proj, pts, img_h=1241,
                                             img_w=376)
    assert keep.shape == (500,)
    assert mapped.shape == (int(keep.sum()), 2)
    assert not keep[1]
    assert keep[0]
    h = np.concatenate([pts[0, :3], [1.0]])
    uv = (proj @ h)[:2] / (proj @ h)[2]
    row = np.flatnonzero(keep).tolist().index(0)
    np.testing.assert_allclose(mapped[row], uv[::-1], rtol=1e-5)  # fliplr
    want = jcam.kitti_lidar_to_camera(proj, pts, img_h=1241, img_w=376)
    for a, b in zip((mapped, keep), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", sorted(CAMERAS))
def test_quaternion_matches_scipy(impl):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(1)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        ours = CAMERAS[impl].quaternion_rotation_matrix(q)  # (w, x, y, z)
        scipys = Rotation.from_quat(
            [q[1], q[2], q[3], q[0]]).as_matrix()            # (x, y, z, w)
        np.testing.assert_allclose(ours, scipys, atol=1e-12)


@pytest.mark.parametrize("impl", sorted(CAMERAS))
def test_view_points_normalizes(impl):
    pts = np.array([[1.0, 2.0], [0.5, -1.0], [2.0, 4.0]])
    k = np.array([[100.0, 0, 50], [0, 100, 30], [0, 0, 1]])
    out = CAMERAS[impl].view_points(pts, k, normalize=True)
    np.testing.assert_allclose(out[2], 1.0)
    np.testing.assert_allclose(out[0, 0], 100 * 1.0 / 2.0 + 50)


@pytest.mark.parametrize("impl", sorted(CAMERAS))
def test_nuscenes_chain_roundtrip(impl):
    """Identity poses collapse the 5-step chain to pure intrinsics; random
    rigid transforms compose to the scipy-verified equivalent."""
    from scipy.spatial.transform import Rotation

    cam = CAMERAS[impl]
    rng = np.random.default_rng(2)
    k = np.array([[800.0, 0, 450], [0, 800, 250], [0, 0, 1]])
    ident = {"rotation": (1.0, 0, 0, 0), "translation": (0.0, 0, 0)}
    cam_calib = dict(ident, camera_intrinsic=k)
    pts = rng.uniform(-1, 1, (400, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(3, 40, 400)  # nuScenes camera looks along +z

    mapped, mask = cam.nuscenes_lidar_to_camera(
        pts, ident, ident, ident, cam_calib, img_h=900, img_w=500)
    assert mask.any()
    direct = cam.view_points(pts[:, :3].astype(np.float64).T, k)
    np.testing.assert_allclose(
        mapped, np.fliplr(direct.T[:, :2])[mask], rtol=1e-9)

    def rand_rec():
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        return {"rotation": tuple(q), "translation": tuple(rng.normal(size=3))}

    lc, lp, cp, cc = rand_rec(), rand_rec(), rand_rec(), rand_rec()
    cc = dict(cc, camera_intrinsic=k)
    mapped2, mask2 = cam.nuscenes_lidar_to_camera(
        pts, lc, lp, cp, cc, img_h=900, img_w=500, min_dist=0.0)

    def rot(rec):
        q = rec["rotation"]
        return Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()

    pc = pts[:, :3].astype(np.float64).T
    pc = rot(lc) @ pc + np.asarray(lc["translation"])[:, None]
    pc = rot(lp) @ pc + np.asarray(lp["translation"])[:, None]
    pc = rot(cp).T @ (pc - np.asarray(cp["translation"])[:, None])
    pc = rot(cc).T @ (pc - np.asarray(cc["translation"])[:, None])
    want = np.fliplr(cam.view_points(pc, k).T[:, :2])
    np.testing.assert_allclose(mapped2, want[mask2], rtol=1e-7)
    other = jcam.nuscenes_lidar_to_camera(
        pts, lc, lp, cp, cc, img_h=900, img_w=500, min_dist=0.0)
    for a, b in zip((mapped2, mask2), other):
        np.testing.assert_array_equal(a, b)


# -- utils/tensor_ops.py ----------------------------------------------------------

def test_tensor_ops_match_jax():
    """As tests/test_aux.py::test_tensor_ops holds the original, and equal
    to it within 1e-6 on the same inputs (default and explicit axes, a
    partial mask, an empty mask)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8)).astype(np.float32)
    n = tops.minmax_normalize(torch.from_numpy(x))
    assert abs(float(n.max()) - 1.0) < 1e-6
    assert abs(float(n.min())) < 1e-6
    for axis in ((-2, -1), (0,), (1, 2)):
        np.testing.assert_allclose(
            tops.minmax_normalize(torch.from_numpy(x), axis=axis).numpy(),
            np.asarray(jops.minmax_normalize(jnp.asarray(x), axis=axis)),
            rtol=0, atol=1e-6)

    probs = torch.full((4, 4, 5), 0.2)
    ent = tops.masked_mean_entropy(probs, torch.ones((4, 4), dtype=torch.bool))
    np.testing.assert_allclose(float(ent), np.log(5), rtol=1e-5)
    p = rng.dirichlet(np.ones(5), size=(3, 6)).astype(np.float32)
    for mask in (rng.random((3, 6)) < 0.5, np.zeros((3, 6), bool)):
        got = tops.masked_mean_entropy(torch.from_numpy(p),
                                       torch.from_numpy(mask))
        want = jops.masked_mean_entropy(jnp.asarray(p), jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-6)
