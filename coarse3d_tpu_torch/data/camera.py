"""Lidar -> camera-plane projection chains (image-fusion variants): the
port's whole-module copy of the JAX package's ``data/camera.py``, host-side
numpy.

Behavioral model: the optional camera paths of the reference datasets,
SemanticKITTI ``read_calib`` / ``mapLidar2Camera`` and nuScenes
``mapLidar2Camera``. No shipped reference config exercises them (they feed
image-fusion model variants); the nuScenes devkit / pyquaternion
dependencies are replaced by plain transforms driven from manifest records.

Reference quirks preserved exactly:
  - KITTI compares camera-plane x against ``img_h`` and y against ``img_w``
    (callers pass (img_h, img_w) in the reference's order);
  - both return points ``fliplr``'d to (row, col) order and a keep mask over
    the ORIGINAL point array.
"""

from __future__ import annotations

import numpy as np


def read_kitti_calib(calib_path: str) -> dict[str, np.ndarray]:
    """calib.txt -> {"P2": (3, 4), "Tr": (4, 4)} (dataset_semkitti.py:199-218)."""
    calib_all = {}
    with open(calib_path) as f:
        for line in f:
            if line == "\n":
                break
            key, value = line.split(":", 1)
            calib_all[key] = np.array([float(x) for x in value.split()])
    out = {"P2": calib_all["P2"].reshape(3, 4), "Tr": np.identity(4)}
    out["Tr"][:3, :4] = calib_all["Tr"].reshape(3, 4)
    return out


def kitti_proj_matrix(calib: dict[str, np.ndarray]) -> np.ndarray:
    """(3, 4) lidar->image-plane matrix: P2 @ Tr (dataset_semkitti.py:122)."""
    return np.matmul(calib["P2"], calib["Tr"])


def kitti_lidar_to_camera(
    proj_matrix: np.ndarray,
    pointcloud: np.ndarray,
    img_h: int,
    img_w: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Project forward-hemisphere points to the left camera plane.

    Returns ((K, 2) row-col points, (N,) keep mask) —
    dataset_semkitti.py:284-309 semantics (including its x<img_h / y<img_w
    bound quirk).
    """
    keep_mask = pointcloud[:, 0] > 0
    hcoord = np.concatenate(
        [pointcloud[keep_mask, :3],
         np.ones([int(keep_mask.sum()), 1], dtype=np.float32)], axis=1)
    mapped = (proj_matrix @ hcoord.T).T  # (k, 3)
    mapped = mapped[:, :2] / np.expand_dims(mapped[:, 2], axis=1)
    keep_idx = (
        (mapped[:, 0] > 0) * (mapped[:, 0] < img_h)
        * (mapped[:, 1] > 0) * (mapped[:, 1] < img_w))
    keep_mask[keep_mask] = keep_idx
    mapped = np.fliplr(mapped)
    return mapped[keep_idx], keep_mask


def quaternion_rotation_matrix(q) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> (3, 3) rotation matrix (replaces
    pyquaternion.Quaternion(...).rotation_matrix)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def view_points(points: np.ndarray, intrinsic: np.ndarray,
                normalize: bool = True) -> np.ndarray:
    """(3, N) camera-frame points -> (3, N) image-plane points — the
    nuscenes-devkit `view_points` contract used at
    dataset_nuscenes.py:409-411."""
    viewpad = np.eye(4)
    viewpad[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
    n = points.shape[1]
    pts = np.concatenate([points, np.ones((1, n))])
    pts = (viewpad @ pts)[:3]
    if normalize:
        pts = pts / pts[2:3].repeat(3, 0).reshape(3, n)
    return pts


def nuscenes_lidar_to_camera(
    points: np.ndarray,
    lidar_calib: dict,
    lidar_pose: dict,
    cam_pose: dict,
    cam_calib: dict,
    img_h: int,
    img_w: int,
    min_dist: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Five-step nuScenes chain (dataset_nuscenes.py:376-426): lidar frame
    -> ego(t_lidar) -> global -> ego(t_cam) -> camera -> image plane.

    Each record is {"rotation": (w, x, y, z), "translation": (3,)};
    `cam_calib` additionally carries "camera_intrinsic" (3, 3). These are
    verbatim nuScenes v1.0 table rows (manifest-friendly; no devkit).

    Returns ((K, 2) row-col points, (N,) keep mask).
    """
    pc = np.asarray(points[:, :3], dtype=np.float64).T  # (3, n)

    pc = quaternion_rotation_matrix(lidar_calib["rotation"]) @ pc
    pc = pc + np.asarray(lidar_calib["translation"])[:, None]
    pc = quaternion_rotation_matrix(lidar_pose["rotation"]) @ pc
    pc = pc + np.asarray(lidar_pose["translation"])[:, None]

    pc = pc - np.asarray(cam_pose["translation"])[:, None]
    pc = quaternion_rotation_matrix(cam_pose["rotation"]).T @ pc
    pc = pc - np.asarray(cam_calib["translation"])[:, None]
    pc = quaternion_rotation_matrix(cam_calib["rotation"]).T @ pc

    depths = pc[2, :]
    mapped = view_points(pc, np.asarray(cam_calib["camera_intrinsic"]),
                         normalize=True)
    mask = np.ones(depths.shape[0], dtype=bool)
    mask &= depths > min_dist
    mask &= (mapped[0, :] > 1) & (mapped[0, :] < img_h - 1)
    mask &= (mapped[1, :] > 1) & (mapped[1, :] < img_w - 1)
    out = np.fliplr(mapped.transpose(1, 0)[:, :2])
    return out[mask, :], mask
