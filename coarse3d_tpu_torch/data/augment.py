"""Point-cloud augmentation (host-side, NumPy).

The port's copy of the JAX package's ``data/augment.py`` (one line differs:
the rotation casts before it multiplies, see below). Behavioral model:
the reference's pc_processor/dataset/preprocess/augmentor.py
(:145-230): probability-gated X/Y flips, per-axis uniform translation, and a
zyx-Euler rotation applied to the raw Nx4 cloud before projection. Uses an
explicit np.random.Generator instead of the global `random` module so the
pipeline is reproducible and per-worker seedable. The reference's inverted
yaw interval (min 5, max -5 — config_semantic_kitti.yaml:126-127) samples the
same distribution under uniform(a, b), preserved.
"""

from __future__ import annotations

import numpy as np

from coarse3d_tpu_torch.configs.config import AugmentConfig


def _euler_zyx_matrix(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Rotation matrix for *extrinsic* z-y-x Euler angles in degrees —
    scipy's lowercase R.from_euler('zyx', [yaw, pitch, roll]) convention
    (rotate about fixed z, then fixed y, then fixed x => Rx @ Ry @ Rz)."""
    z, y, x = np.radians([yaw, pitch, roll])
    cz, sz = np.cos(z), np.sin(z)
    cy, sy = np.cos(y), np.sin(y)
    cx, sx = np.cos(x), np.sin(x)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return rx @ ry @ rz


def augment_pointcloud(
    points: np.ndarray,
    cfg: AugmentConfig,
    rng: np.random.Generator,
) -> np.ndarray:
    """Apply flip / translate / rotate augmentation to an (N, >=3) cloud."""
    pts = points.copy()
    if rng.uniform() < cfg.p_flipx:
        pts[:, 0] = -pts[:, 0]
    if rng.uniform() < cfg.p_flipy:
        pts[:, 1] = -pts[:, 1]

    trans = np.zeros(3)
    if rng.uniform() < cfg.p_transx:
        trans[0] = rng.uniform(cfg.trans_xmin, cfg.trans_xmax)
    if rng.uniform() < cfg.p_transy:
        trans[1] = rng.uniform(cfg.trans_ymin, cfg.trans_ymax)
    if rng.uniform() < cfg.p_transz:
        trans[2] = rng.uniform(cfg.trans_zmin, cfg.trans_zmax)
    pts[:, :3] += trans

    roll = pitch = yaw = 0.0
    if rng.uniform() < cfg.p_rot_roll:
        roll = rng.uniform(cfg.rot_rollmin, cfg.rot_rollmax)
    if rng.uniform() < cfg.p_rot_pitch:
        pitch = rng.uniform(cfg.rot_pitchmin, cfg.rot_pitchmax)
    if rng.uniform() < cfg.p_rot_yaw:
        lo, hi = sorted((cfg.rot_yawmin, cfg.rot_yawmax))
        yaw = rng.uniform(lo, hi)
    if roll or pitch or yaw:
        rot = _euler_zyx_matrix(yaw, pitch, roll)
        # the JAX package's ``pts[:, :3] @ rot.T``: numpy multiplies the
        # strided float32 view by the float64 matrix through a buffered
        # cast, an order of magnitude slower than the product itself and
        # all of it holding the GIL the training loop needs. Casting first
        # gives the same float64 product (tests/test_torch_data.py holds the
        # outputs equal).
        pts[:, :3] = pts[:, :3].astype(np.float64) @ rot.T
    return pts
