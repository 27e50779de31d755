"""Plain NumPy training sample: augmentation, projection, label images.

What the COARSE3D reference's SemanticKITTI loader makes of a raw scan
(``wss_sem_kitti_loader.py``: augment, project on the host with the
nearest point winning each pixel, scatter the full and the weak labels
into images, re-project with the weak points forced nearest when
occlusion hid every weak pixel, 5-channel features, pad the per-point
arrays). The augmentation draws from ``np.random.default_rng((seed,
epoch, index))`` in the reference augmentor's order, which is how the
benchmark seeds the program's pipeline; nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

KEYS = ("features", "train_label", "eval_label", "point_px", "point_py",
        "point_depth", "point_label", "point_weak_label", "point_valid")


def _rotation(yaw, pitch, roll):
    z, y, x = np.radians([yaw, pitch, roll])
    rz = np.array([[np.cos(z), -np.sin(z), 0], [np.sin(z), np.cos(z), 0],
                   [0, 0, 1]])
    ry = np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0],
                   [-np.sin(y), 0, np.cos(y)]])
    rx = np.array([[1, 0, 0], [0, np.cos(x), -np.sin(x)],
                   [0, np.sin(x), np.cos(x)]])
    return rx @ ry @ rz


def augment(points: np.ndarray, a: dict, rng: np.random.Generator):
    pts = points.copy()
    if rng.uniform() < a["p_flipx"]:
        pts[:, 0] = -pts[:, 0]
    if rng.uniform() < a["p_flipy"]:
        pts[:, 1] = -pts[:, 1]
    t = np.zeros(3)
    for i, ax in enumerate("xyz"):
        if rng.uniform() < a[f"p_trans{ax}"]:
            t[i] = rng.uniform(a[f"trans_{ax}min"], a[f"trans_{ax}max"])
    pts[:, :3] += t
    angles = {"roll": 0.0, "pitch": 0.0, "yaw": 0.0}
    for name in ("roll", "pitch", "yaw"):
        if rng.uniform() < a[f"p_rot_{name}"]:
            lo, hi = sorted((a[f"rot_{name}min"], a[f"rot_{name}max"]))
            angles[name] = rng.uniform(lo, hi)
    if any(angles.values()):
        rot = _rotation(angles["yaw"], angles["pitch"], angles["roll"])
        pts[:, :3] = pts[:, :3].astype(np.float64) @ rot.T
    return pts


def project(points: np.ndarray, sensor: dict, depth: np.ndarray | None = None):
    if depth is None:
        depth = np.linalg.norm(points[:, :3], 2, axis=1)
    down = np.radians(sensor["fov_down"])
    vert = np.radians(abs(sensor["fov_up"])) + abs(down)
    left = np.radians(sensor["fov_left"])
    hori = abs(left) + np.radians(abs(sensor["fov_right"]))
    h, w = sensor["proj_h"], sensor["proj_w"]
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    pitch = np.arcsin(np.clip(points[:, 2] / np.maximum(depth, 1e-12), -1, 1))
    px = np.clip(np.floor((yaw + abs(left)) / hori * w), 0, w - 1
                 ).astype(np.int32)
    py = np.clip(np.floor((1.0 - (pitch + abs(down)) / vert) * h), 0, h - 1
                 ).astype(np.int32)
    # nearest wins; among equal depths the lowest index (written last)
    order = np.lexsort((-np.arange(len(depth)), -depth))
    idx = np.full((h, w), -1, np.int32)
    idx[py[order], px[order]] = order
    return idx, px, py, depth.astype(np.float32)


def sample(scan: dict, sensor: dict, max_points: int, aug: dict,
           rng: np.random.Generator) -> dict:
    points = augment(scan["points"], aug, rng)
    labels, weak = scan["labels"], scan["weak_labels"]
    idx, px, py, depth = project(points, sensor)
    hit = idx >= 0
    rows = np.where(hit, idx, 0)
    eval_img = np.where(hit, labels[rows], 0).astype(np.int32)
    train_img = np.where(hit, weak[rows], 0).astype(np.int32)
    if (train_img > 0).sum() == 0 and (weak > 0).any():
        forced = np.linalg.norm(points[:, :3], axis=1)
        forced[weak < 1] = 10000.0
        idx2, _, _, _ = project(points, sensor, forced)
        train_img = np.where(idx2 >= 0, weak[np.where(idx2 >= 0, idx2, 0)],
                             0).astype(np.int32)
    img = np.where(hit[..., None], points[rows], -1.0).astype(np.float32)
    rng_img = np.where(hit, depth[rows], -1.0).astype(np.float32)
    inten = np.where(img[..., 3] == -1.0, 0.0, img[..., 3])
    feats = np.concatenate([rng_img[..., None], img[..., :3], inten[..., None]],
                           -1).astype(np.float32)
    n = len(points)

    def pad(a, fill=0):
        out = np.full((max_points,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    valid = np.zeros(max_points, bool)
    valid[:n] = True
    return {"features": feats, "train_label": train_img,
            "eval_label": eval_img, "point_px": pad(px), "point_py": pad(py),
            "point_depth": pad(depth, -1.0),
            "point_label": pad(labels.astype(np.int32)),
            "point_weak_label": pad(weak.astype(np.int32)),
            "point_valid": valid}


def batch(scans: list, sensor: dict, max_points: int, aug: dict, seed: int,
          epoch: int, indices) -> dict:
    samples = [sample(scans[i], sensor, max_points, aug,
                      np.random.default_rng((seed, epoch, int(i))))
               for i in indices]
    return {k: np.stack([s[k] for s in samples]) for k in KEYS}
