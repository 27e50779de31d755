"""Synthetic LiDAR scan fixtures (the port's copy of the JAX package's
``data/synthetic.py``: ``synthetic_scan`` with uniform angles,
``synthetic_batch`` and ``pad_points``).

The same numpy generator state gives the same scan, and the same training
batch, in both packages, so a test or a smoke run can feed one batch to
both.
"""

from __future__ import annotations

import numpy as np

from coarse3d_tpu_torch.configs.config import SensorSpec


def synthetic_scan(
    rng: np.random.Generator,
    n_points: int,
    n_classes: int,
    sensor: SensorSpec,
    weak_ratio: float = 0.001,
) -> dict[str, np.ndarray]:
    """One scan: (N, 4) points + full labels + weak labels.

    Angles are i.i.d. uniform inside the sensor's field of view (~35% of
    points lose their pixel to a nearer point at KITTI scale); depths follow
    a gamma(2, 8) clipped to [1.5, 80] m.
    """
    yaw = rng.uniform(np.radians(sensor.fov_left), np.radians(sensor.fov_right),
                      n_points)
    pitch = rng.uniform(np.radians(sensor.fov_down), np.radians(sensor.fov_up),
                        n_points)
    depth = rng.gamma(shape=2.0, scale=8.0, size=n_points).clip(1.5, 80.0)

    x = depth * np.cos(pitch) * np.cos(-yaw)
    y = depth * np.cos(pitch) * np.sin(-yaw)
    z = depth * np.sin(pitch)
    intensity = rng.uniform(0.0, 1.0, n_points)
    points = np.stack([x, y, z, intensity], axis=1).astype(np.float32)

    # Correlate labels with elevation bands so IoU is not pure noise.
    bands = np.clip(
        ((pitch - np.radians(sensor.fov_down))
         / (np.radians(sensor.fov_up) - np.radians(sensor.fov_down))
         * (n_classes - 1)).astype(np.int32),
        0, n_classes - 2) + 1
    flip = rng.random(n_points) < 0.1
    labels = np.where(
        flip, rng.integers(1, n_classes, n_points), bands).astype(np.int32)

    weak = np.zeros(n_points, dtype=np.int32)
    n_weak = max(1, int(round(n_points * weak_ratio)))
    weak_idx = rng.choice(n_points, size=n_weak, replace=False)
    weak[weak_idx] = labels[weak_idx]
    return {"points": points, "labels": labels, "weak_labels": weak}


def synthetic_batch(
    rng: np.random.Generator,
    cfg,
    batch_size: int,
    n_points: int = 20000,
    weak_ratio: float = 0.002,
) -> dict[str, np.ndarray]:
    """Training batch dict exactly as the data pipeline emits it.

    Keys: features (B,H,W,5) raw feature image, train_label / eval_label
    (B,H,W) int32, point_px / point_py (B,P) int32, point_depth (B,P)
    float32 (-1 on padding), point_label / point_weak_label (B,P) int32,
    point_valid (B,P) bool. Projection on the host (numpy), as the pipeline
    does it.
    """
    import torch

    from coarse3d_tpu_torch.ops import projection

    sensor = cfg.sensor
    max_points = cfg.data.max_points
    out = {k: [] for k in (
        "features", "train_label", "eval_label", "point_px", "point_py",
        "point_depth", "point_label", "point_weak_label", "point_valid")}
    for _ in range(batch_size):
        scan = synthetic_scan(
            rng, n_points, cfg.data.n_classes, sensor, weak_ratio)
        proj = projection.range_project_np(scan["points"], sensor)
        feats = projection.build_range_features(
            torch.from_numpy(proj["proj_points"]),
            torch.from_numpy(proj["proj_range"])).numpy()
        out["features"].append(feats)
        out["eval_label"].append(
            projection.scatter_labels_np(proj["proj_idx"], scan["labels"]))
        out["train_label"].append(
            projection.scatter_labels_np(
                proj["proj_idx"], scan["weak_labels"]))
        px, pv = pad_points(proj["px"], max_points)
        depth, _ = pad_points(proj["depth"].astype(np.float32), max_points,
                              fill=-1.0)
        py, _ = pad_points(proj["py"], max_points)
        lbl, _ = pad_points(scan["labels"], max_points)
        wlbl, _ = pad_points(scan["weak_labels"], max_points)
        out["point_px"].append(px)
        out["point_py"].append(py)
        out["point_depth"].append(depth)
        out["point_label"].append(lbl)
        out["point_weak_label"].append(wlbl)
        out["point_valid"].append(pv)
    return {k: np.stack(v) for k, v in out.items()}


def pad_points(
    arr: np.ndarray, max_points: int, fill=0
) -> tuple[np.ndarray, np.ndarray]:
    """Pad (N, ...) to (max_points, ...) returning the validity mask.

    Mirrors the reference's fixed `max_points` padding convention
    (wss_sem_kitti_loader.py:198-222) but with an explicit mask instead of
    the implicit "padded points map to pixel (0, 0)" convention.
    """
    n = arr.shape[0]
    if n > max_points:
        raise ValueError(f"scan has {n} > max_points={max_points}")
    out = np.full((max_points,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    valid = np.zeros(max_points, dtype=bool)
    valid[:n] = True
    return out, valid
