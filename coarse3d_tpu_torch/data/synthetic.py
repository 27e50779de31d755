"""Synthetic LiDAR scan fixtures (the port's copy of the JAX package's
``data/synthetic.py``: ``synthetic_scan`` with uniform angles, and
``pad_points``).

The same numpy generator state gives the same scan in both packages, so a
test or a smoke run can feed one scan to both.
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
