"""Seeded synthetic LiDAR scans: the benchmark's frozen scan generator.

A copy of the program's ``data/synthetic.py:synthetic_scan`` and
``pad_points`` as they stood when the benchmark was defined, kept here so
that a change to the program cannot change the inputs it is measured on.
``angular`` sets how points fall on the range image: ``grid`` is
beam-structured like a rotating scanner (rows of near-regular azimuth
steps with sub-pixel jitter), ``uniform`` draws i.i.d. angles, and
``clustered`` puts 60 % of the points into 2-pixel blobs (the most pixel
conflicts). Labels follow elevation bands with 10 % flipped; a
``weak_ratio`` share of the points carries its label as the weak label.

A mix's point counts are a fixed set spread evenly over its range, which
each seed shuffles, so every seed does the same work in another order.
"""

from __future__ import annotations

import numpy as np


def synthetic_scan(rng: np.random.Generator, n_points: int, n_classes: int,
                   sensor: dict, weak_ratio: float = 0.001,
                   angular: str = "uniform") -> dict:
    yaw_lo, yaw_hi = np.radians(sensor["fov_left"]), np.radians(
        sensor["fov_right"])
    pit_lo, pit_hi = np.radians(sensor["fov_down"]), np.radians(
        sensor["fov_up"])
    if angular == "uniform":
        yaw = rng.uniform(yaw_lo, yaw_hi, n_points)
        pitch = rng.uniform(pit_lo, pit_hi, n_points)
    elif angular == "grid":
        h = sensor["proj_h"]
        row = np.arange(n_points) % h
        per_row = -(-n_points // h)
        rank = np.arange(n_points) // h
        u = (rank + rng.uniform(0.2, 0.8, n_points)) / per_row
        v = (row + rng.uniform(0.2, 0.8, n_points)) / h
        yaw = yaw_lo + u * (yaw_hi - yaw_lo)
        pitch = pit_lo + v * (pit_hi - pit_lo)
    elif angular == "clustered":
        k = max(8, n_points // 3000)
        n_bg = int(n_points * 0.4)
        n_cl = n_points - n_bg
        cu, cv = rng.uniform(0, 1, k), rng.uniform(0, 1, k)
        blob = rng.integers(0, k, n_cl)
        u = np.concatenate([
            rng.uniform(0, 1, n_bg),
            (cu[blob] + rng.normal(0, 2.0 / sensor["proj_w"], n_cl)) % 1.0])
        v = np.concatenate([
            rng.uniform(0, 1, n_bg),
            np.clip(cv[blob] + rng.normal(0, 2.0 / sensor["proj_h"], n_cl),
                    0.0, 1.0 - 1e-6)])
        perm = rng.permutation(n_points)
        u, v = u[perm], v[perm]
        yaw = yaw_lo + u * (yaw_hi - yaw_lo)
        pitch = pit_lo + v * (pit_hi - pit_lo)
    else:
        raise ValueError(f"unknown angular distribution: {angular!r}")
    depth = rng.gamma(shape=2.0, scale=8.0, size=n_points).clip(1.5, 80.0)
    x = depth * np.cos(pitch) * np.cos(-yaw)
    y = depth * np.cos(pitch) * np.sin(-yaw)
    z = depth * np.sin(pitch)
    intensity = rng.uniform(0.0, 1.0, n_points)
    points = np.stack([x, y, z, intensity], axis=1).astype(np.float32)
    bands = np.clip(((pitch - pit_lo) / (pit_hi - pit_lo)
                     * (n_classes - 1)).astype(np.int32),
                    0, n_classes - 2) + 1
    flip = rng.random(n_points) < 0.1
    labels = np.where(flip, rng.integers(1, n_classes, n_points),
                      bands).astype(np.int32)
    weak = np.zeros(n_points, dtype=np.int32)
    n_weak = max(1, int(round(n_points * weak_ratio)))
    idx = rng.choice(n_points, size=n_weak, replace=False)
    weak[idx] = labels[idx]
    return {"points": points, "labels": labels, "weak_labels": weak}


def pad_points(arr: np.ndarray, max_points: int, fill=0):
    n = arr.shape[0]
    if n > max_points:
        raise ValueError(f"scan has {n} > max_points={max_points}")
    out = np.full((max_points,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    valid = np.zeros(max_points, dtype=bool)
    valid[:n] = True
    return out, valid


def point_counts(n: int, lo: int, hi: int, rng: np.random.Generator):
    """``n`` counts spread evenly over [lo, hi], in an order from ``rng``."""
    return rng.permutation(np.linspace(lo, hi, n).round().astype(int))


def scans(seed: int, stream: int, n: int, mix: dict, cfg: dict) -> list[dict]:
    """``n`` scans of a mix for one seed, with the configuration's classes,
    sensor and weak-label share; ``stream`` keeps the scans of different
    uses (a pool, a calibration batch) apart."""
    rng = np.random.default_rng((seed, stream))
    counts = point_counts(n, mix["points_min"], mix["points_max"], rng)
    return [synthetic_scan(np.random.default_rng((seed, stream, i)), int(c),
                           cfg["data"]["n_classes"], cfg["sensor"],
                           cfg["data"]["weak_ratio"], mix["angular"])
            for i, c in enumerate(counts)]
