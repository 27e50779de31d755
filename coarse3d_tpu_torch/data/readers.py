"""Raw file readers for LiDAR scans and labels (the port's copy of the JAX
package's ``data/readers.py``).

Behavioral model: reference L0 readers —
dataset_semkitti.py (.bin float32 Nx4 scans, .label int32 with 16-bit
semantic/instance split, :232-241), semantic_poss.py (.tag bool per-pixel
position masks), weak .npy labels.
"""

from __future__ import annotations

import numpy as np


def read_kitti_scan(path: str) -> np.ndarray:
    """(N, 4) float32 x, y, z, intensity."""
    scan = np.fromfile(path, dtype=np.float32)
    return scan.reshape(-1, 4)


def read_kitti_label(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(N,) semantic ids (lower 16 bits) and (N,) instance ids (upper)."""
    label = np.fromfile(path, dtype=np.int32).reshape(-1)
    sem = label & 0xFFFF
    inst = label >> 16
    return sem.astype(np.int32), inst.astype(np.int32)


def read_weak_label(path: str) -> np.ndarray:
    """Weak labels saved as .npy by the weak-label generator."""
    arr = np.load(path)
    return np.asarray(arr).reshape(-1).astype(np.int32)


def read_poss_tag(path: str) -> np.ndarray:
    """(N,) bool: row-major range-image position mask (one per point)."""
    return np.fromfile(path, dtype=np.bool_).reshape(-1)


def read_nuscenes_scan(path: str) -> np.ndarray:
    """(N, 4) float32 from nuScenes 5-float records (x y z intensity ring)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return scan[:, :4].copy()


def read_nuscenes_label(path: str) -> np.ndarray:
    """(N,) uint8 lidarseg labels."""
    return np.fromfile(path, dtype=np.uint8).astype(np.int32)
