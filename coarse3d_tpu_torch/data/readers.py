"""Raw file readers for LiDAR scans (the port's copy of the JAX package's
``data/readers.py``, scan readers only).

Behavioral model: reference L0 readers — dataset_semkitti.py (.bin float32
Nx4 scans) and the nuScenes 5-float point records.
"""

from __future__ import annotations

import numpy as np


def read_kitti_scan(path: str) -> np.ndarray:
    """(N, 4) float32 x, y, z, intensity."""
    scan = np.fromfile(path, dtype=np.float32)
    return scan.reshape(-1, 4)


def read_nuscenes_scan(path: str) -> np.ndarray:
    """(N, 4) float32 from nuScenes 5-float records (x y z intensity ring)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return scan[:, :4].copy()
