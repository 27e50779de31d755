"""Spherical range-image projection on the device (PyTorch).

Port of the JAX package's ``ops/projection.py`` device path
(``pixel_coords``, ``range_project_batch``, ``build_range_features``,
``normalize_features``). Behavioral model: the reference's
RangeProjection.doProjection (preprocess/projection.py:43-115): depth =
||xyz||2, yaw = -atan2(y, x), pitch = asin(z / depth); normalize by FOV,
floor + clamp to W x H pixel coords; the *nearest* point wins each pixel,
ties to the lowest point index.

``range_project_np`` and ``scatter_labels_np`` are the port's copies of the
JAX package's numpy host path (the data pipeline's projection, which the
synthetic training batch uses): the same numpy inputs give the same arrays.

The per-pixel winner, the winner-row gather and the fills are kernel K1
(:func:`ops.proj_scatter.project_scatter`) on a CUDA tensor and its plain
twin on a CPU tensor; the coordinate math before it stays plain tensor ops,
as it stayed XLA outside the TPU kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from coarse3d_tpu_torch.configs.config import SensorSpec
from coarse3d_tpu_torch.ops.proj_scatter import project_scatter


def _fov_params(sensor: SensorSpec) -> tuple[float, float, float, float]:
    fov_down = math.radians(sensor.fov_down)
    fov_vert = math.radians(abs(sensor.fov_up)) + abs(fov_down)
    fov_left = math.radians(sensor.fov_left)
    fov_hori = abs(fov_left) + math.radians(abs(sensor.fov_right))
    return fov_down, fov_vert, fov_left, fov_hori


def pixel_coords(xyz: torch.Tensor, depth: torch.Tensor, sensor: SensorSpec
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point int32 pixel coords (px, py) for a spherical projection."""
    fov_down, fov_vert, fov_left, fov_hori = _fov_params(sensor)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    yaw = -torch.atan2(y, x)
    pitch = torch.asin(torch.clamp(z / torch.clamp_min(depth, 1e-12), -1.0, 1.0))
    proj_x = (yaw + abs(fov_left)) / fov_hori * sensor.proj_w
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov_vert) * sensor.proj_h
    px = torch.clamp(torch.floor(proj_x), 0, sensor.proj_w - 1).to(torch.int32)
    py = torch.clamp(torch.floor(proj_y), 0, sensor.proj_h - 1).to(torch.int32)
    return px, py


def pixel_coords_np(xyz: np.ndarray, depth: np.ndarray, sensor: SensorSpec
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy twin of :func:`pixel_coords` (the JAX package's host path)."""
    fov_down, fov_vert, fov_left, fov_hori = _fov_params(sensor)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    yaw = -np.arctan2(y, x)
    pitch = np.arcsin(np.clip(z / np.maximum(depth, 1e-12), -1.0, 1.0))
    proj_x = (yaw + abs(fov_left)) / fov_hori * sensor.proj_w
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov_vert) * sensor.proj_h
    px = np.clip(np.floor(proj_x), 0, sensor.proj_w - 1).astype(np.int32)
    py = np.clip(np.floor(proj_y), 0, sensor.proj_h - 1).astype(np.int32)
    return px, py


def range_project_np(
    points: np.ndarray,
    sensor: SensorSpec,
    depth: np.ndarray | None = None,
    mask_excludes_point0: bool = True,
) -> dict[str, np.ndarray]:
    """Project an (N, C>=3) cloud to an (H, W) range image on the host,
    nearest wins (the reference's descending-depth last-writer-wins)."""
    if depth is None:
        depth = np.linalg.norm(points[:, :3], 2, axis=1)
    if sensor.max_depth > 0:
        depth = np.minimum(depth, sensor.max_depth)
    px, py = pixel_coords_np(points[:, :3], depth, sensor)

    h, w = sensor.proj_h, sensor.proj_w
    order = np.argsort(depth, kind="stable")[::-1]

    proj_range = np.full((h, w), -1.0, dtype=np.float32)
    proj_range[py[order], px[order]] = depth[order]

    proj_points = np.full((h, w, points.shape[1]), -1.0, dtype=np.float32)
    proj_points[py[order], px[order]] = points[order]

    proj_idx = np.full((h, w), -1, dtype=np.int32)
    proj_idx[py[order], px[order]] = np.arange(len(points))[order]

    if mask_excludes_point0:
        proj_mask = (proj_idx > 0).astype(np.int32)
    else:
        proj_mask = (proj_idx >= 0).astype(np.int32)

    return {
        "proj_points": proj_points,
        "proj_range": proj_range,
        "proj_idx": proj_idx,
        "proj_mask": proj_mask,
        "px": px,
        "py": py,
        "depth": depth.astype(np.float32),
    }


def scatter_labels_np(proj_idx: np.ndarray, point_labels: np.ndarray
                      ) -> np.ndarray:
    """Per-point labels scattered to the image through the projection index
    map (wss_sem_kitti_loader.py:124-132): empty pixels get label 0."""
    out = np.zeros(proj_idx.shape, dtype=np.int32)
    hit = proj_idx > -1
    out[hit] = point_labels[proj_idx[hit]]
    return out


def scatter_inputs(points: torch.Tensor, valid: torch.Tensor,
                   sensor: SensorSpec):
    """Per-point (flat pixel id, depth, px, py) of (B, P, C>=3) clouds: the
    inputs of the scatter-min. flat is int32, H*W on padding (dropped)."""
    xyz = points[..., :3].float()
    depth = torch.sqrt((xyz * xyz).sum(-1))
    if sensor.max_depth > 0:
        depth = torch.clamp_max(depth, sensor.max_depth)
    px, py = pixel_coords(xyz, depth, sensor)
    hw = sensor.proj_h * sensor.proj_w
    flat = torch.where(valid, py * sensor.proj_w + px, hw).to(torch.int32)
    return flat.contiguous(), depth.contiguous(), px, py


def range_project_batch(
    points: torch.Tensor,
    valid: torch.Tensor,
    sensor: SensorSpec,
    mask_excludes_point0: bool = False,
) -> dict[str, torch.Tensor]:
    """Batched range projection of padded (B, P, C>=3) clouds.

    Args:
      points: (B, P, C) float32, first 3 channels xyz; padded rows arbitrary.
      valid: (B, P) bool, False on padding.
      sensor: projection geometry.
      mask_excludes_point0: reproduce the reference's `proj_idx > 0` mask bug
        (SURVEY §5.1 defect #4).

    Returns a dict with proj_points (B, H, W, C) (-1 fill), proj_range
    (B, H, W) (-1 fill), proj_idx (B, H, W) int32 (-1 fill), proj_mask
    (B, H, W) int32, and per-point px / py (int32) / depth (B, P) for
    unprojection — the JAX function's layout and fills.
    """
    b, p, c = points.shape
    h, w = sensor.proj_h, sensor.proj_w
    flat, depth, px, py = scatter_inputs(points, valid, sensor)
    out = project_scatter(flat, depth, points.contiguous(), h * w,
                          mask_excludes_point0)
    return {
        "proj_points": out["proj_points"].view(b, h, w, c),
        "proj_range": out["proj_range"].view(b, h, w),
        "proj_idx": out["proj_idx"].view(b, h, w),
        "proj_mask": out["proj_mask"].view(b, h, w),
        "px": px,
        "py": py,
        "depth": depth,
    }


def build_range_features(proj_points: torch.Tensor, proj_range: torch.Tensor
                         ) -> torch.Tensor:
    """Stack the 5-channel (range, x, y, z, masked-intensity) feature image.

    HWC layout, as the JAX function returns it (the model permutes to NCHW).
    Intensity -1 (empty pixel fill) is zeroed, matching `ne(-1) * intensity`.
    """
    intensity = proj_points[..., 3]
    intensity = torch.where(intensity == -1.0, 0.0, intensity)
    return torch.cat(
        [proj_range[..., None], proj_points[..., :3], intensity[..., None]],
        dim=-1).float()


def build_range_features_np(proj_points: np.ndarray, proj_range: np.ndarray
                            ) -> np.ndarray:
    """Numpy twin of :func:`build_range_features` (the host pipeline's)."""
    intensity = proj_points[..., 3]
    intensity = np.where(intensity == -1.0, 0.0, intensity)
    return np.concatenate(
        [proj_range[..., None], proj_points[..., :3], intensity[..., None]],
        axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _sensor_stats(mean: tuple, std: tuple, device: torch.device):
    """The sensor's channel mean and std as tensors on ``device``, made
    once: building them per call is a host-to-device copy of pageable
    memory, which makes the host wait for the stream."""
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_features(features: torch.Tensor, eval_mask: torch.Tensor,
                       sensor: SensorSpec) -> torch.Tensor:
    """(x - mean) / std, zeroed outside the eval mask (trainer.py:599-609)."""
    mean, std = _sensor_stats(tuple(sensor.img_mean), tuple(sensor.img_stds),
                              features.device)
    return (features - mean) / std * eval_mask[..., None].float()
