"""KNN range-image post-processing (per-point label cleanup), PyTorch.

Port of the JAX package's ``ops/knn.py:knn_postprocess``. Behavioral model:
the reference's postproc/knn.py:36-142 (lidar-bonnetal style): for every 3D
point, take the S x S range-image neighbourhood at its pixel, replace the
centre with the point's true range, weight |Δrange| by an inverted Gaussian
kernel, pick the knn smallest, vote over their argmax labels (distances past
`cutoff` vote for an invalid class), and return argmax over classes 1..C-1
+ 1. Reference quirks preserved: zero-padded border pixels keep range 0 and
label 0.

The class label (< 32) rides in the 5 low mantissa bits of the range image
(:func:`_pack`), so one fetch per neighbour brings range and label, and the
k smallest distances carry their labels with them. The per-point vote is
kernel K2 (:func:`ops.knn_vote.knn_vote`) on a CUDA tensor and its plain
twin on a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LABEL_BITS = 5
LABEL_MASK = (1 << LABEL_BITS) - 1  # 31
EMPTY_RANGE = 3.0e38  # empty pixels never win (finite keeps the pack defined)


@functools.lru_cache(maxsize=None)
def _inv_gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """1 - normalized 2D Gaussian, flattened to (size*size,) (knn.py:11-33)."""
    coords = np.arange(size, dtype=np.float64)
    xg, yg = np.meshgrid(coords, coords, indexing="xy")
    mean = (size - 1) / 2.0
    var = float(sigma) ** 2
    g = np.exp(-((xg - mean) ** 2 + (yg - mean) ** 2) / (2 * var)) / (
        2 * np.pi * var)
    g = g / g.sum()
    out = (1.0 - g).reshape(-1).astype(np.float32)
    out.flags.writeable = False  # cached: shared by every caller
    return out


def _pack(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Write int labels (< 32) into the 5 low mantissa bits of float32s."""
    bits = values.contiguous().view(torch.int32)
    return ((bits & ~LABEL_MASK) | labels.to(torch.int32)).view(torch.float32)


def _unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    bits = packed.contiguous().view(torch.int32)
    return (bits & ~LABEL_MASK).view(torch.float32), bits & LABEL_MASK


def pack_range_image(proj_range: torch.Tensor, proj_argmax: torch.Tensor
                     ) -> torch.Tensor:
    """(B, H, W) range image (-1 on empty pixels) + argmax labels -> packed
    image, empty pixels pushed to ``EMPTY_RANGE``."""
    rng_img = torch.where(proj_range < 0, EMPTY_RANGE, proj_range)
    return _pack(rng_img, proj_argmax)


def knn_postprocess(
    proj_range: torch.Tensor,
    point_range: torch.Tensor,
    proj_argmax: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    *,
    n_classes: int,
    knn: int = 5,
    search: int = 5,
    sigma: float = 1.0,
    cutoff: float = 1.0,
) -> torch.Tensor:
    """Clean per-point labels by range-aware KNN voting.

    Args:
      proj_range: (B, H, W) float32 range image (-1 on empty pixels).
      point_range: (B, P) float32 true per-point range.
      proj_argmax: (B, H, W) int 2D predicted labels in [0, n_classes).
      px, py: (B, P) int32 per-point pixel coords.

    Returns (B, P) int32 voted labels in [1, n_classes-1].
    """
    from coarse3d_tpu_torch.ops.knn_vote import knn_vote

    packed = pack_range_image(proj_range.float(), proj_argmax)
    return knn_vote(
        packed, point_range.float().contiguous(),
        px.to(torch.int32).contiguous(), py.to(torch.int32).contiguous(),
        n_classes=n_classes, knn=knn, search=search, sigma=sigma,
        cutoff=cutoff)
