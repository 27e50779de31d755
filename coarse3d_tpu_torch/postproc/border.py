"""Class-border mask via iterated binary erosion of one-hot labels.

Port of the JAX package's ``postproc/border.py``. Behavioral model: the
reference's postproc/borderMask.py:91-304, which is dead code there (it
imports a nonexistent ``src.common.onehot``); its documented intent is a
mask of pixels within ``border_size`` erosion steps of a class boundary.
As in the JAX package: one-hot labels are min-pooled (binary erosion with a
cross or square structuring element) ``border_size`` times; border = any
class pixel lost by erosion. The image's edge does not erode (padding 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _erode(onehot: torch.Tensor, kind: str) -> torch.Tensor:
    """(B, H, W, C) binary erosion by a 3x3 structuring element."""
    pads = F.pad(onehot, (0, 0, 1, 1, 1, 1), value=1.0)
    h, w = onehot.shape[1], onehot.shape[2]
    if kind == "cross":
        offsets = [(0, 1), (1, 0), (1, 1), (1, 2), (2, 1)]
    else:  # square
        offsets = [(dy, dx) for dy in range(3) for dx in range(3)]
    out = onehot
    for dy, dx in offsets:
        out = torch.minimum(out, pads[:, dy:dy + h, dx:dx + w, :])
    return out


def border_mask(
    labels: torch.Tensor,
    n_classes: int,
    border_size: int = 1,
    kind: str = "cross",
) -> torch.Tensor:
    """(B, H, W) bool: pixels within ``border_size`` of a class boundary.
    Labels outside [0, n_classes) belong to no class, as in
    ``jax.nn.one_hot``."""
    labels = labels.long()
    inside = (labels >= 0) & (labels < n_classes)
    onehot = F.one_hot(labels.clamp(0, n_classes - 1), n_classes).to(
        torch.float32) * inside[..., None]
    eroded = onehot
    for _ in range(border_size):
        eroded = _erode(eroded, kind)
    return (onehot - eroded).sum(dim=-1) > 0
