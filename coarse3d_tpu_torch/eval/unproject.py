"""2D range-image -> 3D per-point unprojection (port of the JAX package's
``eval/unproject.py``).

Behavioral model: trainer.py:713-728 — per sample, gather the 2D value at
each point's cached (px, py). One flat row-gather with the batch folded into
the index; out-of-range rows clip, as the JAX take(mode="clip") does.
"""

from __future__ import annotations

import torch


def unproject_image(image: torch.Tensor, px: torch.Tensor, py: torch.Tensor
                    ) -> torch.Tensor:
    """Gather (B, H, W[, C]) image values at per-point pixels (B, P)."""
    b, h, w = image.shape[:3]
    flat = image.reshape(b * h * w, *image.shape[3:])
    base = torch.arange(b, device=image.device, dtype=torch.int64).reshape(
        (b,) + (1,) * (px.dim() - 1)) * (h * w)
    idx = (base + py.long() * w + px.long()).reshape(-1).clamp(0, b * h * w - 1)
    return flat[idx].reshape(*px.shape, *image.shape[3:])
