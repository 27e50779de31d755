"""Bilinear resize with align_corners=True semantics (NCHW).

Port of the JAX package's ``ops/resize.py:resize_bilinear``. The reference
uses ``F.interpolate(..., mode='bilinear', align_corners=True)`` for its
multi-scale feature mix and embedding upsample (salsanext_proto.py:466-492);
the JAX package rebuilt that grid as two weight-matrix contractions because
``jax.image.resize`` lacks it. PyTorch has it, so the port calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize (B, C, H, W) -> (B, C, out_h, out_w), align_corners=True."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)
