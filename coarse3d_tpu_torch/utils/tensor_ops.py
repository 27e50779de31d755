"""Small tensor utilities, the port of the JAX package's
``utils/tensor_ops.py`` (reference: utils/tensor_ops.py:3-31)."""

from __future__ import annotations

import torch


def minmax_normalize(x: torch.Tensor, axis=(-2, -1)) -> torch.Tensor:
    """Per-image min-max normalization to [0, 1]."""
    lo = torch.amin(x, dim=axis, keepdim=True)
    hi = torch.amax(x, dim=axis, keepdim=True)
    return (x - lo) / torch.clamp_min(hi - lo, 1e-6)


def masked_mean_entropy(probs: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """Mean per-pixel entropy over masked elements."""
    entropy = -torch.sum(probs * torch.log(probs + 1e-10), dim=-1)
    m = mask.to(entropy.dtype)
    return (entropy * m).sum() / torch.clamp_min(m.sum(), 1.0)
