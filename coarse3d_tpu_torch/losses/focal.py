"""Focal cross-entropy over class probabilities.

Port of the JAX package's ``losses/focal.py``. Behavioral model: the
reference's focal_softmax.py:7-77 as the trainer configures it
(trainer.py:348-364): gamma=2, softmax=False (the model outputs
probabilities already), per-class alpha from log-scaled inverse-frequency
weights, masked mean over weak-labeled pixels, 0 when the mask is empty.

``focal_alpha_from_counts`` is numpy and is the port's own copy of the JAX
package's function; the empty-mask guard is a ``torch.where``, not a host
branch.
"""

from __future__ import annotations

import numpy as np
import torch

from coarse3d_tpu_torch.parallel.mesh import all_reduce_sum


def focal_alpha_from_counts(
    cls_counts, learning_ignore_mask=None, ignore_cls: int = 0
) -> np.ndarray:
    """Per-class focal alpha from weak-label class counts.

    Mirrors trainer.py:273-291 + :351-359: weight = 1/(freq + 1e-3) with
    ignored classes zeroed, then alpha = log(1 + w) / max(log(1 + w)),
    alpha[ignore] = 0.
    """
    counts = np.asarray(cls_counts, dtype=np.float64)
    freq = counts / counts.sum()
    weight = 1.0 / (freq + 1e-3)
    if learning_ignore_mask is not None:
        weight = np.where(np.asarray(learning_ignore_mask), 0.0, weight)
    else:
        weight = weight.copy()
        weight[ignore_cls] = 0.0
    alpha = np.log(1 + weight)
    alpha = alpha / alpha.max()
    alpha[ignore_cls] = 0.0
    return alpha.astype(np.float32)


def focal_softmax_loss(
    probs: torch.Tensor,
    target: torch.Tensor,
    alpha: torch.Tensor,
    mask: torch.Tensor | None = None,
    gamma: float = 2.0,
    mesh=None,
) -> torch.Tensor:
    """Masked focal loss over probabilities.

    Args:
      probs: (..., C) class probabilities (already softmaxed).
      target: (...,) int class ids.
      alpha: (C,) per-class weights.
      mask: (...,) bool/float; mean is taken over masked elements.
      gamma: focusing exponent.
      mesh: ``parallel.mesh.Mesh`` when the inputs are one rank's stripe
        of a global batch: the mean's denominator is then the global count,
        and the value is this rank's share of the global loss (the shares
        sum to it).
    """
    c = probs.shape[-1]
    flat_p = probs.reshape(-1, c)
    flat_t = target.reshape(-1).long()
    p_t = torch.gather(flat_p, 1, flat_t[:, None])[:, 0]
    log_p = torch.log(torch.clamp_min(p_t, 1e-6))
    a_t = alpha.to(flat_p.dtype)[flat_t]
    loss = -((1.0 - p_t) ** gamma) * log_p * a_t
    if mask is None:
        if mesh is None:
            return loss.mean()
        return loss.sum() / (loss.numel() * mesh.world)
    m = mask.reshape(-1).to(loss.dtype)
    denom = all_reduce_sum(m.sum(), mesh)
    out = (loss * m).sum() / torch.clamp_min(denom, 1.0)
    # reference returns 0 for an empty/NaN mask (focal_softmax.py:67-73)
    return torch.where(denom > 0, out, torch.zeros_like(out))
