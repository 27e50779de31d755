"""Masked Sinkhorn-Knopp sub-prototype assignment.

Port of the JAX package's ``ops/sinkhorn.py``. Behavioral model: the
reference's sinkhorn.py:5-33 (``distributed_sinkhorn``): Q = exp(sim / eps)
over the (pixels-of-one-class, sub_prototypes) similarity block, normalized
with 3 row/col rounds, then a hard Gumbel-softmax (tau=0.5) sample of the
assignment one-hot and a noise-free argmax index.

The pixel axis is a fixed budget with a validity mask (masked rows carry no
mass and the "B" normaliser is the valid count). With hard=True and no
gradient, the Gumbel-softmax sample is argmax(Q + gumbel); the noise is an
argument. Leading dimensions batch independent problems (the prototype
update runs one per class).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / torch.where(b > 0, b, 1.0)


def masked_sinkhorn(
    sim: torch.Tensor,
    valid: torch.Tensor,
    gumbel: torch.Tensor,
    iterations: int = 3,
    epsilon: float = 0.05,
):
    """Assign valid rows of ``sim`` (..., M, K) to K sub-prototypes.

    Args:
      sim: (..., M, K) similarities.
      valid: (..., M) bool.
      gumbel: (..., M, K) float32 standard Gumbel noise.

    Returns:
      onehot: (..., M, K) float32 hard assignment (zero on invalid rows).
      index: (..., M) int32 noise-free argmax assignment (0 on invalid rows).

    A problem with no valid row gives NaN inside Q, as in the JAX package;
    the masks keep it out of both outputs.
    """
    k = sim.shape[-1]
    vf = valid.to(torch.float32)[..., None]                  # (..., M, 1)
    logits = sim.float() / epsilon
    masked = torch.where(valid[..., None], logits, float("-inf"))
    lmax = masked.amax(dim=(-2, -1), keepdim=True)
    q = torch.exp(logits - lmax) * vf

    n_valid = torch.clamp_min(vf.sum(dim=(-2, -1), keepdim=True), 1.0)
    q = _safe_div(q, q.sum(dim=(-2, -1), keepdim=True))
    for _ in range(iterations):
        # columns: total weight per prototype sums to 1/K
        q = _safe_div(q, q.sum(dim=-2, keepdim=True)) / k
        # rows: total weight per valid sample sums to 1/B
        q = _safe_div(q, q.sum(dim=-1, keepdim=True)) / n_valid
        q = q * vf
    q = q * n_valid

    index = torch.argmax(q, dim=-1).to(torch.int32)
    hard = torch.argmax(q + gumbel, dim=-1)
    onehot = F.one_hot(hard, k).to(torch.float32) * vf
    return onehot, torch.where(valid, index, 0)
