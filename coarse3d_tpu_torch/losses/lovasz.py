"""Lovász-Softmax loss (Berman et al. 2018) as a fixed-shape masked op.

Port of the JAX package's ``losses/lovasz.py``. Behavioral model: the
reference's lovasz_softmax.py with the trainer's config (ignore=0,
per_image=False, softmax=False, classes='present', trainer.py:362-364).

All classes are handled by one descending sort along the pixel axis of the
(N, C) error matrix (the JAX package vmaps one sort per class): invalid
pixels get error -1 so they sort to the tail where the Lovász gradient is
zero, and absent classes are masked out of the mean. The sort is stable,
as the JAX ``argsort`` is, so ties keep the pixel order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from coarse3d_tpu_torch.parallel.mesh import all_gather, all_reduce_sum


def lovasz_budget_overflow(
    labels: torch.Tensor, ignore: int, budget: int, mesh=None
) -> torch.Tensor:
    """Valid pixels beyond the ``budget`` sort cap of lovasz_softmax_loss
    (int32 scalar; > 0 means the budgeted loss dropped pixels); with
    ``mesh``, those of the global batch."""
    n_valid = all_reduce_sum((labels.reshape(-1) != ignore).sum(), mesh)
    return torch.clamp_min(n_valid - budget, 0).to(torch.int32)


def lovasz_softmax_loss(
    probs: torch.Tensor,
    labels: torch.Tensor,
    ignore: int = 0,
    classes: str = "present",
    budget: int | None = None,
    mesh=None,
) -> torch.Tensor:
    """Multi-class Lovász-Softmax.

    Args:
      probs: (..., C) class probabilities.
      labels: (...,) int ground truth.
      ignore: void label dropped from the flattened pixel set.
      classes: 'present' averages only over classes present among valid
        pixels (reference default); 'all' averages over every class.
      budget: optional cap on valid pixels: one stable argsort on validity
        keeps the first ``budget`` pixels (valid ones first, in pixel
        order), so the per-class sorts run over ``budget`` elements. Exact
        as long as the valid count fits.
      mesh: ``parallel.mesh.Mesh`` when the inputs are one rank's stripe
        of a global batch. The loss is not a mean of per-rank values: each
        rank keeps its first ``budget`` pixels (valid first), a
        differentiable all-gather joins them in rank order, and the budget
        is applied again, which gives the global batch's first ``budget``
        pixels; every rank then sorts the same rows. The value is this
        rank's share, the loss over the world size: the backward of the
        gather sums the ranks' identical gradients.
    """
    c = probs.shape[-1]

    def keep_budget(flat_p, flat_l):
        if budget is None or budget >= flat_l.shape[0]:
            return flat_p, flat_l
        order = torch.sort((flat_l == ignore).to(torch.uint8),
                           stable=True).indices
        sel = order[:budget]
        return flat_p[sel], flat_l[sel]

    flat_p, flat_l = keep_budget(probs.reshape(-1, c).float(),
                                 labels.reshape(-1).long())
    world = 1 if mesh is None else mesh.world
    if world > 1:
        flat_p, flat_l = keep_budget(all_gather(flat_p, mesh),
                                     all_gather(flat_l, mesh))
    valid = flat_l != ignore

    vf = valid.to(torch.float32)[:, None]
    # one_hot of out-of-range labels is zero in JAX; clamp then mask
    in_range = (flat_l >= 0) & (flat_l < c)
    fg = F.one_hot(torch.where(in_range, flat_l, 0), c).to(torch.float32)
    fg = fg * in_range[:, None] * vf                          # (N, C)

    errors = torch.abs(fg - flat_p)
    errors = torch.where(vf > 0, errors, -1.0)
    errors_s, order = torch.sort(errors, dim=0, descending=True, stable=True)
    fg_s = torch.gather(fg, 0, order)
    valid_s = torch.gather(vf.expand(-1, c), 0, order)

    gts = fg.sum(dim=0)
    intersection = gts - torch.cumsum(fg_s, dim=0)
    union = gts + torch.cumsum((1.0 - fg_s) * valid_s, dim=0)
    jaccard = 1.0 - intersection / torch.clamp_min(union, 1e-12)
    grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]], dim=0)
    losses = (torch.where(valid_s > 0, errors_s, 0.0) * grad).sum(dim=0)

    if classes == "present":
        weight = (gts > 0).to(torch.float32)
    else:
        weight = torch.ones_like(losses)
    total = (losses * weight).sum()
    count = weight.sum()
    return torch.where(count > 0, total / torch.clamp_min(count, 1.0),
                       torch.zeros_like(total)) / world
