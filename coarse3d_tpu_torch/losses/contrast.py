"""Prototype-anchor InfoNCE with entropy-weighted anchor sampling.

Port of the JAX package's ``losses/contrast.py``. Behavioral model: the
reference's contrast_pixel_loss.py (``ContrastMEMLoss``): labels outside the
keep mask -> ignore; per-pixel entropy of the softmax output is *squared*
before the exp weight (:47-49, deliberately preserved: PARITY.md defect #9;
the pseudo-label selection does not square); for every (image, present
class) pair ``num_anchor`` pixels are drawn with replacement ∝ weight; the
contrast set is every sub-prototype of every non-ignore class; cosine-sim
InfoNCE at T with positives = same-class prototypes, in the decoupled form
denominator exp(pair) + Σ exp(negatives).

The with-replacement draw is CDF inversion (``cumsum`` +
``searchsorted(right=True)``) of uniforms passed in as an argument, so the
JAX package and the port can be fed the same numbers.

Layout: the embedding is (B, H, W, D), as in the JAX package; the training
step passes the model's NCHW output as a permuted view, which
``reshape(B, H*W, D)`` keeps a view, so the anchor gather reads the rows it
needs and the (B, D, H, W) tensor is never copied.
"""

from __future__ import annotations

import torch

from coarse3d_tpu_torch.configs.config import ContrastConfig
from coarse3d_tpu_torch.models.prototypes import l2_normalize
from coarse3d_tpu_torch.parallel.mesh import all_reduce_sum


def sample_anchors(
    embedding: torch.Tensor,
    probs: torch.Tensor,
    labels: torch.Tensor,
    uniforms: torch.Tensor,
    ignore_cls: int = 0,
):
    """Entropy-weighted with-replacement anchor sampling.

    Args:
      embedding: (B, H, W, D).
      probs: (B, H, W, C) softmax output (entropy source).
      labels: (B, H, W) int pseudo labels (already keep-masked).
      uniforms: (B, C, A) float32 uniforms in [0, 1); A = anchors per
        (image, present class).

    Returns:
      anchors: (B, C, A, D) features.
      anchor_class: (C,) class id per row (shared across images).
      valid: (B, C) presence mask (class appears in the image, != ignore).
    """
    b, h, w, d = embedding.shape
    c = probs.shape[-1]
    n = h * w
    num_anchor = uniforms.shape[-1]
    feat = embedding.reshape(b, n, d)
    lbl = labels.reshape(b, n)

    p = probs.reshape(b, n, c).float()
    entropy = -torch.sum(p * torch.log(p + 1e-10), dim=-1)   # (B, N)
    log_weight = -(entropy * entropy)  # log exp(-entropy^2)

    cls_ids = torch.arange(c, dtype=torch.int32, device=probs.device)
    onehot = lbl[:, None, :] == cls_ids[None, :, None]       # (B, C, N)
    valid = onehot.any(dim=-1) & (cls_ids != ignore_cls)[None, :]

    weights = torch.where(onehot, torch.exp(log_weight)[:, None, :], 0.0)
    cdf = torch.cumsum(weights, dim=-1)                      # (B, C, N)
    u = uniforms * cdf[..., -1:]
    # right=True skips zero-weight (masked) pixels at u == their cdf value
    draws = torch.searchsorted(cdf, u.contiguous(), right=True)
    draws = torch.clamp(draws, 0, n - 1)                      # (B, C, A)

    rows = torch.arange(b, device=probs.device)[:, None, None]
    anchors = feat[rows, draws]                               # (B, C, A, D)
    return anchors, cls_ids, valid


def contrast_mem_loss(
    embedding: torch.Tensor,
    probs: torch.Tensor,
    labels: torch.Tensor,
    keep_mask: torch.Tensor,
    prototypes: torch.Tensor,
    uniforms: torch.Tensor,
    cfg: ContrastConfig,
    ignore_cls: int = 0,
    mesh=None,
) -> torch.Tensor:
    """Full ContrastMEMLoss: sample anchors, contrast against the memory.
    ``uniforms`` is (B, C, cfg.num_anchor); ``probs`` and ``prototypes``
    carry no gradient (the caller detaches them). Anchors are drawn per
    image; with ``mesh`` (the inputs are one rank's stripe) the mean is
    over the global batch's valid anchors and the value is this rank's
    share of it."""
    c, k, d = prototypes.shape
    labels = torch.where(keep_mask, labels, ignore_cls)

    anchors, cls_ids, valid = sample_anchors(
        embedding, probs, labels, uniforms, ignore_cls)
    b, _, num_anchor, _ = anchors.shape

    # contrast set: all sub-prototypes of all non-ignore classes
    queue = l2_normalize(prototypes.float())                 # (C, K, D)
    queue_feat = queue.reshape(c * k, d)
    queue_cls = torch.repeat_interleave(cls_ids, k)
    queue_valid = queue_cls != ignore_cls                    # (C*K,)

    anchor_feat = l2_normalize(anchors.reshape(-1, d))       # (R, D)
    anchor_cls = cls_ids[None, :, None].expand(b, c, num_anchor).reshape(-1)
    anchor_valid = valid[..., None].expand(b, c, num_anchor).reshape(-1)

    sims = anchor_feat @ queue_feat.T / cfg.temperature      # (R, CK)
    sims = torch.where(queue_valid[None, :], sims, float("-inf"))
    sims = sims - sims.max(dim=1, keepdim=True).values.detach()

    pos_mask = (anchor_cls[:, None] == queue_cls[None, :]) & queue_valid
    exp_sims = torch.where(queue_valid[None, :], torch.exp(sims), 0.0)
    neg_sum = (exp_sims * (~pos_mask)).sum(dim=1, keepdim=True)
    log_prob = sims - torch.log(exp_sims + neg_sum + 1e-6)

    pos_count = torch.clamp_min(pos_mask.sum(dim=1), 1)
    mean_log_prob_pos = (
        torch.where(pos_mask, log_prob, 0.0).sum(dim=1) / pos_count)

    per_anchor = -(cfg.temperature / cfg.base_temperature) * mean_log_prob_pos
    av = anchor_valid.to(torch.float32)
    denom = all_reduce_sum(av.sum(), mesh)
    return torch.where(denom > 0, (per_anchor * av).sum()
                       / torch.clamp_min(denom, 1.0), torch.zeros_like(denom))
