"""Fixed-shape per-class index gathering.

Port of the JAX package's ``ops/gather.py``. The reference takes dynamic
boolean subsets per class (``sim[label == c]``, salsanext_proto.py:354-359);
here one stable sort groups the elements by class, ``searchsorted`` finds
each class's contiguous range, and every class gets a fixed ``budget``-sized
slice of gather indices plus a validity mask: fixed shapes, no host sync.
Stable sorts keep the JAX package's order among equal keys, so indices and
ranks are equal to its, element for element.
"""

from __future__ import annotations

import torch


def class_ranges(keys: torch.Tensor, n_bins: int):
    """Sorted order + per-bin [start, count) over int keys in [0, n_bins)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    bins = torch.arange(n_bins + 1, dtype=keys.dtype, device=keys.device)
    starts = torch.searchsorted(sorted_keys, bins)
    counts = starts[1:] - starts[:-1]
    return order, sorted_keys, starts[:-1], counts


def gather_class_indices(
    labels: torch.Tensor,
    valid: torch.Tensor,
    n_classes: int,
    budget: int,
):
    """For each class c, up to ``budget`` indices of elements with label c.

    Args:
      labels: (N,) int class ids.
      valid: (N,) bool; invalid elements are never selected.
      n_classes: number of classes (bins).
      budget: fixed per-class capacity M.

    Returns:
      idx: (n_classes, M) int64 indices into the flat input (clipped
        placeholders where invalid).
      mask: (n_classes, M) bool validity, a prefix of each row. If a class
        has more than ``budget`` elements the surplus is dropped (stable
        order).
    """
    n = labels.shape[0]
    keys = torch.where(valid, labels.to(torch.int32), n_classes)
    order, _, starts, counts = class_ranges(keys, n_classes)
    slots = torch.arange(budget, device=labels.device)
    pos = starts[:, None] + slots[None, :]
    mask = slots[None, :] < counts[:, None]
    idx = order[torch.clamp(pos, 0, n - 1)]
    return idx, mask


def rank_within_class(
    scores: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    n_classes: int,
):
    """Rank of each element among same-class peers by descending score:
    sort by score desc, stable re-sort by class, subtract the class's start
    offset. Invalid elements get rank N.

    Returns (ranks (N,) int32, counts (n_classes,)).
    """
    n = scores.shape[0]
    dev = scores.device
    keys = torch.where(valid, labels.to(torch.int32), n_classes)
    perm1 = torch.sort(-scores, stable=True).indices
    keys1 = keys[perm1]
    sorted_keys, perm2 = torch.sort(keys1, stable=True)
    order = perm1[perm2]            # grouped by class, desc score inside
    starts = torch.searchsorted(
        sorted_keys, torch.arange(n_classes + 1, dtype=torch.int32,
                                  device=dev))
    counts = (starts[1:] - starts[:-1])[:n_classes]
    pos_in_class = torch.arange(n, device=dev) - starts[
        torch.clamp(sorted_keys, 0, n_classes).long()]
    ranks = torch.full((n,), n, dtype=torch.int64, device=dev)
    ranks[order] = pos_in_class
    ranks = torch.where(valid, ranks, n)
    return ranks.to(torch.int32), counts
