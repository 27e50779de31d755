"""Top-k accuracy + keyed running averages.

Port of the JAX package's ``metrics/acc_eval.py``. Behavioral model:
pc_processor/metrics/acc_eval.py:8-32 (AccEval used for the ImageNet
encoder pretrain) and classifier_eval.py:1-28 (ClassifierAverageMeter)."""

from __future__ import annotations

import torch


def topk_accuracy(logits: torch.Tensor, target: torch.Tensor,
                  topk: tuple[int, ...] = (1,)) -> list[torch.Tensor]:
    """Per-k accuracy in [0, 1] for (N, C) logits and (N,) targets."""
    max_k = max(topk)
    # a stable descending sort: ties keep the lower class first
    pred = torch.argsort(-logits, dim=-1, stable=True)[:, :max_k]
    correct = pred == target[:, None]
    return [correct[:, :k].any(dim=-1).float().mean() for k in topk]


class ClassifierAverageMeter:
    """Keyed running averages (classifier_eval.py)."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def update(self, values: dict[str, float], n: int = 1):
        for k, v in values.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v) * n
            self._counts[k] = self._counts.get(k, 0) + n

    def averages(self) -> dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1)
                for k in self._sums}
