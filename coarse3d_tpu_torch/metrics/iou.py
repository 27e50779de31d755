"""Streaming confusion-matrix metrics (IoU / Acc / Recall).

Port of the JAX package's ``metrics/iou.py``. Behavioral model: the
reference's iou_eval.py:9-109 — rows = predictions, cols = targets, ignore
rows/cols zeroed before the stats, mean over the included classes.

The matrix is an ``index_add_`` of ones on the device (exact integer
counts, no host sync): a flat index ``pred * C + target`` outside [0, C*C)
and masked elements go to one extra bin that is dropped, as the JAX
``mode="drop"`` scatter drops them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def confusion_matrix(
    pred: torch.Tensor,
    target: torch.Tensor,
    n_classes: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(C, C) int32 confusion counts; rows = pred, cols = target."""
    p = pred.reshape(-1).long()
    t = target.reshape(-1).long()
    n2 = n_classes * n_classes
    flat = p * n_classes + t
    keep = (flat >= 0) & (flat < n2)
    if valid is not None:
        keep &= valid.reshape(-1).bool()
    flat = torch.where(keep, flat, n2)
    conf = torch.zeros(n2 + 1, dtype=torch.int64, device=p.device)
    conf.index_add_(0, flat, torch.ones_like(flat))
    return conf[:n2].reshape(n_classes, n_classes).to(torch.int32)


def _stats(conf: torch.Tensor, ignore: tuple[int, ...]):
    conf = conf.to(torch.float32).clone()
    for ig in ignore:
        conf[ig, :] = 0.0
        conf[:, ig] = 0.0
    tp = torch.diagonal(conf)
    fp = conf.sum(dim=1) - tp
    fn = conf.sum(dim=0) - tp
    return tp, fp, fn


def _include_mask(n_classes: int, ignore: tuple[int, ...], device
                  ) -> torch.Tensor:
    mask = torch.ones(n_classes, dtype=torch.bool, device=device)
    for ig in ignore:
        mask[ig] = False
    return mask


def _masked_mean(values: torch.Tensor, ignore: tuple[int, ...]
                 ) -> torch.Tensor:
    inc = _include_mask(values.shape[0], ignore, values.device)
    return (values * inc).sum() / inc.sum()


def iou_from_confusion(conf: torch.Tensor, ignore: tuple[int, ...] = (0,)):
    """Returns (mean IoU over included classes, per-class IoU)."""
    tp, fp, fn = _stats(conf, ignore)
    iou = tp / (tp + fp + fn + 1e-15)
    return _masked_mean(iou, ignore), iou


def acc_from_confusion(conf: torch.Tensor, ignore: tuple[int, ...] = (0,)):
    """Per-class precision (tp / (tp + fp)), reference naming 'Acc'."""
    tp, fp, _ = _stats(conf, ignore)
    acc = tp / (tp + fp + 1e-15)
    return _masked_mean(acc, ignore), acc


def recall_from_confusion(conf: torch.Tensor, ignore: tuple[int, ...] = (0,)):
    tp, _, fn = _stats(conf, ignore)
    rec = tp / (tp + fn + 1e-15)
    return _masked_mean(rec, ignore), rec


@dataclasses.dataclass
class ConfusionState:
    """Host-side accumulator mirroring the reference IOUEval lifecycle."""

    n_classes: int
    ignore: tuple[int, ...] = (0,)

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.conf = np.zeros((self.n_classes, self.n_classes), dtype=np.int64)

    def add(self, conf_update) -> None:
        if torch.is_tensor(conf_update):
            conf_update = conf_update.cpu().numpy()
        self.conf += np.asarray(conf_update, dtype=np.int64)

    def add_batch(self, pred, target, valid=None) -> None:
        self.add(confusion_matrix(
            torch.as_tensor(pred), torch.as_tensor(target), self.n_classes,
            None if valid is None else torch.as_tensor(valid)))

    def iou(self):
        return iou_from_confusion(torch.from_numpy(self.conf), self.ignore)

    def acc(self):
        return acc_from_confusion(torch.from_numpy(self.conf), self.ignore)

    def recall(self):
        return recall_from_confusion(torch.from_numpy(self.conf), self.ignore)
