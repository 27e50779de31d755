"""Forward FLOPs of a configuration, counted on the frozen reference model
with ``torch.utils.flop_counter`` on the meta device (a multiply-add is
2; only convolutions and matrix products count: the SAC blocks' unfold and
elementwise attention, BatchNorm and activations do not)."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models


@functools.lru_cache(maxsize=None)
def _count(model_key: tuple, n_classes: int, proj_dim: int, in_channels: int,
           h: int, w: int, return_feat: bool) -> int:
    with torch.device("meta"):
        model = models.build(dict(model_key), n_classes, proj_dim).eval()
        x = torch.zeros(1, in_channels, h, w)
    with FlopCounterMode(display=False) as counter:
        model(x, return_feat=return_feat)
    return int(counter.get_total_flops())


def forward_flops(cfg: dict, return_feat: bool = False) -> int:
    """FLOPs of one scan's forward; ``return_feat`` adds the contrastive
    projector, which training runs."""
    m = cfg["model"]
    s = cfg["sensor"]
    key = tuple(sorted((k, v) for k, v in m.items() if k in (
        "net_type", "layers", "stem", "base_channels", "dropout_rate",
        "in_channels")))
    return _count(key, cfg["data"]["n_classes"], cfg["contrast"]["proj_dim"],
                  m.get("in_channels", 5), s["proj_h"], s["proj_w"],
                  return_feat)
