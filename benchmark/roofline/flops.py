"""Forward FLOPs of a configuration, counted on the frozen reference model
with ``torch.utils.flop_counter`` on the meta device (a multiply-add is
2; only convolutions and matrix products count: the SAC blocks' unfold and
elementwise attention, BatchNorm and activations do not)."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models


@functools.lru_cache(maxsize=None)
def _count(model_json: str, n_classes: int, proj_dim: int, in_channels: int,
           h: int, w: int, return_feat: bool) -> int:
    with torch.device("meta"):
        model = models.build(json.loads(model_json), n_classes,
                             proj_dim).eval()
        x = torch.zeros(1, in_channels, h, w)
    with FlopCounterMode(display=False) as counter:
        model(x, return_feat=return_feat)
    return int(counter.get_total_flops())


def forward_flops(cfg: dict, return_feat: bool = False) -> int:
    """FLOPs of one scan's forward; ``return_feat`` adds the contrastive
    projector, which training runs. Counted once for each distinct
    ``model`` block, every key of it included."""
    m = cfg["model"]
    s = cfg["sensor"]
    return _count(json.dumps(m, sort_keys=True), cfg["data"]["n_classes"],
                  cfg["contrast"]["proj_dim"], m.get("in_channels", 5),
                  s["proj_h"], s["proj_w"], return_feat)
