"""Model wiring (``build_model``), the port of the JAX package's
``train/setup.py:build_model`` for the SalsaNext parity model.

The other backbones (``rangenet``, ``squeezesegv3``) and the space-to-depth
stems (``s2d``, ``s2d_w``) are not ported yet: ROADMAP.md Queue 1 item 17.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from coarse3d_tpu_torch.configs.config import ExperimentConfig
from coarse3d_tpu_torch.device import resolve_device
from coarse3d_tpu_torch.models.salsanext import SalsaNext

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv's weight and bias from ``generator`` with PyTorch's
    default Conv2d scheme (uniform in +-1/sqrt(fan_in)); BatchNorm starts at
    scale 1, shift 0, running stats (0, 1). Drawn on the CPU, so the same
    seed gives the same weights on any device."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels // mod.groups * math.prod(mod.kernel_size)
            bound = 1.0 / math.sqrt(fan_in)
            for t in (mod.weight, mod.bias):
                if t is not None:
                    t.copy_(torch.rand(t.shape, generator=generator)
                            * (2 * bound) - bound)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()


def build_model(cfg: ExperimentConfig, device: str | torch.device = "cuda",
                seed: int = 0) -> SalsaNext:
    """The configured model in eval mode on ``device``, weights drawn from
    a ``torch.Generator`` seeded with ``seed`` (load trained weights with
    ``load_state_dict`` afterwards)."""
    dev = resolve_device(device)
    if cfg.model.net_type != "salsanext":
        raise NotImplementedError(
            f"net_type={cfg.model.net_type!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 17); only 'salsanext' is")
    if cfg.model.stem != "parity":
        raise NotImplementedError(
            f"model.stem={cfg.model.stem!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 17); only the parity stem is")
    if cfg.model.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown model.compute_dtype "
                         f"{cfg.model.compute_dtype!r}")
    model = SalsaNext(
        n_classes=cfg.data.n_classes,
        in_channels=cfg.model.in_channels,
        base_channels=cfg.model.base_channels,
        proj_dim=cfg.contrast.proj_dim,
        dropout_rate=cfg.model.dropout_rate,
        compute_dtype=_DTYPES[cfg.model.compute_dtype],
        # POSS pads H and W by +8 (salsanext_proto.py:426-431)
        pad_hw=8 if cfg.data.dataset == "semantic_poss" else 0,
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
