"""Experiment wiring: model, optimizer, focal alpha and training state,
the port of the JAX package's ``train/setup.py``: the three model families
(``salsanext`` with its ``parity`` / ``s2d`` / ``s2d_w`` stems, ``rangenet``
and ``squeezesegv3`` at 21 or 53 layers).

AdamW matches the reference's ``torch.optim.AdamW(params, lr)``: torch's
default weight decay 0.01 applies there (the YAML weight_decay is unused,
PARITY.md defect #5), on every parameter, BatchNorm scales and biases
included, as ``optax.adamw`` applies it in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

import numpy as np

from coarse3d_tpu_torch.configs.config import ExperimentConfig
from coarse3d_tpu_torch.device import resolve_device
from coarse3d_tpu_torch.losses.focal import focal_alpha_from_counts
from coarse3d_tpu_torch.models.rangenet import RangeNet
from coarse3d_tpu_torch.models.salsanext import SalsaNext
from coarse3d_tpu_torch.models.squeezesegv3 import SqueezeSegV3
from coarse3d_tpu_torch.train.schedule import (
    Schedule,
    lr_lambda,
    warmup_cosine_schedule,
)
from coarse3d_tpu_torch.train.state import TrainState, init_prototypes

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv's, transposed conv's and linear layer's weight and
    bias from ``generator`` with PyTorch's default scheme (uniform in
    +-1/sqrt(fan_in)); BatchNorm starts at scale 1, shift 0, running stats
    (0, 1). Drawn on the CPU, so the same seed gives the same weights on any
    device."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # PyTorch's fan_in: the weight's second dimension times the
            # kernel's size (for a transposed conv, the output channels)
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for t in (mod.weight, mod.bias):
                if t is not None:
                    t.copy_(torch.rand(t.shape, generator=generator)
                            * (2 * bound) - bound)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()


STEM_FACTORS = {"parity": (1, 1), "s2d": (2, 2), "s2d_w": (1, 2)}


def _make_model(cfg: ExperimentConfig) -> nn.Module:
    poss = cfg.data.dataset == "semantic_poss"
    if cfg.model.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown model.compute_dtype "
                         f"{cfg.model.compute_dtype!r}")
    kwargs = dict(
        n_classes=cfg.data.n_classes,
        in_channels=cfg.model.in_channels,
        base_channels=cfg.model.base_channels,
        proj_dim=cfg.contrast.proj_dim,
        dropout_rate=cfg.model.dropout_rate,
        compute_dtype=_DTYPES[cfg.model.compute_dtype],
    )
    if cfg.model.net_type == "salsanext":
        # "s2d" stacks 2x2 pixels into channels (network at half H, half W);
        # "s2d_w" stacks 1x2 (full H, half W)
        if cfg.model.stem not in STEM_FACTORS:
            raise ValueError(f"unknown model.stem: {cfg.model.stem!r} "
                             f"(choose from {sorted(STEM_FACTORS)})")
        fi, fj = STEM_FACTORS[cfg.model.stem]
        if fi * fj > 1:
            h = cfg.sensor.proj_h + (8 if poss else 0)
            w = cfg.sensor.proj_w + (8 if poss else 0)
            if h % (16 * fi) or w % (16 * fj):
                raise ValueError(
                    f"stem='{cfg.model.stem}' runs the network at 1/{fi} x "
                    f"1/{fj} resolution, so H and W (after any POSS padding) "
                    f"must divide {16 * fi} and {16 * fj}; got {h}x{w} for "
                    f"dataset={cfg.data.dataset}. Use the parity stem for "
                    f"this sensor geometry.")
        # POSS pads H and W by +8 (salsanext_proto.py:426-431)
        return SalsaNext(pad_hw=8 if poss else 0, s2d_factors=(fi, fj),
                         **kwargs)
    if cfg.model.net_type == "rangenet":
        # POSS pads W by +24 (rangenet_proto.py:583-587)
        return RangeNet(layers=cfg.model.layers, pad_w=24 if poss else 0,
                        **kwargs)
    if cfg.model.net_type == "squeezesegv3":
        return SqueezeSegV3(layers=cfg.model.layers, **kwargs)
    raise ValueError(f"unknown net_type: {cfg.model.net_type}")


def build_model(cfg: ExperimentConfig, device: str | torch.device = "cuda",
                seed: int = 0) -> nn.Module:
    """The configured model in eval mode on ``device``, weights drawn from
    a ``torch.Generator`` seeded with ``seed`` (load trained weights with
    ``load_state_dict`` afterwards)."""
    dev = resolve_device(device)
    model = _make_model(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def build_optimizer(cfg: ExperimentConfig, params, steps_per_epoch: int
                    ) -> tuple[torch.optim.AdamW,
                               torch.optim.lr_scheduler.LambdaLR, Schedule]:
    """AdamW (weight decay ``cfg.train.weight_decay`` on every parameter)
    with the per-iteration warmup-cosine schedule; call ``scheduler.step()``
    after each ``optimizer.step()``."""
    schedule = warmup_cosine_schedule(
        cfg.train.lr,
        warmup_steps=cfg.train.warmup_epochs * steps_per_epoch,
        total_steps=cfg.train.n_epochs * steps_per_epoch,
    )
    opt = torch.optim.AdamW(params, lr=cfg.train.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.train.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_lambda(schedule, cfg.train.lr))
    return opt, sched, schedule


def build_alpha(cfg: ExperimentConfig) -> np.ndarray:
    counts = cfg.data.cls_counts or tuple(
        [0.0] + [1.0] * (cfg.data.n_classes - 1))
    return focal_alpha_from_counts(counts, ignore_cls=cfg.train.ignore_cls)


def build_state(
    cfg: ExperimentConfig,
    device: str | torch.device = "cuda",
    seed: int = 0,
    steps_per_epoch: int = 1000,
    batch_size: int | None = None,
) -> TrainState:
    """Model (weights from ``seed``), optimizer + schedule, prototype memory
    (truncated normal from ``seed + 1``) and a generator on ``device``
    seeded with ``seed + 2`` for the step's noise. ``batch_size`` is taken
    for the JAX signature's sake: torch modules need no input shape."""
    del batch_size
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, seed=seed)
    opt, sched, _ = build_optimizer(cfg, model.parameters(), steps_per_epoch)
    protos = init_prototypes(torch.Generator().manual_seed(seed + 1),
                             cfg.data.n_classes, cfg.contrast.sub_proto_size,
                             cfg.contrast.proj_dim)
    return TrainState(model=model, optimizer=opt, scheduler=sched,
                      prototypes=protos.to(dev), step=0,
                      generator=torch.Generator(device=dev).manual_seed(
                          seed + 2))
