"""Train and eval steps.

Port of the JAX package's ``train/step.py``. Behavioral model: the reference
hot loop (trainer.py:572-747): normalize features by sensor stats gated on
the eval mask, forward, focal + Lovász on weak pixels, then (from the
contrast warmup epoch) entropy-driven pseudo-label selection +
prototype-anchor InfoNCE + Sinkhorn/EMA prototype update, backward + AdamW +
per-iteration LR step, then 3D unprojected confusion-matrix metrics.

Differences of form, not of result:
- the step updates the state in place (model, optimizer, schedule) and
  replaces its prototype memory; it returns the same state object;
- its noise is an argument: ``noise`` = {"select": (B*H*W,) Gumbel,
  "anchor": (B, C, A) uniforms, "proto": (C, M, K) Gumbel}; when None it is
  drawn from the state's device generator (:func:`draw_noise`), and so are
  the dropout masks, always;
- the model returns NCHW maps; the losses take (B, H, W, C) and
  (B, H, W, D) permuted views of them, so the (B, D, H, W) embedding is
  never copied: the anchor and class gathers read only the rows they need.

Nothing inside the step reads a value back to the host: no ``.item()``, no
Python branch on a tensor.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from coarse3d_tpu_torch.configs.config import ExperimentConfig
from coarse3d_tpu_torch.eval.unproject import unproject_image
from coarse3d_tpu_torch.losses.contrast import contrast_mem_loss
from coarse3d_tpu_torch.losses.entropy_selection import entropy_based_selection
from coarse3d_tpu_torch.losses.focal import focal_softmax_loss
from coarse3d_tpu_torch.losses.lovasz import (
    lovasz_budget_overflow,
    lovasz_softmax_loss,
)
from coarse3d_tpu_torch.metrics.iou import confusion_matrix
from coarse3d_tpu_torch.models.prototypes import (
    prototype_diagnostics,
    update_prototypes,
)
from coarse3d_tpu_torch.ops.knn import knn_postprocess
from coarse3d_tpu_torch.ops.projection import normalize_features
from coarse3d_tpu_torch.train.state import TrainState

_TINY = float(np.finfo(np.float32).tiny)


def batch_to_device(batch: dict[str, Any], device: torch.device
                    ) -> dict[str, torch.Tensor]:
    """The pipeline's batch dict (numpy or tensors) as tensors on device."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp_min(u, _TINY)))


def draw_noise(generator: torch.Generator, cfg: ExperimentConfig, b: int,
               h: int, w: int) -> dict[str, torch.Tensor]:
    """The contrast step's noise, drawn on the generator's device."""
    c = cfg.data.n_classes
    return {
        "select": _gumbel((b * h * w,), generator),
        "anchor": torch.rand((b, c, cfg.contrast.num_anchor),
                             generator=generator, device=generator.device),
        "proto": _gumbel((c, cfg.contrast.max_pixels_per_class,
                          cfg.contrast.sub_proto_size), generator),
    }


def _prepare_inputs(batch: dict[str, torch.Tensor], cfg: ExperimentConfig):
    train_label = batch["train_label"].to(torch.int32)
    eval_label = batch["eval_label"].to(torch.int32)
    wss_mask = train_label > 0
    eval_mask = eval_label > 0
    features = normalize_features(batch["features"].float(), eval_mask,
                                  cfg.sensor)
    return features, train_label, eval_label, wss_mask, eval_mask


def _metrics_3d(probs: torch.Tensor, batch, cfg: ExperimentConfig
                ) -> torch.Tensor:
    """Unproject the 2D argmax of probs (B, H, W, C) and count the
    confusion update."""
    argmax_2d = torch.argmax(probs, dim=-1).to(torch.int32)
    point_pred = unproject_image(argmax_2d, batch["point_px"],
                                 batch["point_py"])
    return confusion_matrix(point_pred, batch["point_label"],
                            cfg.data.n_classes, valid=batch["point_valid"])


def make_train_step(cfg: ExperimentConfig, alpha, *, with_contrast: bool):
    """Build the train step. ``with_contrast`` is the analog of the
    reference's ``epoch >= contrast_warmup`` gate (trainer.py:532-541)."""
    if with_contrast and cfg.contrast.ddp_parity_protos:
        raise NotImplementedError(
            "contrast.ddp_parity_protos is not ported yet (ROADMAP.md Queue 1 "
            "item 15)")
    alpha_np = np.asarray(alpha, np.float32)
    ignore = cfg.train.ignore_cls
    alpha_on: dict[torch.device, torch.Tensor] = {}  # made once per device

    def train_step(state: TrainState, batch: dict[str, torch.Tensor],
                   select_ratio=0.0, noise: dict[str, Any] | None = None):
        model = state.model
        dev = state.device
        (features, train_label, _, wss_mask,
         eval_mask) = _prepare_inputs(batch, cfg)
        b, h, w = train_label.shape
        if with_contrast:
            if noise is None:
                noise = draw_noise(state.generator, cfg, b, h, w)
            noise = {k: torch.as_tensor(v).to(dev, torch.float32)
                     for k, v in noise.items()}
        if dev not in alpha_on:
            alpha_on[dev] = torch.from_numpy(alpha_np).to(dev)
        alpha_t = alpha_on[dev]

        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = model(features.permute(0, 3, 1, 2).contiguous(),
                    return_feat=with_contrast, generator=state.generator)
        probs = out["probs"].permute(0, 2, 3, 1)             # (B, H, W, C)

        losses: dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=dev)
        if cfg.train.loss_w_ce_2d > 0:
            losses["focal"] = focal_softmax_loss(
                probs, train_label, alpha_t, wss_mask,
                gamma=cfg.train.focal_gamma)
            total = total + cfg.train.loss_w_ce_2d * losses["focal"]
        if cfg.train.loss_w_lov_2d > 0:
            losses["lovasz"] = lovasz_softmax_loss(
                probs, train_label, ignore=ignore,
                budget=cfg.train.lovasz_budget or None)
            total = total + cfg.train.loss_w_lov_2d * losses["lovasz"]
            if cfg.train.lovasz_budget:
                # not a loss: truncation sentinel
                losses["lovasz_overflow"] = lovasz_budget_overflow(
                    train_label, ignore,
                    cfg.train.lovasz_budget).to(torch.float32)

        embedding = None
        if with_contrast:
            embedding = out["embedding"].permute(0, 2, 3, 1)  # (B, H, W, D)
        if with_contrast and cfg.contrast.loss_w_contrast > 0:
            if cfg.contrast.entropy_selection:
                pseudo_label, pseudo_mask = entropy_based_selection(
                    probs.detach(), wss_mask, eval_mask, train_label,
                    select_ratio, noise["select"], ignore_cls=ignore)
            else:
                pseudo_label, pseudo_mask = train_label, wss_mask
            losses["contrast"] = contrast_mem_loss(
                embedding, probs.detach(), pseudo_label, pseudo_mask,
                state.prototypes.detach(), noise["anchor"], cfg.contrast,
                ignore_cls=ignore)
            total = total + cfg.contrast.loss_w_contrast * losses["contrast"]
        losses["total"] = total

        total.backward()
        # optax updates every parameter at every step (its count, moment
        # decay and weight decay are global); torch's AdamW skips a
        # parameter whose grad is None (the projector in a warmup step)
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1

        metrics: dict[str, Any] = {
            "losses": {k: v.detach() for k, v in losses.items()}}
        old_protos = state.prototypes
        if with_contrast and cfg.contrast.use_prototype:
            state.prototypes = update_prototypes(
                old_protos, embedding.detach(), train_label, wss_mask,
                noise["proto"], cfg.contrast, ignore_cls=ignore)
        if with_contrast:
            metrics["diag"] = prototype_diagnostics(
                old_protos, state.prototypes, ignore_cls=ignore)
        metrics["confusion"] = _metrics_3d(probs.detach(), batch, cfg)
        return state, metrics

    return train_step


def make_eval_step(cfg: ExperimentConfig, use_knn: bool = False,
                   return_point_pred: bool = False, use_crf: bool = False):
    """``use_knn`` applies the KNN range cleanup to the unprojected labels
    before the confusion matrix (kernel K2 on the card). The CRF refinement
    is not ported yet."""
    if use_crf:
        raise NotImplementedError(
            "use_crf is not ported yet (ROADMAP.md Queue 1 item 16)")

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict[str, torch.Tensor]):
        features, _, _, _, _ = _prepare_inputs(batch, cfg)
        state.model.eval()
        logits = state.model(features.permute(0, 3, 1, 2).contiguous(),
                             return_feat=False)["logits"]
        # argmax over logits (softmax is monotonic); the first maximum wins
        argmax_2d = torch.argmax(logits, dim=1).to(torch.int32)
        if use_knn:
            point_pred = knn_postprocess(
                batch["features"][..., 0].float().contiguous(),
                batch["point_depth"].float().contiguous(), argmax_2d,
                batch["point_px"].to(torch.int32).contiguous(),
                batch["point_py"].to(torch.int32).contiguous(),
                n_classes=cfg.data.n_classes, knn=cfg.knn.knn,
                search=cfg.knn.search, sigma=cfg.knn.sigma,
                cutoff=cfg.knn.cutoff)
        else:
            point_pred = unproject_image(argmax_2d, batch["point_px"],
                                         batch["point_py"])
        conf = confusion_matrix(point_pred, batch["point_label"],
                                cfg.data.n_classes, valid=batch["point_valid"])
        result = {"confusion": conf, "argmax_2d": argmax_2d}
        if return_point_pred:
            result["point_pred"] = point_pred
        return result

    return eval_step


def select_ratio_schedule(n_epochs: int):
    """Pseudo-label keep ratio (trainer.py:656-661):
    0.5 * log(1 + (1+epoch)/n_epochs) / log(2)."""

    def ratio(epoch: int) -> float:
        return float(0.5 * np.log(1 + (1 + epoch) / n_epochs) / np.log(2))

    return ratio
