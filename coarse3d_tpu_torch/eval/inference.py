"""Device inference: projection -> forward -> KNN -> per-point labels.

Port of the JAX package's ``eval/inference.py:make_inference_fn``, the
serving path (projection, 5-channel features and normalisation, the model
``build_model`` gave, argmax over logits, KNN range vote). On a CUDA model the projection's
scatter-min and the KNN vote run as the hand-written kernels K1 and K2; on
a CPU model they run their plain twins. There is no knob: the device picks.
While a profiler records, each call records the spans ``serve.batch`` and,
inside it, ``serve.copy_in``, ``serve.project``, ``serve.backbone`` and
``serve.knn`` (``utils/profiling.py``).
"""

from __future__ import annotations

import itertools

import torch

from coarse3d_tpu_torch.configs.config import ExperimentConfig
from coarse3d_tpu_torch.eval.unproject import unproject_image
from coarse3d_tpu_torch.ops.knn import knn_postprocess
from coarse3d_tpu_torch.ops.projection import (
    build_range_features,
    normalize_features,
    range_project_batch,
)
from coarse3d_tpu_torch.utils.profiling import span


def make_inference_fn(model: torch.nn.Module, cfg: ExperimentConfig,
                      use_knn: bool = True):
    """Returns infer(points (B, P, 4) float32, valid (B, P) bool) -> labels
    (B, P) int32 on the model's device (inputs are moved there)."""
    sensor = cfg.sensor
    knn_cfg = cfg.knn
    n_classes = cfg.data.n_classes
    device = next(model.parameters()).device
    batches = itertools.count()     # the served batch's number, for spans

    @torch.inference_mode()
    def infer(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        with span("serve.batch", rid=next(batches)):
            with span("serve.copy_in"):
                points = points.to(device, torch.float32)
                valid = valid.to(device, torch.bool)
            with span("serve.project"):
                proj = range_project_batch(points, valid, sensor)
                feats = build_range_features(proj["proj_points"],
                                             proj["proj_range"])
                mask = proj["proj_idx"] >= 0
                x = normalize_features(feats, mask, sensor)
            with span("serve.backbone"):
                logits = model(x.permute(0, 3, 1, 2).contiguous())["logits"]
                # argmax over LOGITS (softmax is monotonic); the first
                # maximum wins
                argmax_2d = torch.argmax(logits, dim=1).to(torch.int32)
            with span("serve.knn"):
                if use_knn:
                    return knn_postprocess(
                        proj["proj_range"], proj["depth"], argmax_2d,
                        proj["px"], proj["py"], n_classes=n_classes,
                        knn=knn_cfg.knn, search=knn_cfg.search,
                        sigma=knn_cfg.sigma, cutoff=knn_cfg.cutoff)
                return unproject_image(argmax_2d, proj["px"], proj["py"])

    return infer
