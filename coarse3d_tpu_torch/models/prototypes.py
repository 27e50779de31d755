"""Class-prototype memory: similarity, Sinkhorn clustering, EMA update.

Port of the JAX package's ``models/prototypes.py``. Behavioral model:
salsanext_proto.py:337-402 (``prototype_learning``): per class c,
Sinkhorn-cluster the class's pixels over ``sub_proto_size`` sub-prototypes;
keep only pixels whose nearest-prototype class prediction agrees with the
label; masked one-hot^T @ feats gives new sub-prototype means
(L2-normalized); EMA-update occupied rows; L2-renorm the memory. The
reference's feat_norm / mask_norm LayerNorms never receive gradients, so
they are parameter-free LayerNorms here, as in the JAX package.

``update_prototypes`` gathers each class's budgeted rows with one stable
sort (``ops/gather.py``) and hands the dense tail to
``ops/proto_update.py:proto_tail``: kernel K3 on a CUDA tensor, its plain
twin on a CPU tensor. The Sinkhorn Gumbel noise is an argument.
"""

from __future__ import annotations

import torch

from coarse3d_tpu_torch.configs.config import ContrastConfig
from coarse3d_tpu_torch.ops.gather import gather_class_indices
from coarse3d_tpu_torch.ops.proto_update import proto_tail


def _layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free LayerNorm over the last axis (biased variance)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=dim, keepdim=True), 1e-12)


def prototype_similarity(
    embedding: torch.Tensor, prototypes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cosine similarity of every pixel to every sub-prototype.

    Args:
      embedding: (..., D) projector output.
      prototypes: (C, K, D) memory.

    Returns (feat (N, D) normalized, sim (N, C, K), nearest (N, C) after the
    parameter-free class LayerNorm — reference :497-510).
    """
    d = embedding.shape[-1]
    feat = l2_normalize(_layer_norm(embedding.reshape(-1, d).float()))
    protos = l2_normalize(prototypes.float())
    sim = torch.einsum("nd,ckd->nck", feat, protos)
    nearest = _layer_norm(sim.amax(dim=-1))  # mask_norm analog
    return feat, sim, nearest


def gather_class_rows(
    prototypes: torch.Tensor,
    embedding: torch.Tensor,
    label: torch.Tensor,
    label_mask: torch.Tensor,
    cfg: ContrastConfig,
    ignore_cls: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense inputs of the prototype tail: (feat_rows (C, M, D), valid
    (C, M), l2-normalized memory (C, K, D)), each class's budgeted rows
    gathered with one stable sort. Arguments as :func:`update_prototypes`."""
    c = prototypes.shape[0]
    b, h, w, d = embedding.shape
    with torch.no_grad():
        protos = l2_normalize(prototypes.float())
        flat_label = label.reshape(-1)
        flat_valid = label_mask.reshape(-1) & (flat_label != ignore_cls)
        idx, valid = gather_class_indices(
            flat_label, flat_valid, c, cfg.max_pixels_per_class)  # (C, M)
        # gather first: only the (C, M) budgeted rows are ever consumed. A
        # permuted view of the model's NCHW output stays a view under this
        # reshape, so only the gathered rows are copied
        flat = embedding.detach().reshape(b, h * w, d)
        feat_rows = flat[idx // (h * w), idx % (h * w)].float()  # (C, M, D)
        return feat_rows, valid, protos.contiguous()


def update_prototypes(
    prototypes: torch.Tensor,
    embedding: torch.Tensor,
    label: torch.Tensor,
    label_mask: torch.Tensor,
    gumbel: torch.Tensor,
    cfg: ContrastConfig,
    ignore_cls: int = 0,
) -> torch.Tensor:
    """One EMA step of the prototype memory (no gradient).

    Args:
      prototypes: (C, K, D).
      embedding: (B, H, W, D) projector output.
      label: (B, H, W) int training labels (weak).
      label_mask: (B, H, W) bool — which labels supervise (wss mask).
      gumbel: (C, M, K) float32 Gumbel noise, M = cfg.max_pixels_per_class.
      cfg: contrast config (momentum, budget).

    Returns the new (C, K, D) memory.
    """
    feat_rows, valid, protos = gather_class_rows(
        prototypes, embedding, label, label_mask, cfg, ignore_cls)
    with torch.no_grad():
        return proto_tail(feat_rows, valid, protos,
                          gumbel.float().contiguous(),
                          momentum=cfg.proto_momentum, ignore_cls=ignore_cls)


def prototype_diagnostics(
    old: torch.Tensor,
    new: torch.Tensor,
    ignore_cls: int = 0,
) -> dict[str, torch.Tensor]:
    """Scalar health metrics of the prototype memory: mean cosine
    similarity between sub-prototypes of different classes
    (``proto_inter_sim``) and within a class (``proto_intra_sim``,
    self-pairs excluded), and the mean L2 step ||new - old|| over non-ignore
    rows (``proto_drift``). Ignore-class rows are excluded throughout."""
    c, k, d = new.shape
    dev = new.device
    rows = l2_normalize(new.float().reshape(c * k, d))
    cls = torch.repeat_interleave(torch.arange(c, device=dev), k)
    row_valid = cls != ignore_cls

    sim = rows @ rows.T                                     # (CK, CK)
    pair_valid = row_valid[:, None] & row_valid[None, :]
    same_cls = cls[:, None] == cls[None, :]
    self_pair = torch.eye(c * k, dtype=torch.bool, device=dev)

    inter_mask = pair_valid & ~same_cls
    intra_mask = pair_valid & same_cls & ~self_pair

    def masked_mean(values, mask):
        m = mask.to(torch.float32)
        return (values * m).sum() / torch.clamp_min(m.sum(), 1.0)

    drift = torch.linalg.vector_norm(new.float() - old.float(), dim=-1)
    return {
        "proto_inter_sim": masked_mean(sim, inter_mask),
        "proto_intra_sim": masked_mean(sim, intra_mask),
        "proto_drift": masked_mean(drift.reshape(c * k), row_valid),
    }


def update_prototypes_ddp_parity(*args, **kwargs):
    """The per-replica prototype update with a mean all-reduce
    (``contrast.ddp_parity_protos``) needs the multi-GPU data path."""
    raise NotImplementedError(
        "update_prototypes_ddp_parity is not ported yet: it comes with the "
        "multi-GPU data path (ROADMAP.md Queue 1 item 15)")
