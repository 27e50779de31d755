"""SalsaNext encoder-decoder with contrastive projection head (PyTorch).

Port of the JAX package's ``models/salsanext.py:SalsaNext`` (parity stem).
Behavioral model: the reference's salsanext_proto.py:253-492 (minus its
leftover debug block that overwrites inputs with torch.randn): 3
ResContext blocks, 5 ResBlocks (4 pooled), 4 PixelShuffle UpBlocks with
pre-pool skips, 1x1 class head -> softmax; for contrastive training the 4
pre-pool skip maps (22 * base channels) are bilinear-resized to (H/2, W/2),
concatenated, projected to an L2-normalized embedding, and upsampled back to
(H, W). SemanticPOSS inputs are zero-padded by ``pad_hw`` in H and W so
every stage divides by 16.

Layout and types: NCHW in and out (the JAX model is NHWC). The backbone
runs under autocast in ``compute_dtype`` (bf16 for the ``kitti`` preset,
with float32 parameters, as the JAX model computes in its ``dtype``); the
class head and the projector run in float32 with autocast off.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from coarse3d_tpu_torch.models.blocks import (
    ProjectionHead,
    ResBlock,
    ResContextBlock,
    UpBlock,
)
from coarse3d_tpu_torch.ops.resize import resize_bilinear

# Encoder parameter prefixes for encoder-only pretrained loads: the
# 198-name encoder_module.yaml analog (trainer.py:91-94, option.py:93-95),
# under the reference's module names, which this model uses.
ENCODER_PREFIXES = ("downCntx", "resBlock")


class SalsaNext(nn.Module):
    def __init__(self, n_classes: int, in_channels: int = 5,
                 base_channels: int = 32, proj_dim: int = 256,
                 dropout_rate: float = 0.2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pad_hw: int = 0):
        super().__init__()
        bc = base_channels
        drop = dropout_rate
        self.compute_dtype = compute_dtype
        self.pad_hw = pad_hw
        self.downCntx = ResContextBlock(in_channels, bc)
        self.downCntx2 = ResContextBlock(bc, bc)
        self.downCntx3 = ResContextBlock(bc, bc)
        self.resBlock1 = ResBlock(bc, 2 * bc, drop, pooling=True,
                                  drop_out=False)
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, drop, pooling=True)
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, drop, pooling=True)
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, drop, pooling=True)
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, drop, pooling=False)
        self.upBlock1 = UpBlock(8 * bc, 4 * bc, drop)
        self.upBlock2 = UpBlock(4 * bc, 4 * bc, drop)
        self.upBlock3 = UpBlock(4 * bc, 2 * bc, drop)
        self.upBlock4 = UpBlock(2 * bc, bc, drop, drop_out=False)
        self.cls_head = nn.Conv2d(bc, n_classes, 1)
        self.projector = ProjectionHead(22 * bc, proj_dim)

    def forward(self, x: torch.Tensor, return_feat: bool = False,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x: (B, in_channels, H, W) normalized range-image features;
        ``generator`` draws the dropout masks (needed in training when the
        dropout rate is above 0).

        Returns {"logits", "probs"} (B, n_classes, H, W) float32, plus
        "embedding" (B, proj_dim, H, W) when ``return_feat``.
        """
        h0, w0 = x.shape[2], x.shape[3]
        if self.pad_hw:
            x = F.pad(x, (0, self.pad_hw, 0, self.pad_hw))
        h, w = x.shape[2], x.shape[3]
        if h % 16 or w % 16:
            raise ValueError(f"H, W must divide 16, got {h}x{w}")

        dev = x.device.type
        with torch.autocast(dev, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            ctx = self.downCntx3(self.downCntx2(self.downCntx(x)))
            g = generator
            d0c, d0b = self.resBlock1(ctx, g)
            d1c, d1b = self.resBlock2(d0c, g)
            d2c, d2b = self.resBlock3(d1c, g)
            d3c, d3b = self.resBlock4(d2c, g)
            d5c = self.resBlock5(d3c, g)
            u4 = self.upBlock1(d5c, d3b, g)
            u3 = self.upBlock2(u4, d2b, g)
            u2 = self.upBlock3(u3, d1b, g)
            u1 = self.upBlock4(u2, d0b, g)

        with torch.autocast(dev, enabled=False):
            logits = self.cls_head(u1.float())
            if self.pad_hw:
                logits = logits[:, :, :h0, :w0]
            out = {"logits": logits, "probs": torch.softmax(logits, dim=1)}
            if return_feat:
                h2, w2 = h // 2, w // 2
                mix = torch.cat(
                    [resize_bilinear(t.float(), h2, w2)
                     for t in (d0b, d1b, d2b, d3b)], dim=1)
                emb = self.projector(mix)
                emb = emb / torch.clamp_min(
                    torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-12)
                emb = resize_bilinear(emb, h, w)
                if self.pad_hw:
                    emb = emb[:, :, :h0, :w0]
                out["embedding"] = emb
        return out
