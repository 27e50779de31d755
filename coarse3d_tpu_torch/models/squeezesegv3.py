"""SqueezeSegV3 (SAC backbone) with contrastive projection head (PyTorch).

Port of the JAX package's ``models/squeezesegv3.py``. Behavioral model: the
reference's squeezesegv3_Proto.py: SACBlock spatially-adaptive convolution
(a 7x7 conv + BN over the (possibly downsampled) xyz image gives a sigmoid
attention over the 3x3 unfold of the features, channel order c*9 + k as
``F.unfold``; then a 1x1 + 3x3 MLP with BN and ReLU and a residual add).
Backbone OS=8 with width-only strides [2, 2, 2, 1, 1]: stages 1-3 are SACs +
a downsampling conv with the xyz stream bilinear-halved in W, stages 4 and 5
SACs only at 256 channels. Decoder strides [1, 1, 2, 2, 2] with
ConvTranspose [1, 4] / [1, 2] width upsampling, skip adds and darknet
BasicBlocks; of the reference's five heads only head5 (32 channels -> 3x3
conv) is live; the contrastive mix is the skips at strides 1/2/4 plus the
backbone output (32 + 64 + 128 + 256 = 480 channels). No POSS padding.

Parameter names are the reference's (``backbone.enc1.residual_0.
attention_x.0``, ``position_mlp_2.3``, ``decoder.dec5.conv``, ``head5.1``).
The SAC BatchNorms use momentum 0.1, the shared darknet blocks 0.01
(``models/rangenet.py``). The dropout rate is 0.01 everywhere, fixed.

At full resolution one SAC block holds the (B, 9 * 32, H, W) unfold and an
attention map of the same size: 1.2 GB each at B=16, 64x2048, bf16. In eval
mode with grad off, a block runs its attention, product and 1x1 mix (with
their BatchNorms folded in) as one call, ``ops/sac_fused.py:sac_fused``:
kernel K4 on bf16 CUDA tensors, its plain twin on CPU tensors; neither map
is written. Training, and anything with grad on, runs the modules as they
are.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from coarse3d_tpu_torch.models.blocks import (
    Dropout2d,
    ProjectionHead,
    batch_norm,
)
from coarse3d_tpu_torch.models.rangenet import (
    BN_MOM,
    MODEL_BLOCKS,
    BasicBlock,
    DecoderStage,
    conv_bn,
    darknet_conv,
)
from coarse3d_tpu_torch.ops.resize import resize_bilinear
from coarse3d_tpu_torch.ops.sac_fused import SacWeights, fold_sac, sac_fused

DROP = 0.01


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*9, H, W): zero-padded 3x3 neighborhoods,
    channel-major (index = c*9 + k, k row-major over the window)."""
    b, c, h, w = x.shape
    return F.unfold(x, 3, padding=1).view(b, c * 9, h, w)


class SACBlock(nn.Module):
    """Spatially-adaptive conv: xyz-conditioned attention over unfolded 3x3
    features + 2-layer MLP + residual."""

    def __init__(self, features: int):
        super().__init__()
        c = features
        self.attention_x = nn.Sequential(
            nn.Conv2d(3, 9 * c, 7, padding=3), batch_norm(9 * c),
            nn.Sigmoid())
        self.position_mlp_2 = nn.Sequential(
            nn.Conv2d(9 * c, c, 1), batch_norm(c), nn.ReLU(),
            nn.Conv2d(c, c, 3, padding=1), batch_norm(c), nn.ReLU())

        self._folded: tuple[tuple, SacWeights] | None = None

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor
                ) -> torch.Tensor:
        if (self.training or torch.is_grad_enabled()
                or (feature.is_cuda and feature.dtype != torch.bfloat16)):
            att = self.attention_x(xyz)
            new = unfold3x3(feature) * att.to(feature.dtype)
            return self.position_mlp_2(new) + feature
        mixed = sac_fused(xyz.to(feature.dtype).contiguous(),
                          feature.contiguous(), self.folded(feature.dtype))
        return self.position_mlp_2[3:](mixed) + feature

    def folded(self, dtype: torch.dtype) -> SacWeights:
        """:func:`fold_sac` of this block for ``dtype`` features, cached
        until a tensor it reads is replaced or changed in place (a
        ``load_state_dict``, an optimizer step: the key holds each tensor's
        identity, storage and version counter)."""
        attention, mix = self.attention_x[:2], self.position_mlp_2[:2]
        reads = [*attention.parameters(), *attention.buffers(),
                 *mix.parameters(), *mix.buffers()]
        key = (dtype, *((id(t), t.data_ptr(), t._version) for t in reads))
        if self._folded is None or self._folded[0] != key:
            self._folded = (key, fold_sac(*attention, *mix, dtype))
        return self._folded[1]


class SACStage(nn.Module):
    """``n_blocks`` SAC blocks, then (stages 1-3) a width-halving conv."""

    def __init__(self, c_sac: int, c_out: int, n_blocks: int,
                 downsample: bool):
        super().__init__()
        for i in range(n_blocks):
            self.add_module(f"residual_{i}", SACBlock(c_sac))
        self.n_blocks = n_blocks
        self.downsample = downsample
        if downsample:
            self.conv = darknet_conv(c_sac, c_out, 3, stride_w=2)
            self.bn = batch_norm(c_out, BN_MOM)
        self.dropout = Dropout2d(DROP)

    def forward(self, xyz: torch.Tensor, x: torch.Tensor,
                generator: torch.Generator | None = None):
        for i in range(self.n_blocks):
            x = getattr(self, f"residual_{i}")(xyz, x)
        if self.downsample:
            x = conv_bn(x, self.conv, self.bn)
            xyz = resize_bilinear(xyz, xyz.shape[2], xyz.shape[3] // 2)
        return xyz, self.dropout(x, generator)


class Backbone(nn.Module):
    def __init__(self, in_channels: int, blocks: tuple[int, ...]):
        super().__init__()
        self.conv1 = darknet_conv(in_channels, 32, 3)
        self.bn1 = batch_norm(32, BN_MOM)
        stages = [(32, 64, True), (64, 128, True), (128, 256, True),
                  (256, 256, False), (256, 256, False)]
        for s, (c_sac, c_out, ds) in enumerate(stages):
            self.add_module(f"enc{s + 1}",
                            SACStage(c_sac, c_out, blocks[s], ds))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """Returns (features at W/8, skips keyed by width stride); xyz is
        channels 1:4 of the normalized input."""
        xyz = x[:, 1:4]
        feat = conv_bn(x, self.conv1, self.bn1)
        skips, os = {}, 1
        for s in range(5):
            stage = getattr(self, f"enc{s + 1}")
            if stage.downsample:
                # the skip is the STAGE INPUT, before its SAC blocks
                skips[os] = feat
                os *= 2
            xyz, feat = stage(xyz, feat, generator)
        return feat, skips


class ConvStage(nn.Module):
    """A stride-1 decoder stage: 3x3 conv (with bias) + BN + LeakyReLU, then
    the residual."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = darknet_conv(c_in, c_out, 3, bias=True)
        self.bn = batch_norm(c_out, BN_MOM)
        self.residual = BasicBlock(c_in, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.residual(conv_bn(x, self.conv, self.bn))


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        plan = [(256, 256, False), (256, 256, False), (256, 128, True),
                (128, 64, True), (64, 32, True)]
        for d, (c_in, c_out, up) in enumerate(plan):
            self.add_module(f"dec{5 - d}", (DecoderStage if up else ConvStage)(
                c_in, c_out))

    def forward(self, feat: torch.Tensor, skips: dict[int, torch.Tensor]
                ) -> torch.Tensor:
        os = 8
        for d in range(5):
            stage = getattr(self, f"dec{5 - d}")
            feat = stage(feat)
            if isinstance(stage, DecoderStage):
                os //= 2
                feat = feat + skips[os].to(feat.dtype)
        return feat


class SqueezeSegV3(nn.Module):
    def __init__(self, n_classes: int, layers: int = 21, in_channels: int = 5,
                 base_channels: int = 32, proj_dim: int = 256,
                 dropout_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pad_h: int = 0, pad_w: int = 0):
        super().__init__()
        # kept for the signature; the JAX model ignores them too
        del base_channels, dropout_rate, pad_h, pad_w
        self.layers = layers
        self.compute_dtype = compute_dtype
        self.backbone = Backbone(in_channels, MODEL_BLOCKS[layers])
        self.decoder = Decoder()
        self.dropout = Dropout2d(DROP)
        # dropout, then a 3x3 conv: ``head5.1`` is the conv
        self.head5 = nn.ModuleList([Dropout2d(DROP),
                                    nn.Conv2d(32, n_classes, 3, padding=1)])
        self.projector = ProjectionHead(480, proj_dim)

    def forward(self, x: torch.Tensor, return_feat: bool = False,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x: (B, in_channels >= 4, H, W) normalized range-image features.

        Returns {"logits", "probs"} (B, n_classes, H, W) float32, plus
        "embedding" (B, proj_dim, H, W) when ``return_feat``.
        """
        h0, w0 = x.shape[2], x.shape[3]
        if w0 % 8:
            raise ValueError(f"W must divide 8, got {w0}")

        dev = x.device.type
        with torch.autocast(dev, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            backbone_out, skips = self.backbone(x, generator)
            feat = self.dropout(self.decoder(backbone_out, skips), generator)
            feat = self.head5[0](feat, generator)

        with torch.autocast(dev, enabled=False):
            logits = self.head5[1](feat.float())
            out = {"logits": logits, "probs": torch.softmax(logits, dim=1)}
            if return_feat:
                h2, w2 = h0 // 2, w0 // 2
                mix = torch.cat(
                    [resize_bilinear(t.float(), h2, w2)
                     for t in (skips[1], skips[2], skips[4], backbone_out)],
                    dim=1)
                emb = self.projector(mix)
                emb = emb / torch.clamp_min(
                    torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-12)
                out["embedding"] = resize_bilinear(emb, h0, w0)
        return out
