"""RangeNet (darknet21/53) encoder-decoder with contrastive projection head
(PyTorch).

Port of the JAX package's ``models/rangenet.py``. Behavioral model: the
reference's rangenet_proto.py: a darknet backbone with *width-only* strides
[1, 2] (OS=32 on W, H untouched), BasicBlock residuals (1x1 -> 3x3, BN,
LeakyReLU 0.1), skip maps captured before each downsample and keyed by the
width stride; a ConvTranspose [1, 4] / [1, 2] width-doubling decoder whose
residual block runs BEFORE the skip add; a dropout + 3x3 conv head ->
softmax; the contrastive mix is the skips at strides 1/2/4/8 (32 + 64 + 128
+ 256 = 480 channels) resized to (H/2, W/2) -> ProjectionHead -> l2 norm ->
resize to the input size. SemanticPOSS inputs pad W by 24.

Parameter names are the reference's (``backbone.enc1.residual_0.conv1``,
``decoder.dec5.upconv``, ``head.1``, ``projector.proj.0``), so a reference
state dict loads with ``load_state_dict(strict=True)``.

Flax -> PyTorch, where this family differs from SalsaNext: the order is
conv -> BN -> LeakyReLU(0.1); BatchNorm momentum is 0.01 (Flax 0.99); the
strided conv pads k // 2 on both sides (``padding=1``); a transposed conv's
PyTorch kernel is the Flax one transposed and flipped in space
(``tools/convert_jax_params.py``); the dropout rates are fixed by the depth
(``dropout_rate`` is taken and unused, as in the JAX model).

Layout and types as ``models/salsanext.py``: NCHW in and out, the backbone
under autocast in ``compute_dtype``, the head and the projector in float32.

Spans (``utils/profiling.py:span``): ``model.encoder`` holds the darknet
backbone, ``model.decoder`` the decoder with its dropout and the head's
dropout; they nest in ``serve.backbone`` or ``train.forward``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from coarse3d_tpu_torch.models.blocks import (
    BatchNorm2d,
    Dropout2d,
    ProjectionHead,
    batch_norm,
)
from coarse3d_tpu_torch.ops.resize import resize_bilinear
from coarse3d_tpu_torch.utils.profiling import span

# residual block counts per darknet depth (rangenet_proto.py:70-73)
MODEL_BLOCKS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}
# PyTorch momentum (weight of the new value); Flax's is 0.99
BN_MOM = 0.01
DARKNET_SLOPE = 0.1


def conv_bn(x: torch.Tensor, conv: nn.Module, bn: BatchNorm2d) -> torch.Tensor:
    """conv -> batchnorm -> leaky_relu(0.1), the JAX ``ConvBN`` /
    ``UpConvBN`` (the conv and the BN stay attributes of their block under
    the reference's names)."""
    return F.leaky_relu(bn(conv(x)), DARKNET_SLOPE)


def darknet_conv(cin: int, cout: int, kernel: int, stride_w: int = 1,
                 bias: bool = False) -> nn.Conv2d:
    """A conv of the darknet families: stride on W only, padding k // 2 on
    both sides (not XLA's "SAME", which would pad (0, 1) at stride 2)."""
    return nn.Conv2d(cin, cout, kernel, stride=(1, stride_w),
                     padding=kernel // 2, bias=bias)


class BasicBlock(nn.Module):
    """Darknet residual: 1x1 squeeze -> 3x3 expand, both BN+LeakyReLU(0.1)."""

    def __init__(self, squeeze: int, features: int):
        super().__init__()
        self.conv1 = darknet_conv(features, squeeze, 1)
        self.bn1 = batch_norm(squeeze, BN_MOM)
        self.conv2 = darknet_conv(squeeze, features, 3)
        self.bn2 = batch_norm(features, BN_MOM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = conv_bn(x, self.conv1, self.bn1)
        return x + conv_bn(res, self.conv2, self.bn2)


class EncoderStage(nn.Module):
    """Width-halving conv, then ``n_blocks`` residuals, then dropout."""

    def __init__(self, c_in: int, c_out: int, n_blocks: int, drop: float):
        super().__init__()
        self.conv = darknet_conv(c_in, c_out, 3, stride_w=2)
        self.bn = batch_norm(c_out, BN_MOM)
        for i in range(n_blocks):
            self.add_module(f"residual_{i}", BasicBlock(c_in, c_out))
        self.n_blocks = n_blocks
        self.dropout = Dropout2d(drop)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = conv_bn(x, self.conv, self.bn)
        for i in range(self.n_blocks):
            x = getattr(self, f"residual_{i}")(x)
        return self.dropout(x, generator)


class DecoderStage(nn.Module):
    """ConvTranspose [1, 4] stride [1, 2] pad [0, 1] (exact width doubling),
    BN, LeakyReLU, then the residual, which squeezes UP to ``c_in``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.upconv = nn.ConvTranspose2d(c_in, c_out, (1, 4), stride=(1, 2),
                                         padding=(0, 1))
        self.bn = batch_norm(c_out, BN_MOM)
        self.residual = BasicBlock(c_in, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.residual(conv_bn(x, self.upconv, self.bn))


class Backbone(nn.Module):
    def __init__(self, in_channels: int, blocks: tuple[int, ...], drop: float):
        super().__init__()
        self.conv1 = darknet_conv(in_channels, 32, 3)
        self.bn1 = batch_norm(32, BN_MOM)
        chans = [(32, 64), (64, 128), (128, 256), (256, 512), (512, 1024)]
        for s, (c_in, c_out) in enumerate(chans):
            self.add_module(f"enc{s + 1}",
                            EncoderStage(c_in, c_out, blocks[s], drop))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """Returns (features at W/32, skips keyed by width stride)."""
        feat = conv_bn(x, self.conv1, self.bn1)
        skips, os = {}, 1
        for s in range(5):
            skips[os] = feat            # captured before the downsample
            os *= 2
            feat = getattr(self, f"enc{s + 1}")(feat, generator)
        return feat, skips


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        plan = [(1024, 512), (512, 256), (256, 128), (128, 64), (64, 32)]
        for d, (c_in, c_out) in enumerate(plan):
            self.add_module(f"dec{5 - d}", DecoderStage(c_in, c_out))

    def forward(self, feat: torch.Tensor, skips: dict[int, torch.Tensor]
                ) -> torch.Tensor:
        os = 32
        for d in range(5):
            feat = getattr(self, f"dec{5 - d}")(feat)
            os //= 2
            feat = feat + skips[os].to(feat.dtype)
        return feat


class RangeNet(nn.Module):
    def __init__(self, n_classes: int, layers: int = 21, in_channels: int = 5,
                 base_channels: int = 32, proj_dim: int = 256,
                 dropout_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pad_h: int = 0, pad_w: int = 0):
        super().__init__()
        # base_channels is fixed by the architecture and dropout_rate is
        # unused (darknet has its own rates): both kept for the signature
        del base_channels, dropout_rate
        drop_enc = 0.01 if layers == 21 else 0.05
        drop_dec = 0.001 if layers == 21 else 0.005
        self.layers = layers
        self.compute_dtype = compute_dtype
        self.pad_h, self.pad_w = pad_h, pad_w
        self.backbone = Backbone(in_channels, MODEL_BLOCKS[layers], drop_enc)
        self.decoder = Decoder()
        self.dropout = Dropout2d(drop_dec)
        # dropout, then a 3x3 conv: ``head.1`` is the conv
        self.head = nn.ModuleList([Dropout2d(drop_enc),
                                   nn.Conv2d(32, n_classes, 3, padding=1)])
        self.projector = ProjectionHead(480, proj_dim)

    def forward(self, x: torch.Tensor, return_feat: bool = False,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """x: (B, in_channels, H, W) normalized range-image features.

        Returns {"logits", "probs"} (B, n_classes, H, W) float32, plus
        "embedding" (B, proj_dim, H, W) when ``return_feat``.
        """
        h0, w0 = x.shape[2], x.shape[3]
        if self.pad_h or self.pad_w:
            x = F.pad(x, (0, self.pad_w, 0, self.pad_h))
        if x.shape[3] % 32:
            raise ValueError(f"W must divide 32, got {x.shape[3]}")

        dev = x.device.type
        with torch.autocast(dev, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            with span("model.encoder"):
                feat, skips = self.backbone(x, generator)
            with span("model.decoder"):
                feat = self.dropout(self.decoder(feat, skips), generator)
                feat = self.head[0](feat, generator)

        with torch.autocast(dev, enabled=False):
            logits = self.head[1](feat.float())
            if self.pad_h or self.pad_w:
                logits = logits[:, :, :h0, :w0]
            out = {"logits": logits, "probs": torch.softmax(logits, dim=1)}
            if return_feat:
                h2, w2 = logits.shape[2] // 2, logits.shape[3] // 2
                mix = torch.cat([resize_bilinear(skips[s].float(), h2, w2)
                                 for s in (1, 2, 4, 8)], dim=1)
                emb = self.projector(mix)
                emb = emb / torch.clamp_min(
                    torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-12)
                # resized to the input size, not cropped (the skips still
                # hold the padded columns)
                out["embedding"] = resize_bilinear(emb, h0, w0)
        return out
