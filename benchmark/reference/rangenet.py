"""RangeNet-21 and RangeNet-53 in plain float32.

RangeNet++ (Milioto, Vizzo, Behley and Stachniss, IROS 2019), as
lidar-bonnetal builds it (``backbones/darknet.py``, ``decoders/darknet.py``,
``arch/darknet53.yaml``) and COARSE3D's ``rangenet_proto.py`` wraps it:

- the encoder is DarkNet: a 3x3 conv to 32 channels, then five stages,
  each a 3x3 conv with stride 2 on the width alone (padding 1) to 64, 128,
  256, 512 and 1024 channels, then 1, 2, 8, 8 and 4 residual blocks at 53
  layers (1, 1, 2, 2, 1 at 21), then channel dropout. A residual block is a
  1x1 squeeze to the stage's input width and a 3x3 expand back, each
  conv -> BatchNorm -> LeakyReLU(0.1), added to its input. The skip of
  each width stride 1..16 is the map that enters the stage that halves it;
- the decoder is five stages, each a ``ConvTranspose2d`` with kernel (1, 4),
  stride (1, 2) and padding (0, 1) that doubles the width, BatchNorm,
  LeakyReLU(0.1), then a residual block whose 1x1 conv widens to the
  stage's input width; the skip of the stride reached is added after the
  residual; channel dropout follows the last stage;
- the head is channel dropout and a 3x3 conv to the classes.

Departures from lidar-bonnetal, each COARSE3D's or the program's:

- the contrastive projector: the skips of strides 1, 2, 4 and 8 (32 + 64 +
  128 + 256 = 480 channels), resized to half the image, a ``ProjectionHead``,
  l2-normalised and resized to the image (``embedding``);
- the dropout rates are fixed by the depth (encoder and head 0.05, decoder
  0.005 at 53 layers; 0.01 and 0.001 at 21), where lidar-bonnetal reads
  them from the architecture file;
- BatchNorm momentum 0.01 in PyTorch's convention (the weight of the new
  batch), and in training its running variance takes the batch's biased
  variance (``models.py:BatchNorm2d``);
- the skips are not detached: lidar-bonnetal stops their gradients
  (``skips[os] = x.detach()``); the forward is the same.

Parameter names are the program's (``backbone.enc1.residual_0.conv1``,
``decoder.dec5.upconv``, ``head.1``, ``projector.proj.0``). Built from
``models.py``'s ``Conv2d``, ``ConvTranspose2d``, ``bn`` and ``Dropout2d``,
so that ``set_fp8``, BatchNorm calibration and the seeded dropout masks
reach every layer; dropout draws its masks in the program's order.
"""

from __future__ import annotations

import torch.nn as nn

from benchmark.reference.models import (
    DARKNET_BN_MOM,
    BasicBlock,
    Conv2d,
    Dropout2d,
    ProjectionHead,
    UpStage,
    _cbl,
    _dk_conv,
    _embed,
    bn,
)

BLOCKS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}
WIDTHS = (32, 64, 128, 256, 512, 1024)
DROPOUT = {21: (0.01, 0.001), 53: (0.05, 0.005)}   # encoder and head, decoder


class EncoderStage(nn.Module):
    def __init__(self, cin, cout, n_blocks, drop):
        super().__init__()
        self.conv = _dk_conv(cin, cout, 3, stride_w=2)
        self.bn = bn(cout, DARKNET_BN_MOM)
        for i in range(n_blocks):
            self.add_module(f"residual_{i}", BasicBlock(cin, cout))
        self.n_blocks = n_blocks
        self.dropout = Dropout2d(drop)

    def forward(self, x, g=None):
        x = _cbl(x, self.conv, self.bn)
        for i in range(self.n_blocks):
            x = getattr(self, f"residual_{i}")(x)
        return self.dropout(x, g)


class Backbone(nn.Module):
    def __init__(self, in_channels, blocks, drop):
        super().__init__()
        self.conv1 = _dk_conv(in_channels, WIDTHS[0], 3)
        self.bn1 = bn(WIDTHS[0], DARKNET_BN_MOM)
        for s in range(5):
            self.add_module(f"enc{s + 1}", EncoderStage(
                WIDTHS[s], WIDTHS[s + 1], blocks[s], drop))

    def forward(self, x, g=None):
        feat = _cbl(x, self.conv1, self.bn1)
        skips = {}
        for s in range(5):
            skips[2 ** s] = feat
            feat = getattr(self, f"enc{s + 1}")(feat, g)
        return feat, skips


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        for s in range(5, 0, -1):
            self.add_module(f"dec{s}", UpStage(WIDTHS[s], WIDTHS[s - 1]))

    def forward(self, feat, skips):
        for s in range(5, 0, -1):
            feat = getattr(self, f"dec{s}")(feat) + skips[2 ** (s - 1)]
        return feat


class RangeNet(nn.Module):
    def __init__(self, n_classes, layers=21, in_channels=5, proj_dim=256):
        super().__init__()
        drop_enc, drop_dec = DROPOUT[layers]
        self.backbone = Backbone(in_channels, BLOCKS[layers], drop_enc)
        self.decoder = Decoder()
        self.dropout = Dropout2d(drop_dec)
        self.head = nn.ModuleList([Dropout2d(drop_enc),
                                   Conv2d(WIDTHS[0], n_classes, 3, padding=1)])
        self.projector = ProjectionHead(480, proj_dim)

    def forward(self, x, return_feat=False, generator=None):
        h, w = x.shape[2:]
        g = generator
        feat, skips = self.backbone(x, g)
        feat = self.dropout(self.decoder(feat, skips), g)
        out = {"logits": self.head[1](self.head[0](feat, g))}
        if return_feat:
            out["embedding"] = _embed(self.projector,
                                      [skips[s] for s in (1, 2, 4, 8)], h, w)
        return out


def build(model_cfg: dict, n_classes: int, proj_dim: int) -> nn.Module:
    return RangeNet(n_classes, model_cfg.get("layers", 21),
                    model_cfg.get("in_channels", 5), proj_dim)
