"""Plain float32 copies of the two benchmarked model families.

SalsaNext (arXiv:2003.03653, as the COARSE3D reference's
``salsanext_proto.py`` builds it) and SqueezeSegV3-21 (arXiv:2004.01803,
``squeezesegv3_Proto.py``), frozen here so that later changes to the
program cannot move the yardstick. Module and parameter names are the
reference's, so one state dict loads into both these models and the
program's. Another family is a module of its own beside this one
(:func:`build`), made of this file's ``Conv2d``, ``ConvTranspose2d``,
``bn`` and ``Dropout2d`` so that what follows holds for it too.

Everything computes in float32; the caller turns TF32 off
(:func:`float32_math`). BatchNorm in training normalises with the batch's
biased variance and folds that variance into its running statistics (the
program's convention). Dropout drops whole channels with a mask drawn
from the generator passed in, in the same order and shapes as the
program draws it, so a training step here sees the same masks.

``set_fp8(model, True)`` makes every convolution quantise its input and
weight to float8 e4m3 (per-tensor scale, straight-through gradient): the
lower-precision control of the correctness check.
"""

from __future__ import annotations

import importlib
import importlib.util

import torch
import torch.nn as nn
import torch.nn.functional as F

LEAKY_SLOPE = 0.01       # SalsaNext
DARKNET_SLOPE = 0.1      # darknet blocks of SqueezeSegV3
DARKNET_BN_MOM = 0.01
SAC_DROP = 0.01
FP8_MAX = 448.0          # largest finite float8 e4m3


def float32_math() -> None:
    """Full float32 matrix products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _FakeFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = amax / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Fp8Mixin:
    fp8 = False

    def _q(self, x, w):
        if self.fp8:
            return _FakeFp8.apply(x), _FakeFp8.apply(w)
        return x, w


class Conv2d(_Fp8Mixin, nn.Conv2d):
    def forward(self, x):
        x, w = self._q(x, self.weight)
        return self._conv_forward(x, w, self.bias)


class ConvTranspose2d(_Fp8Mixin, nn.ConvTranspose2d):
    def forward(self, x):
        x, w = self._q(x, self.weight)
        return F.conv_transpose2d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def set_fp8(model: nn.Module, on: bool) -> None:
    for mod in model.modules():
        if isinstance(mod, _Fp8Mixin):
            mod.fp8 = on


class BatchNorm2d(nn.BatchNorm2d):
    """Training: batch mean and biased variance; the running statistics
    take that variance. Evaluation: the running statistics."""

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x * inv[None, :, None, None]
                + (self.bias - mean * inv)[None, :, None, None])


def bn(c: int, momentum: float = 0.1) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=momentum)


class Dropout2d(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        u = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                       device=generator.device).to(x.device)
        return x * ((u >= self.p).to(x.dtype) / (1.0 - self.p))


def resize(x, h, w):
    if x.shape[-2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class ProjectionHead(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(cin, cin, 1), bn(cin),
                                  nn.LeakyReLU(LEAKY_SLOPE), Conv2d(cin, dim, 1))

    def forward(self, x):
        return self.proj(x)


def _embed(head: ProjectionHead, maps, h: int, w: int):
    mix = torch.cat([resize(t, h // 2, w // 2) for t in maps], dim=1)
    emb = head(mix)
    emb = emb / torch.clamp_min(
        torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-12)
    return resize(emb, h, w)


# --------------------------------------------------------------- SalsaNext

def _cab(x, conv, norm):
    return norm(F.leaky_relu(conv(x), LEAKY_SLOPE))


class ResContextBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 1)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.bn1 = bn(cout)
        self.conv3 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = bn(cout)

    def forward(self, x):
        shortcut = F.leaky_relu(self.conv1(x), LEAKY_SLOPE)
        res = _cab(shortcut, self.conv2, self.bn1)
        return shortcut + _cab(res, self.conv3, self.bn2)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, drop, pooling=True, drop_out=True):
        super().__init__()
        self.pooling, self.drop_out = pooling, drop_out
        self.conv1 = Conv2d(cin, cout, 1)
        self.conv2 = Conv2d(cin, cout, 3, padding=1)
        self.bn1 = bn(cout)
        self.conv3 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = bn(cout)
        self.conv4 = Conv2d(cout, cout, 2, padding=1, dilation=2)
        self.bn3 = bn(cout)
        self.conv5 = Conv2d(3 * cout, cout, 1)
        self.bn4 = bn(cout)
        self.dropout = Dropout2d(drop)

    def forward(self, x, g=None):
        shortcut = F.leaky_relu(self.conv1(x), LEAKY_SLOPE)
        r1 = _cab(x, self.conv2, self.bn1)
        r2 = _cab(r1, self.conv3, self.bn2)
        r3 = _cab(r2, self.conv4, self.bn3)
        res = shortcut + _cab(torch.cat([r1, r2, r3], 1), self.conv5, self.bn4)
        out = self.dropout(res, g) if self.drop_out else res
        if self.pooling:
            return F.avg_pool2d(out, 3, stride=2, padding=1), res
        return out


class UpBlock(nn.Module):
    def __init__(self, cin, cout, drop, drop_out=True):
        super().__init__()
        self.drop_out = drop_out
        c = cin // 4 + 2 * cout
        self.conv1 = Conv2d(c, cout, 3, padding=1)
        self.bn1 = bn(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=2, dilation=2)
        self.bn2 = bn(cout)
        self.conv3 = Conv2d(cout, cout, 2, padding=1, dilation=2)
        self.bn3 = bn(cout)
        self.conv4 = Conv2d(3 * cout, cout, 1)
        self.bn4 = bn(cout)
        self.dropout1 = Dropout2d(drop)
        self.dropout2 = Dropout2d(drop)
        self.dropout3 = Dropout2d(drop)

    def forward(self, x, skip, g=None):
        up = F.pixel_shuffle(x, 2)
        if self.drop_out:
            up = self.dropout1(up, g)
        up = torch.cat([up, skip], 1)
        if self.drop_out:
            up = self.dropout2(up, g)
        e1 = _cab(up, self.conv1, self.bn1)
        e2 = _cab(e1, self.conv2, self.bn2)
        e3 = _cab(e2, self.conv3, self.bn3)
        out = _cab(torch.cat([e1, e2, e3], 1), self.conv4, self.bn4)
        return self.dropout3(out, g) if self.drop_out else out


class SalsaNext(nn.Module):
    def __init__(self, n_classes, in_channels=5, base_channels=32,
                 proj_dim=256, dropout_rate=0.2):
        super().__init__()
        bc, d = base_channels, dropout_rate
        self.downCntx = ResContextBlock(in_channels, bc)
        self.downCntx2 = ResContextBlock(bc, bc)
        self.downCntx3 = ResContextBlock(bc, bc)
        self.resBlock1 = ResBlock(bc, 2 * bc, d, drop_out=False)
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, d)
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, d)
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, d)
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, d, pooling=False)
        self.upBlock1 = UpBlock(8 * bc, 4 * bc, d)
        self.upBlock2 = UpBlock(4 * bc, 4 * bc, d)
        self.upBlock3 = UpBlock(4 * bc, 2 * bc, d)
        self.upBlock4 = UpBlock(2 * bc, bc, d, drop_out=False)
        self.cls_head = Conv2d(bc, n_classes, 1)
        self.projector = ProjectionHead(22 * bc, proj_dim)

    def forward(self, x, return_feat=False, generator=None):
        h, w = x.shape[2:]
        g = generator
        ctx = self.downCntx3(self.downCntx2(self.downCntx(x)))
        d0c, d0b = self.resBlock1(ctx, g)
        d1c, d1b = self.resBlock2(d0c, g)
        d2c, d2b = self.resBlock3(d1c, g)
        d3c, d3b = self.resBlock4(d2c, g)
        d5c = self.resBlock5(d3c, g)
        u = self.upBlock1(d5c, d3b, g)
        u = self.upBlock2(u, d2b, g)
        u = self.upBlock3(u, d1b, g)
        u = self.upBlock4(u, d0b, g)
        logits = self.cls_head(u)
        out = {"logits": logits}
        if return_feat:
            out["embedding"] = _embed(self.projector, (d0b, d1b, d2b, d3b),
                                      h, w)
        return out


# --------------------------------------------------------- SqueezeSegV3-21

SQSG_BLOCKS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}


def _dk_conv(cin, cout, k, stride_w=1, bias=False):
    return Conv2d(cin, cout, k, stride=(1, stride_w), padding=k // 2,
                  bias=bias)


def _cbl(x, conv, norm):
    return F.leaky_relu(norm(conv(x)), DARKNET_SLOPE)


class BasicBlock(nn.Module):
    def __init__(self, squeeze, features):
        super().__init__()
        self.conv1 = _dk_conv(features, squeeze, 1)
        self.bn1 = bn(squeeze, DARKNET_BN_MOM)
        self.conv2 = _dk_conv(squeeze, features, 3)
        self.bn2 = bn(features, DARKNET_BN_MOM)

    def forward(self, x):
        return x + _cbl(_cbl(x, self.conv1, self.bn1), self.conv2, self.bn2)


class SACBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.attention_x = nn.Sequential(Conv2d(3, 9 * c, 7, padding=3),
                                         bn(9 * c), nn.Sigmoid())
        self.position_mlp_2 = nn.Sequential(
            Conv2d(9 * c, c, 1), bn(c), nn.ReLU(),
            Conv2d(c, c, 3, padding=1), bn(c), nn.ReLU())

    def forward(self, xyz, feat):
        b, c, h, w = feat.shape
        unfold = F.unfold(feat, 3, padding=1).view(b, c * 9, h, w)
        return self.position_mlp_2(unfold * self.attention_x(xyz)) + feat


class SACStage(nn.Module):
    def __init__(self, c_sac, c_out, n_blocks, downsample):
        super().__init__()
        for i in range(n_blocks):
            self.add_module(f"residual_{i}", SACBlock(c_sac))
        self.n_blocks, self.downsample = n_blocks, downsample
        if downsample:
            self.conv = _dk_conv(c_sac, c_out, 3, stride_w=2)
            self.bn = bn(c_out, DARKNET_BN_MOM)
        self.dropout = Dropout2d(SAC_DROP)

    def forward(self, xyz, x, g=None):
        for i in range(self.n_blocks):
            x = getattr(self, f"residual_{i}")(xyz, x)
        if self.downsample:
            x = _cbl(x, self.conv, self.bn)
            xyz = resize(xyz, xyz.shape[2], xyz.shape[3] // 2)
        return xyz, self.dropout(x, g)


class SqBackbone(nn.Module):
    def __init__(self, in_channels, blocks):
        super().__init__()
        self.conv1 = _dk_conv(in_channels, 32, 3)
        self.bn1 = bn(32, DARKNET_BN_MOM)
        plan = [(32, 64, True), (64, 128, True), (128, 256, True),
                (256, 256, False), (256, 256, False)]
        for s, (c, co, ds) in enumerate(plan):
            self.add_module(f"enc{s + 1}", SACStage(c, co, blocks[s], ds))

    def forward(self, x, g=None):
        xyz = x[:, 1:4]
        feat = _cbl(x, self.conv1, self.bn1)
        skips, os = {}, 1
        for s in range(5):
            stage = getattr(self, f"enc{s + 1}")
            if stage.downsample:
                skips[os] = feat
                os *= 2
            xyz, feat = stage(xyz, feat, g)
        return feat, skips


class UpStage(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.upconv = ConvTranspose2d(cin, cout, (1, 4), stride=(1, 2),
                                      padding=(0, 1))
        self.bn = bn(cout, DARKNET_BN_MOM)
        self.residual = BasicBlock(cin, cout)

    def forward(self, x):
        return self.residual(_cbl(x, self.upconv, self.bn))


class ConvStage(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _dk_conv(cin, cout, 3, bias=True)
        self.bn = bn(cout, DARKNET_BN_MOM)
        self.residual = BasicBlock(cin, cout)

    def forward(self, x):
        return self.residual(_cbl(x, self.conv, self.bn))


class SqDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        plan = [(256, 256, False), (256, 256, False), (256, 128, True),
                (128, 64, True), (64, 32, True)]
        for d, (ci, co, up) in enumerate(plan):
            self.add_module(f"dec{5 - d}", (UpStage if up else ConvStage)(ci, co))

    def forward(self, feat, skips):
        os = 8
        for d in range(5):
            stage = getattr(self, f"dec{5 - d}")
            feat = stage(feat)
            if isinstance(stage, UpStage):
                os //= 2
                feat = feat + skips[os]
        return feat


class SqueezeSegV3(nn.Module):
    def __init__(self, n_classes, layers=21, in_channels=5, proj_dim=256):
        super().__init__()
        self.backbone = SqBackbone(in_channels, SQSG_BLOCKS[layers])
        self.decoder = SqDecoder()
        self.dropout = Dropout2d(SAC_DROP)
        self.head5 = nn.ModuleList([Dropout2d(SAC_DROP),
                                    Conv2d(32, n_classes, 3, padding=1)])
        self.projector = ProjectionHead(480, proj_dim)

    def forward(self, x, return_feat=False, generator=None):
        h, w = x.shape[2:]
        g = generator
        feat, skips = self.backbone(x, g)
        out_feat = self.dropout(self.decoder(feat, skips), g)
        out_feat = self.head5[0](out_feat, g)
        out = {"logits": self.head5[1](out_feat)}
        if return_feat:
            out["embedding"] = _embed(
                self.projector, (skips[1], skips[2], skips[4], feat), h, w)
        return out


def build(model_cfg: dict, n_classes: int, proj_dim: int) -> nn.Module:
    """The reference model a configuration file's ``model`` block names:
    SalsaNext and SqueezeSegV3 from this file, any other ``net_type``
    from the ``build(model_cfg, n_classes, proj_dim)`` of
    ``benchmark/reference/<net_type>.py``."""
    net = model_cfg["net_type"]
    if net == "salsanext":
        if model_cfg.get("stem", "parity") != "parity":
            raise ValueError("the reference has the parity stem only")
        return SalsaNext(n_classes, model_cfg.get("in_channels", 5),
                         model_cfg.get("base_channels", 32), proj_dim,
                         model_cfg.get("dropout_rate", 0.2))
    if net == "squeezesegv3":
        return SqueezeSegV3(n_classes, model_cfg.get("layers", 21),
                            model_cfg.get("in_channels", 5), proj_dim)
    module = f"benchmark.reference.{net}"
    if not net.isidentifier() or importlib.util.find_spec(module) is None:
        raise ValueError(f"no reference model for net_type {net!r}: "
                         f"no file benchmark/reference/{net}.py")
    return importlib.import_module(module).build(model_cfg, n_classes,
                                                 proj_dim)
