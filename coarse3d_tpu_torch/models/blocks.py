"""Shared conv building blocks of SalsaNext (PyTorch, NCHW).

Port of the JAX package's ``models/blocks.py`` (``ConvActBN``,
``ResContextBlock``, ``ResBlock``, ``UpBlock``, ``ProjectionHead``,
``pixel_shuffle``). Behavioral model: the SalsaNext block zoo of the
reference's salsanext_proto.py — ResContextBlock (:38-65), ResBlock
(:68-148), UpBlock (:151-212) — with the reference's attribute names
(``conv1``, ``bn1``, ...), so a reference state dict loads with
``load_state_dict(strict=True)``.

Flax -> PyTorch: BatchNorm momentum 0.9 (Flax, weight of the old value) is
PyTorch momentum 0.1, eps 1e-5, and in training the running variance
takes the biased batch variance, as Flax's does (:class:`BatchNorm2d`);
"SAME" 3x3 with dilation 2 is padding 2; the 2x2 kernel with dilation 2
takes an explicit pad of 1 (an effective 3x3 that keeps the size); dropout
drops whole channels (Dropout2d, the JAX ``broadcast_dims=(1, 2)``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LEAKY_SLOPE = 0.01


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, C*r*r, H, W) -> (B, C, H*r, W*r), torch PixelShuffle channel order
    (the JAX ``pixel_shuffle`` rearranges to the same order in NHWC)."""
    return F.pixel_shuffle(x, r)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward folds the BIASED batch
    variance into ``running_var``, as Flax's ``nn.BatchNorm`` folds it into
    ``batch_stats.var``. PyTorch folds the unbiased one (n / (n - 1) times
    larger), so the two drift apart by 1/(n - 1) of the variance per step.

    The normalisation itself is PyTorch's (biased batch variance, as in
    Flax). PyTorch's update of the variance, (1 - m) old + m var_unbiased,
    is rescaled in its m-term by (n - 1) / n to (1 - m) old + m var_biased,
    with no second pass over the activations.
    Parameter and buffer names are those of ``nn.BatchNorm2d``.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        # PyTorch's update goes into a copy: the graph keeps what the op
        # saw, and running_var is then written once, corrected
        folded = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, folded, self.weight,
                         self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_((folded - kept) * ((n - 1) / n) + kept)
        return y


def _bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=1e-5, momentum=0.1)


def conv_act_bn(x: torch.Tensor, conv: nn.Conv2d, bn: BatchNorm2d
                ) -> torch.Tensor:
    """conv -> leaky_relu -> batchnorm, the reference's recurring triplet
    (the JAX ``ConvActBN`` module; here the conv and the BN stay attributes
    of the block under the reference's names)."""
    return bn(F.leaky_relu(conv(x), LEAKY_SLOPE))


def _conv3(cin: int, cout: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation)


def _conv2_dil2(cin: int, cout: int) -> nn.Conv2d:
    # 2x2 kernel, dilation 2, pad 1 keeps spatial size (effective 3x3)
    return nn.Conv2d(cin, cout, 2, padding=1, dilation=2)


class ResContextBlock(nn.Module):
    """1x1 shortcut + two 3x3 convs (2nd dilated), residual sum."""

    def __init__(self, in_filters: int, out_filters: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_filters, out_filters, 1)
        self.conv2 = _conv3(out_filters, out_filters)
        self.bn1 = _bn(out_filters)
        self.conv3 = _conv3(out_filters, out_filters, dilation=2)
        self.bn2 = _bn(out_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = F.leaky_relu(self.conv1(x), LEAKY_SLOPE)
        res = conv_act_bn(shortcut, self.conv2, self.bn1)
        res = conv_act_bn(res, self.conv3, self.bn2)
        return shortcut + res


class ResBlock(nn.Module):
    """Three stacked dilated convs, concat-fuse, residual; optional pool.

    Returns (pooled, pre_pool_skip) when pooling, else the block output —
    matching ResBlock.forward (salsanext_proto.py:113-148).
    """

    def __init__(self, in_filters: int, out_filters: int,
                 dropout_rate: float = 0.2, pooling: bool = True,
                 drop_out: bool = True):
        super().__init__()
        self.pooling = pooling
        self.drop_out = drop_out
        self.conv1 = nn.Conv2d(in_filters, out_filters, 1)
        self.conv2 = _conv3(in_filters, out_filters)
        self.bn1 = _bn(out_filters)
        self.conv3 = _conv3(out_filters, out_filters, dilation=2)
        self.bn2 = _bn(out_filters)
        self.conv4 = _conv2_dil2(out_filters, out_filters)
        self.bn3 = _bn(out_filters)
        self.conv5 = nn.Conv2d(3 * out_filters, out_filters, 1)
        self.bn4 = _bn(out_filters)
        self.dropout = nn.Dropout2d(dropout_rate)

    def forward(self, x: torch.Tensor):
        shortcut = F.leaky_relu(self.conv1(x), LEAKY_SLOPE)
        res1 = conv_act_bn(x, self.conv2, self.bn1)
        res2 = conv_act_bn(res1, self.conv3, self.bn2)
        res3 = conv_act_bn(res2, self.conv4, self.bn3)
        res = conv_act_bn(torch.cat([res1, res2, res3], dim=1), self.conv5,
                          self.bn4)
        res = shortcut + res
        out = self.dropout(res) if self.drop_out else res
        if self.pooling:
            pooled = F.avg_pool2d(out, 3, stride=2, padding=1,
                                  count_include_pad=True)
            return pooled, res
        return out


class UpBlock(nn.Module):
    """PixelShuffle x2 upsample, skip concat, three convs, concat-fuse.

    ``in_filters`` is the channel count of the input before the shuffle;
    the skip carries ``2 * out_filters`` channels.
    """

    def __init__(self, in_filters: int, out_filters: int,
                 dropout_rate: float = 0.2, drop_out: bool = True):
        super().__init__()
        self.drop_out = drop_out
        cin = in_filters // 4 + 2 * out_filters
        self.conv1 = _conv3(cin, out_filters)
        self.bn1 = _bn(out_filters)
        self.conv2 = _conv3(out_filters, out_filters, dilation=2)
        self.bn2 = _bn(out_filters)
        self.conv3 = _conv2_dil2(out_filters, out_filters)
        self.bn3 = _bn(out_filters)
        self.conv4 = nn.Conv2d(3 * out_filters, out_filters, 1)
        self.bn4 = _bn(out_filters)
        self.dropout1 = nn.Dropout2d(dropout_rate)
        self.dropout2 = nn.Dropout2d(dropout_rate)
        self.dropout3 = nn.Dropout2d(dropout_rate)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = pixel_shuffle(x, 2)
        if self.drop_out:
            up = self.dropout1(up)
        up = torch.cat([up, skip], dim=1)
        if self.drop_out:
            up = self.dropout2(up)
        e1 = conv_act_bn(up, self.conv1, self.bn1)
        e2 = conv_act_bn(e1, self.conv2, self.bn2)
        e3 = conv_act_bn(e2, self.conv3, self.bn3)
        out = conv_act_bn(torch.cat([e1, e2, e3], dim=1), self.conv4, self.bn4)
        if self.drop_out:
            out = self.dropout3(out)
        return out


class ProjectionHead(nn.Module):
    """Contrastive embedding head (reference ProjectionV1, projector.py:11-27):
    1x1 conv -> BN -> LeakyReLU -> 1x1 conv, as ``proj.0/1/2/3``. The caller
    runs it in float32 (the embedding feeds cosine similarities where bf16
    hurts)."""

    def __init__(self, in_channels: int, proj_dim: int):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(in_channels, in_channels, 1),
            _bn(in_channels),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(in_channels, proj_dim, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.float())
