"""Shared conv building blocks (PyTorch, NCHW).

Port of the JAX package's ``models/blocks.py``: SalsaNext's blocks
(``ConvActBN``, ``ResContextBlock``, ``ResBlock``, ``UpBlock``,
``ProjectionHead``, ``pixel_shuffle``) and the extras the reference defines
beside them (``SEBlock``, ``ClassifierHead``, ``ConvUpSample``,
``ProjectionHeadV2`` / ``V3`` / ``V4``, ``CSAttention``). Behavioral model:
the SalsaNext block zoo of the reference's salsanext_proto.py —
ResContextBlock (:38-65), ResBlock
(:68-148), UpBlock (:151-212) — with the reference's attribute names
(``conv1``, ``bn1``, ...), so a reference state dict loads with
``load_state_dict(strict=True)``.

Flax -> PyTorch: BatchNorm momentum 0.9 (Flax, weight of the old value) is
PyTorch momentum 0.1, eps 1e-5, and in training the running variance
takes the biased batch variance, as Flax's does (:class:`BatchNorm2d`);
"SAME" 3x3 with dilation 2 is padding 2; the 2x2 kernel with dilation 2
takes an explicit pad of 1 (an effective 3x3 that keeps the size); dropout
drops whole channels (:class:`Dropout2d`, the JAX
``broadcast_dims=(1, 2)``), its mask drawn from the generator the caller
passes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from coarse3d_tpu_torch.ops.resize import resize_bilinear
from coarse3d_tpu_torch.parallel.mesh import all_gather

LEAKY_SLOPE = 0.01


def pixel_shuffle(x: torch.Tensor, r: int = 2, rw: int | None = None
                  ) -> torch.Tensor:
    """(B, C*r*rw, H, W) -> (B, C, H*r, W*rw), torch PixelShuffle channel
    order (the JAX ``pixel_shuffle`` rearranges to the same order in NHWC).
    ``rw`` defaults to ``r`` (square shuffle); a rectangular (r, rw) serves
    the width-only s2d stem (``models/salsanext.py``)."""
    rw = r if rw is None else rw
    if rw == r:
        return F.pixel_shuffle(x, r)
    b, c, h, w = x.shape
    x = x.view(b, c // (r * rw), r, rw, h, w)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, c // (r * rw), h * r, w * rw)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward folds the BIASED batch
    variance into ``running_var``, as Flax's ``nn.BatchNorm`` folds it into
    ``batch_stats.var`` (PyTorch folds the unbiased one, n / (n - 1) times
    larger, so the two would drift apart by 1/(n - 1) of the variance per
    step). Parameter and buffer names are those of ``nn.BatchNorm2d``.

    The training statistics are those of the global batch when ``mesh`` is
    set (by ``parallel/mesh.py:replicate_to_mesh``), as under the JAX
    package's sharded step, and of the local batch otherwise. Both come
    from one computation (:class:`_BatchNormTrain`): every image's
    per-channel mean and variance, gathered over the ranks in rank order
    (no collective at world size 1), then combined. The per-image moments
    do not depend on how the batch is split, so a step gives the same
    statistics on any number of ranks, and a group of one is the plain step.
    ``nn.SyncBatchNorm`` is not used: it folds the unbiased variance.
    """
    mesh = None     # parallel.mesh.Mesh: set to synchronise across ranks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             self.eps, self.mesh)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


class _BatchNormTrain(torch.autograd.Function):
    """Training batch norm of an (N, C, H, W) tensor over the global batch:
    returns the output, and the batch mean and biased variance (float32,
    not differentiable) for the running statistics.

    On a card it is built from the library's fused batch-norm primitives
    (those ``nn.SyncBatchNorm`` is built from): ``batch_norm_stats`` on the
    (1, N*C, H*W) view gives each image's moments, which are all-gathered
    and combined by ``batch_norm_gather_stats_with_counts``;
    ``batch_norm_elemt`` normalises; the backward is
    ``batch_norm_backward_reduce``, an all-reduce of the two channel sums,
    and ``batch_norm_backward_elemt``. The primitives have no CPU kernels:
    there the same steps run as tensor expressions, the moments in float64.
    The weight and bias gradients are the rank's own; the training step
    sums them over ranks with every other gradient.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        x = x.contiguous()
        b, c = x.shape[:2]
        world = 1 if mesh is None else mesh.world
        if x.is_cuda:
            per_image = torch.stack(torch.batch_norm_stats(
                x.view(1, b * c, -1), eps)).view(2, b, c).transpose(0, 1)
            moments = all_gather(per_image.contiguous(), mesh)
            counts = torch.full((b * world,), x[0, 0].numel(),
                                dtype=moments.dtype, device=x.device)
            # the first argument only sets the arithmetic's type: float32
            # (with no running statistics a bf16 x would make it bf16)
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                moments, moments[:, 0], moments[:, 1], None, None, 0.0, eps,
                counts)
            var = torch.clamp_min(invstd.pow(-2) - eps, 0.0)
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            xd = x.double().view(b, c, -1)
            mean_i = xd.mean(-1)
            var_i = (xd - mean_i[..., None]).square().mean(-1)
            moments = all_gather(torch.stack([mean_i, var_i], 1), mesh)
            mean64 = moments[:, 0].mean(0)      # every image has H*W pixels
            var64 = (moments[:, 1] + (moments[:, 0] - mean64).square()
                     ).mean(0)
            mean, var = mean64.float(), var64.float()
            invstd = torch.rsqrt(var64 + eps).float()
            scale = invstd * weight
            y = (x.float() * scale[:, None, None]
                 + (bias - mean * scale)[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh, ctx.n = mesh, b * world * x[0, 0].numel()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad, _grad_mean, _grad_var):
        x, weight, mean, invstd = ctx.saved_tensors
        grad = grad.contiguous()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, grad_w, grad_b = (
                torch.batch_norm_backward_reduce(grad, x, mean, invstd,
                                                 weight, True, True, True))
        else:
            g, xmu = grad.float(), x.float() - mean[:, None, None]
            sum_dy = g.sum(dim=(0, 2, 3))
            sum_dy_xmu = (g * xmu).sum(dim=(0, 2, 3))
            grad_w, grad_b = sum_dy_xmu * invstd, sum_dy
        if ctx.mesh is not None and ctx.mesh.world > 1:
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums)
            sum_dy, sum_dy_xmu = sums.chunk(2)
        if x.is_cuda:
            count = torch.full((1,), ctx.n, dtype=torch.int32,
                               device=x.device)
            grad_x = torch.batch_norm_backward_elemt(
                grad, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count)
        else:
            grad_x = ((g - sum_dy[:, None, None] / ctx.n
                       - xmu * (invstd.square() * sum_dy_xmu / ctx.n
                                )[:, None, None])
                      * (invstd * weight)[:, None, None]).to(x.dtype)
        return grad_x, grad_w, grad_b, None, None


class Dropout2d(nn.Module):
    """Channel dropout whose mask comes from an explicit ``torch.Generator``.

    In training, each (sample, channel) plane is kept with probability
    1 - p and scaled by 1/(1 - p), as ``nn.Dropout2d`` does (and the JAX
    ``nn.Dropout(broadcast_dims=(1, 2))``); in eval it is the identity.
    ``nn.Dropout2d`` draws from torch's global generator, so a run would
    not repeat from its seed: here the caller passes the generator (the
    training step passes ``state.generator``), and a training forward with
    p > 0 and no generator raises. With ``mesh`` set, the ranks' generators
    are alike: each draws the masks of the global batch and keeps its
    stripe, so the ranks together drop what one process would.
    """
    mesh = None     # parallel.mesh.Mesh: draw the global batch's masks

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate {p} outside [0, 1)")
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout2d in training needs an explicit "
                             "generator (the step passes state.generator)")
        b = x.shape[0]
        world = self.mesh.world if self.mesh is not None else 1
        # across ranks every generator is the same: each draws the global
        # batch's masks and keeps its own stripe
        u = torch.rand((b * world, x.shape[1], 1, 1), generator=generator,
                       device=generator.device).to(x.device)
        if world > 1:
            u = u[self.mesh.rank * b:(self.mesh.rank + 1) * b]
        scale = (u >= self.p).to(torch.float32) / (1.0 - self.p)
        return x * scale.to(x.dtype)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def batch_norm(features: int, momentum: float = 0.1) -> BatchNorm2d:
    """``momentum`` is PyTorch's (weight of the new value): 1 - Flax's."""
    return BatchNorm2d(features, eps=1e-5, momentum=momentum)


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
        self.bn1 = batch_norm(out_filters)
        self.conv3 = _conv3(out_filters, out_filters, dilation=2)
        self.bn2 = batch_norm(out_filters)

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
        self.bn1 = batch_norm(out_filters)
        self.conv3 = _conv3(out_filters, out_filters, dilation=2)
        self.bn2 = batch_norm(out_filters)
        self.conv4 = _conv2_dil2(out_filters, out_filters)
        self.bn3 = batch_norm(out_filters)
        self.conv5 = nn.Conv2d(3 * out_filters, out_filters, 1)
        self.bn4 = batch_norm(out_filters)
        self.dropout = Dropout2d(dropout_rate)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        shortcut = F.leaky_relu(self.conv1(x), LEAKY_SLOPE)
        res1 = conv_act_bn(x, self.conv2, self.bn1)
        res2 = conv_act_bn(res1, self.conv3, self.bn2)
        res3 = conv_act_bn(res2, self.conv4, self.bn3)
        res = conv_act_bn(torch.cat([res1, res2, res3], dim=1), self.conv5,
                          self.bn4)
        res = shortcut + res
        out = self.dropout(res, generator) if self.drop_out else res
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
        self.bn1 = batch_norm(out_filters)
        self.conv2 = _conv3(out_filters, out_filters, dilation=2)
        self.bn2 = batch_norm(out_filters)
        self.conv3 = _conv2_dil2(out_filters, out_filters)
        self.bn3 = batch_norm(out_filters)
        self.conv4 = nn.Conv2d(3 * out_filters, out_filters, 1)
        self.bn4 = batch_norm(out_filters)
        self.dropout1 = Dropout2d(dropout_rate)
        self.dropout2 = Dropout2d(dropout_rate)
        self.dropout3 = Dropout2d(dropout_rate)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        up = pixel_shuffle(x, 2)
        if self.drop_out:
            up = self.dropout1(up, generator)
        up = torch.cat([up, skip], dim=1)
        if self.drop_out:
            up = self.dropout2(up, generator)
        e1 = conv_act_bn(up, self.conv1, self.bn1)
        e2 = conv_act_bn(e1, self.conv2, self.bn2)
        e3 = conv_act_bn(e2, self.conv3, self.bn3)
        out = conv_act_bn(torch.cat([e1, e2, e3], dim=1), self.conv4, self.bn4)
        if self.drop_out:
            out = self.dropout3(out, generator)
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
            batch_norm(in_channels),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(in_channels, proj_dim, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.float())


class SEBlock(nn.Module):
    """Squeeze-and-excitation (reference salsanext_proto.py:234-250; defined
    but unused by the shipped models)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


class ClassifierHead(nn.Module):
    """Global-pool + linear classifier for ImageNet encoder pretraining
    (reference FC, salsanext_proto.py:216-231), in float32."""

    def __init__(self, in_channels: int, n_outputs: int = 1000):
        super().__init__()
        self.fc = nn.Linear(in_channels, n_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.float().mean(dim=(2, 3)))


class ConvUpSample(nn.Module):
    """Bilinear-upsample + conv deconv substitute (reference
    layers/modules.py:5-28; unused by the shipped models)."""

    def __init__(self, in_channels: int, features: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = _conv3(in_channels, features)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x, x.shape[2] * self.scale,
                            x.shape[3] * self.scale)
        return conv_act_bn(x, self.conv, self.bn)


class _ProjectionTwoConvs(nn.Module):
    """1x1 conv -> activation -> 1x1 conv in float32, as ``proj.0/1/2``."""

    def __init__(self, in_channels: int, proj_dim: int, act: nn.Module):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(in_channels, in_channels, 1), act,
            nn.Conv2d(in_channels, proj_dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.float())


class ProjectionHeadV2(_ProjectionTwoConvs):
    """Reference ProjectionV2 (projector.py:31-44, never instantiated
    there): 1x1 conv -> ReLU -> 1x1 conv."""

    def __init__(self, in_channels: int, proj_dim: int):
        super().__init__(in_channels, proj_dim, nn.ReLU())


class ProjectionHeadV3(_ProjectionTwoConvs):
    """Reference ProjectionV3 (projector.py:48-60): V2 with LeakyReLU."""

    def __init__(self, in_channels: int, proj_dim: int):
        super().__init__(in_channels, proj_dim, nn.LeakyReLU(LEAKY_SLOPE))


class ProjectionHeadV4(nn.Module):
    """Reference ProjectionV4 (projector.py:64-84): one 1x1 conv, then a
    SCALAR global l2 norm: ``torch.norm(x, p=2)`` with no dim reduces over
    everything, so the module returns a single number, as the JAX one
    does."""

    def __init__(self, in_channels: int, proj_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, proj_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.sum(torch.square(self.proj(x.float()))))


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad H and W as XLA's "SAME" does: out = ceil(in / stride), the
    odd pad cell on the high side (at 3x3 stride 2 on an even size: (0, 1),
    where PyTorch's ``padding=1`` gives (1, 1))."""
    pads = []
    for size in (x.shape[3], x.shape[2]):           # F.pad: last dim first
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class CSAttention(nn.Module):
    """Channel-wise spatial attention (reference layers/modules.py:30-56,
    unused by the shipped models): a 3x3-conv-ReLU-3x3-conv value branch
    gated elementwise by a parallel sigmoid attention branch. The strided
    convs pad as the JAX ones do ("SAME")."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 scale: float = 1.0):
        super().__init__()
        mid = int(in_channels * scale)
        self.stride = stride

        def branch():
            return nn.ModuleList([
                nn.Conv2d(in_channels, mid, 3, stride=stride),
                nn.Conv2d(mid, out_channels, 3, padding=1)])

        self.value = branch()
        self.attention = branch()

    def _branch(self, convs, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(convs[0](_same_pad(x, 3, self.stride)))
        return convs[1](h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.relu(self._branch(self.value, x))
                * torch.sigmoid(self._branch(self.attention, x)))
