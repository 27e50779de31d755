"""One SqueezeSegV3 SAC block's attention and 1x1 mix: kernel K4
(``csrc/sac_fused.cu``), its weight fold and its plain twin.

K4 replaces no TPU kernel: the JAX package's SAC block
(``models/squeezesegv3.py:SACBlock``) is plain XLA. It serves the block's
eval forward up to its 3x3 conv,

    y = ReLU(BN_c(Conv1x1(unfold3x3(feature)
                          * sigmoid(BN_9c(Conv7x7(xyz))))))

in one pass that writes only the c-channel output: the unfused modules
write and read seven maps of 9c channels (604 MB each at B=8, 64x2048,
bf16).

:func:`fold_sac` folds both eval-mode BatchNorms into their convs in
float32 (float64 for a float64 block), permutes the 9c dimension to
tap-major (index ``tap * c + channel``; the unfold's is ``channel * 9 +
tap``) on the attention conv's outputs and the 1x1 conv's inputs alike,
which leaves the product unchanged, and packs the result in the order the
kernel streams it (:func:`pack_steps`). :func:`sac_fused` launches K4 on
CUDA bf16 tensors; on CPU tensors it runs :func:`sac_fused_reference`,
the same arithmetic from the same packed weights in plain PyTorch: float32
sums of bf16 operands, the sigmoid and the product in float32, the product
rounded to the features' dtype, as the kernel does (for float32 and
float64 inputs nothing is rounded).

What bounds K4 on an H100 is bf16 tensor-core operations, 2 * 9c * (147 +
c) a pixel (the source note in the .cu file has the design).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from coarse3d_tpu_torch.ops._build import KernelLibrary, launch_check, stream_of

CHANNELS = (32, 64, 128, 256)   # the SAC widths K4 is built for
STEP = 32                       # channels of one step (csrc: kStepC)
TAPS = 147                      # 3 xyz channels x 7 x 7
PATCH = 160                     # the taps padded to ten k16 slices (csrc: kK1)


class SacWeights(NamedTuple):
    """A SAC block's folded, tap-major weights in the kernel's step order:
    ``steps`` (9c/32, 32*160 + c*32) of W1' then W2' tiles, each as 8x8
    core matrices (:func:`pack_steps`), ``b1`` (9c/32, 32), ``b2`` (c,)."""
    steps: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i32 = ctypes.c_int32
    lib.c3d_sac_fused.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, p]
    lib.c3d_sac_fused.restype = ctypes.c_int


LIBRARY = KernelLibrary("sac_fused", _bind)


def _fold_bn(weight: torch.Tensor, bias: torch.Tensor, bn, dtype
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """conv (out, ...) then eval BatchNorm -> (out, k) weight and bias."""
    scale = bn.weight.to(dtype) * torch.rsqrt(bn.running_var.to(dtype)
                                              + bn.eps)
    w = weight.to(dtype).reshape(weight.shape[0], -1) * scale[:, None]
    b = (bias.to(dtype) - bn.running_mean.to(dtype)) * scale + bn.bias.to(
        dtype)
    return w, b


def tap_major(c: int, device=None) -> torch.Tensor:
    """perm with ``x[..., perm]`` tap-major for a channel-major (c*9 + tap)
    9c axis: ``perm[tap * c + ch] = ch * 9 + tap``."""
    j = torch.arange(9 * c, device=device)
    return (j % c) * 9 + j // c


def pack_steps(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor, dtype: torch.dtype) -> SacWeights:
    """Tap-major folded weights -> the kernel's step order.

    w1 (9c, 147) and b1 (9c,) index their rows ``tap * c + ch``; w2 (c, 9c)
    its columns likewise. Step s = chunk * 9 + tap, for the 32-channel
    chunk of the features, holds W1' rows [tap*c + chunk*32, +32) padded to
    160 taps, then the same 32 columns of W2' for every output channel.
    Each tile is stored as the kernel's wgmma reads it from shared memory:
    8x8 core matrices (8 rows of 8 contiguous k), row groups outer, k
    groups inner. ``steps`` is cast to ``dtype``; the biases stay in the
    fold's dtype."""
    c = w2.shape[0]
    if c not in CHANNELS or w1.shape != (9 * c, TAPS) or w2.shape != (
            c, 9 * c):
        raise ValueError(f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} "
                         f"are not a SAC block's of width in {CHANNELS}")
    nc = c // STEP
    w1p = F.pad(w1, (0, PATCH - TAPS))
    # (tap, chunk, j, k) -> (chunk, tap, j, k)
    w1s = w1p.reshape(9, nc, STEP, PATCH).transpose(0, 1)
    w2s = w2.reshape(c, 9, nc, STEP).permute(2, 1, 0, 3)
    b1s = b1.reshape(9, nc, STEP).transpose(0, 1)
    n = 9 * nc
    steps = torch.cat([_cores(w1s.reshape(n, STEP, PATCH)),
                       _cores(w2s.reshape(n, c, STEP))], dim=1)
    return SacWeights(steps.to(dtype).contiguous(), b1s.reshape(n, STEP)
                      .contiguous(), b2.contiguous())


def _cores(tiles: torch.Tensor) -> torch.Tensor:
    """(n, rows, k) tiles -> (n, rows * k) in 8x8 core matrices: index
    ((row // 8) * (k // 8) + k // 8) * 64 + (row % 8) * 8 + k % 8."""
    n, r, k = tiles.shape
    return tiles.reshape(n, r // 8, 8, k // 8, 8).permute(0, 1, 3, 2, 4
                                                          ).reshape(n, r * k)


def _uncores(flat: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """The inverse of :func:`_cores`: (n, r * k) -> (n, r, k)."""
    n = flat.shape[0]
    return flat.reshape(n, r // 8, k // 8, 8, 8).permute(0, 1, 3, 2, 4
                                                         ).reshape(n, r, k)


def unpack_steps(weights: SacWeights) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor]:
    """The inverse of :func:`pack_steps`: (w1 (9c, 147), b1 (9c,), w2 (c,
    9c), b2 (c,)), tap-major, in the packed dtypes."""
    c = weights.b2.shape[0]
    nc = c // STEP
    w1s, w2s = weights.steps.split([STEP * PATCH, c * STEP], dim=1)
    w1s, w2s = _uncores(w1s, STEP, PATCH), _uncores(w2s, c, STEP)
    w1 = w1s.reshape(nc, 9, STEP, PATCH).transpose(0, 1).reshape(
        9 * c, PATCH)[:, :TAPS]
    w2 = w2s.reshape(nc, 9, c, STEP).permute(2, 1, 0, 3).reshape(c, 9 * c)
    b1 = weights.b1.reshape(nc, 9, STEP).transpose(0, 1).reshape(-1)
    return w1, b1, w2, weights.b2


def fold_sac(attention_conv, attention_bn, mix_conv, mix_bn,
             dtype: torch.dtype) -> SacWeights:
    """Fold a SAC block's two eval BatchNorms into its 7x7 attention conv
    (3 -> 9c) and its 1x1 mix (9c -> c), permute to tap-major and pack.
    The fold runs in float64 for float64 parameters, else in float32; the
    packed weights are cast to ``dtype``, the biases keep the fold's."""
    fold = (torch.float64 if attention_conv.weight.dtype == torch.float64
            else torch.float32)
    w1, b1 = _fold_bn(attention_conv.weight, attention_conv.bias,
                      attention_bn, fold)
    w2, b2 = _fold_bn(mix_conv.weight, mix_conv.bias, mix_bn, fold)
    perm = tap_major(w2.shape[0], w1.device)
    return pack_steps(w1[perm], b1[perm], w2[:, perm], b2, dtype)


def _check(xyz: torch.Tensor, feature: torch.Tensor,
           weights: SacWeights) -> None:
    if xyz.dim() != 4 or feature.dim() != 4:
        raise ValueError(f"xyz and feature must be (B, 3, H, W) and (B, C, "
                         f"H, W), got {tuple(xyz.shape)}, "
                         f"{tuple(feature.shape)}")
    b, c, h, w = feature.shape
    if xyz.shape != (b, 3, h, w):
        raise ValueError(f"xyz {tuple(xyz.shape)} != {(b, 3, h, w)}")
    if c not in CHANNELS:
        raise ValueError(f"K4 takes C in {CHANNELS}, got {c}")
    n = 9 * c // STEP
    if (weights.steps.shape != (n, STEP * PATCH + c * STEP)
            or weights.b1.shape != (n, STEP) or weights.b2.shape != (c,)):
        raise ValueError(f"weights are not a width-{c} block's packed steps")
    if not xyz.is_floating_point() or xyz.dtype != feature.dtype:
        raise TypeError(f"xyz and feature must share a float dtype, got "
                        f"{xyz.dtype} and {feature.dtype}")
    if weights.steps.dtype != feature.dtype:
        raise TypeError(f"weights packed as {weights.steps.dtype} for "
                        f"{feature.dtype} features")
    if len({t.device for t in (xyz, feature, *weights)}) != 1:
        raise ValueError("xyz, feature and weights on different devices")
    if not all(t.is_contiguous() for t in (xyz, feature, *weights)):
        raise ValueError("sac_fused needs contiguous inputs")


def sac_fused(xyz: torch.Tensor, feature: torch.Tensor,
              weights: SacWeights) -> torch.Tensor:
    """A SAC block's eval forward up to its 3x3 conv.

    Args:
      xyz: (B, 3, H, W), the block's xyz image, in ``feature``'s dtype.
      feature: (B, C, H, W) block input, C in :data:`CHANNELS`.
      weights: :func:`fold_sac` of the block, packed as ``feature``'s dtype.

    Returns ReLU(BN(1x1 conv)) of the attention product, (B, C, H, W) in
    ``feature``'s dtype. CUDA tensors must be bf16 and launch K4; CPU
    tensors run :func:`sac_fused_reference`.
    """
    _check(xyz, feature, weights)
    if feature.device.type == "cpu":
        return sac_fused_reference(xyz, feature, weights)
    if feature.device.type != "cuda":
        raise ValueError(f"unsupported device {feature.device}")
    if feature.dtype != torch.bfloat16:
        raise TypeError(f"K4 takes bf16, got {feature.dtype}")
    if weights.b1.dtype != torch.float32 or weights.b2.dtype != torch.float32:
        raise TypeError("K4 takes float32 biases")
    if any(t.data_ptr() % 16 for t in (xyz, feature, *weights)):
        raise ValueError("K4 reads its inputs in 16-byte vectors: their "
                         "storage must be 16-byte aligned")
    out = torch.empty_like(feature)
    b, c, h, w = feature.shape
    with torch.cuda.device(feature.device):
        err = LIBRARY.load().c3d_sac_fused(
            xyz.data_ptr(), feature.data_ptr(), weights.steps.data_ptr(),
            weights.b1.data_ptr(), weights.b2.data_ptr(), out.data_ptr(),
            b, c, h, w, stream_of(feature))
    launch_check(err, "sac_fused")
    sac_fused.launches += 1
    return out


sac_fused.launches = 0  # kernel launches; chip_smoke.py reads and resets it


def sac_fused_reference(xyz: torch.Tensor, feature: torch.Tensor,
                        weights: SacWeights) -> torch.Tensor:
    """Plain PyTorch twin of :func:`sac_fused` from the same packed
    weights: the 7x7 patches and the 3x3 unfold, tap-major, then the two
    products as the kernel sums them (float32, or float64 for float64
    inputs), the product with the features rounded to their dtype."""
    _check(xyz, feature, weights)
    b, c, h, w = feature.shape
    acc = torch.float64 if feature.dtype == torch.float64 else torch.float32
    w1, b1, w2, b2 = (t.to(acc) for t in unpack_steps(weights))
    with torch.autocast(feature.device.type, enabled=False):
        patches = F.unfold(xyz.to(acc), 7, padding=3)           # (B, 147, HW)
        att = torch.sigmoid(torch.matmul(w1, patches) + b1[:, None])
        unf = F.unfold(feature.to(acc), 3, padding=1)           # (B, 9C, HW)
        unf = unf.view(b, c, 9, h * w).transpose(1, 2).reshape(b, 9 * c,
                                                               h * w)
        prod = (att * unf).to(feature.dtype).to(acc)
        y = torch.relu(torch.matmul(w2, prod) + b2[:, None])
    return y.view(b, c, h, w).to(feature.dtype)
