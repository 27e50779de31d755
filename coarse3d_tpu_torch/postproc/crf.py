"""Locally-connected Gaussian-XYZ CRF refinement of range-image softmax.

Port of the JAX package's ``postproc/crf.py``. Behavioral model: the
reference's postproc/crf.py:11-129 (RangeNet++ style, shipped unused and
unexported): per iteration, message passing = windowed sum of class
probabilities weighted by exp(-||dxyz||^2 / 2 sigma^2) to the window center,
a learnable 1x1 compatibility conv initialized to xyz_coef * (1 - I),
residual add, softmax renorm.

The windowed message pass is a sum over the window's static shifted slices
of the zero-padded map (the JAX package contracts a stacked (B, H, W, S, C)
window tensor in one einsum; summing tap by tap never holds it). Plain
tensor ops throughout, so ``compat_kernel`` gets its gradient by autograd
(``tools/train_crf.py`` fits it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifted_windows(x: torch.Tensor, wh: int, ww: int) -> list[torch.Tensor]:
    """(B, H, W, C) -> the S = wh * ww zero-padded window views, each
    (B, H, W, C), row-major over the window."""
    ph, pw = wh // 2, ww // 2
    pads = F.pad(x, (0, 0, pw, pw, ph, ph))
    h, w = x.shape[1], x.shape[2]
    return [pads[:, dy:dy + h, dx:dx + w, :]
            for dy in range(wh) for dx in range(ww)]


def init_compat_kernel(n_classes: int, xyz_coef: float) -> torch.Tensor:
    """(C, C) compatibility matrix init: xyz_coef * (1 - I) (crf.py:96-103)."""
    return xyz_coef * (1.0 - torch.eye(n_classes, dtype=torch.float32))


def crf_refine(
    xyz: torch.Tensor,
    softmax: torch.Tensor,
    mask: torch.Tensor,
    compat_kernel: torch.Tensor,
    *,
    iterations: int = 3,
    lcn_h: int = 3,
    lcn_w: int = 5,
    xyz_sigma: float = 0.7,
) -> torch.Tensor:
    """Refine (B, H, W, C) softmax with locally-connected xyz message passing.

    Args:
      xyz: (B, H, W, 3) projected coordinates.
      softmax: (B, H, W, C) class probabilities.
      mask: (B, H, W) valid-pixel mask.
      compat_kernel: (C, C) compatibility matrix (see init_compat_kernel; a
        trainable parameter in the reference).
    """
    gauss = [torch.exp(-((win - xyz) ** 2).sum(-1, keepdim=True)
                       / (2.0 * xyz_sigma ** 2))
             for win in _shifted_windows(xyz, lcn_h, lcn_w)]    # S x (B,H,W,1)
    m = mask[..., None].to(softmax.dtype)
    compat_t = compat_kernel.to(softmax.dtype).T
    for _ in range(iterations):
        # the mask silences the NEIGHBOURS' probabilities only; the residual
        # below adds the unmasked map
        windows = _shifted_windows(softmax * m, lcn_h, lcn_w)
        message = sum(g * win for g, win in zip(gauss, windows))
        softmax = torch.softmax(message @ compat_t + softmax, dim=-1)
    return softmax
