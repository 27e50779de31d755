"""Projection scatter-min: kernel K1 (``csrc/proj_scatter.cu``) and its twin.

Replaces the TPU kernel ``ops/pallas/proj_scatter.py:_kernel`` of the JAX
package (driven by ``_scatter_min_pallas``): per image and pixel, the
lexicographic minimum of (depth, point index) over the points that land
there. On a CUDA tensor :func:`scatter_min` launches the hand-written kernel
(one 64-bit ``atomicMin`` per point on a ``(depth_bits << 32) | index`` key,
then a decode pass); on a CPU tensor it runs :func:`scatter_min_reference`,
the plain PyTorch twin. The twin computes the same two outputs bit for bit,
so the card holds the kernel against it exactly.

What bounds the kernel on an H100 is bytes (see the source note in the .cu
file): at KITTI size it moves 19.2 MB of point stream in and 16.8 MB of
images out.
"""

from __future__ import annotations

import ctypes

import torch

from coarse3d_tpu_torch.ops._build import KernelLibrary, launch_check, stream_of

BIG = 3.0e38  # min-depth of an empty pixel (the JAX package's _BIG)


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.c3d_proj_scatter_min.argtypes = [
        p, p, p, p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, p]
    lib.c3d_proj_scatter_min.restype = ctypes.c_int


LIBRARY = KernelLibrary("proj_scatter", _bind)


def _check(flat: torch.Tensor, depth: torch.Tensor) -> None:
    if flat.dim() != 2 or flat.shape != depth.shape:
        raise ValueError(f"flat and depth must both be (B, P), got "
                         f"{tuple(flat.shape)} and {tuple(depth.shape)}")
    if flat.dtype != torch.int32 or depth.dtype != torch.float32:
        raise TypeError(f"flat must be int32 and depth float32, got "
                        f"{flat.dtype} and {depth.dtype}")
    if flat.device != depth.device:
        raise ValueError(f"flat on {flat.device}, depth on {depth.device}")


def scatter_min(flat: torch.Tensor, depth: torch.Tensor, hw: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, P) flat pixel ids + depths -> per-pixel (min depth, winner id).

    Args:
      flat: (B, P) int32 pixel index of each point in its image; points to
        drop (padding) carry a value outside [0, hw).
      depth: (B, P) float32, non-negative.
      hw: pixels per image.

    Returns (B, hw) float32 min-depth (``BIG`` on empty pixels) and (B, hw)
    int32 winner point index within its scan (P on empty pixels); ties in
    depth go to the lowest index.
    """
    _check(flat, depth)
    if flat.device.type == "cpu":
        return scatter_min_reference(flat, depth, hw)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if not (flat.is_contiguous() and depth.is_contiguous()):
        raise ValueError("scatter_min kernel needs contiguous flat and depth")
    b, p = flat.shape
    if p >= 2**31 - 1:
        raise ValueError(f"P={p} does not fit the kernel's 32-bit index")
    lib = LIBRARY.load()
    keys = torch.empty(b * hw, dtype=torch.int64, device=flat.device)
    min_depth = torch.empty((b, hw), dtype=torch.float32, device=flat.device)
    winner = torch.empty((b, hw), dtype=torch.int32, device=flat.device)
    with torch.cuda.device(flat.device):
        err = lib.c3d_proj_scatter_min(
            flat.data_ptr(), depth.data_ptr(), keys.data_ptr(),
            min_depth.data_ptr(), winner.data_ptr(), b, p, hw,
            stream_of(flat))
    launch_check(err, "proj_scatter_min")
    scatter_min.launches += 1
    return min_depth, winner


scatter_min.launches = 0  # kernel launches; chip_smoke.py reads and resets it


def scatter_min_reference(flat: torch.Tensor, depth: torch.Tensor, hw: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`scatter_min` (the JAX package's two XLA
    passes): ``scatter_reduce("amin")`` on depth, an equality test against
    the winning depth, then a second ``amin`` on the candidate index."""
    _check(flat, depth)
    b, p = flat.shape
    dev = flat.device
    keep = (flat >= 0) & (flat < hw)
    base = torch.arange(b, device=dev, dtype=torch.int64)[:, None] * hw
    # dropped points land in one spare slot past the last image
    idx = torch.where(keep, base + flat.long(), b * hw).reshape(-1)
    min_depth = torch.full((b * hw + 1,), BIG, dtype=torch.float32, device=dev)
    min_depth.scatter_reduce_(0, idx, depth.reshape(-1), "amin")
    is_winner = keep.reshape(-1) & (depth.reshape(-1) == min_depth[idx])
    ids = torch.arange(p, device=dev, dtype=torch.int32).repeat(b)
    cand = torch.where(is_winner, ids, p)
    winner = torch.full((b * hw + 1,), p, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, idx, cand, "amin")
    return min_depth[:-1].view(b, hw), winner[:-1].view(b, hw)
