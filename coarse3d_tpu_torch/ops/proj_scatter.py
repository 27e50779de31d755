"""Projection scatter-min: kernel K1 (``csrc/proj_scatter.cu``) and its twin.

Replaces the TPU kernel ``ops/pallas/proj_scatter.py:_kernel`` of the JAX
package (driven by ``_scatter_min_pallas``): per image and pixel, the
lexicographic minimum of (depth, point index) over the points that land
there. The kernel is two launches after a memset of its key image: one
64-bit ``atomicMin`` per point on a ``(depth_bits << 32) | index`` key (the
image from the grid, so no thread divides), then one pass over the pixels
that writes whatever the caller asked for from each key.

Two entry points share it:

- :func:`scatter_min` returns what the TPU kernel computes, (min depth,
  winner index);
- :func:`project_scatter` returns what ``range_project_batch`` needs for
  each pixel (``proj_idx``, ``proj_range``, ``proj_mask``, ``proj_points``),
  written by the same pixel pass, so the winner image never goes through
  device memory and a dozen tensor ops.

On a CUDA tensor each launches the hand-written kernel; on a CPU tensor it
runs its plain PyTorch twin (:func:`scatter_min_reference`,
:func:`project_scatter_reference`). The twins compute the same outputs bit
for bit (the kernel does integer decode and copies only), so the card holds
the kernel against them exactly.

What bounds the kernel on an H100 is bytes (see the source note in the .cu
file): at KITTI size the scatter-min moves 19.2 MB of point stream in and
16.8 MB of images out, the fused projection 57.6 MB in and 58.7 MB out.
"""

from __future__ import annotations

import ctypes

import torch

from coarse3d_tpu_torch.ops._build import KernelLibrary, launch_check, stream_of

BIG = 3.0e38  # min-depth of an empty pixel (the JAX package's _BIG)


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.c3d_proj_scatter.argtypes = (
        [p] * 10 + [ctypes.c_int64] * 4 + [ctypes.c_int, p])
    lib.c3d_proj_scatter.restype = ctypes.c_int


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


def _launch(flat: torch.Tensor, depth: torch.Tensor, hw: int, name: str,
            points: torch.Tensor | None, outs: tuple,
            mask_excludes_point0: bool = False) -> None:
    """Check what the kernel takes and launch it. ``outs`` are the data
    pointers (or None) of min_depth, winner, proj_idx, proj_range, proj_mask
    and proj_points. Kept lean: a served batch waits on this host code."""
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if not (flat.is_contiguous() and depth.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous flat and depth")
    b, p = flat.shape
    if p >= 2**31 - 1 or hw >= 2**31 - 1 or b > 65535:
        raise ValueError(f"B={b}, P={p}, hw={hw} do not fit the kernel's "
                         "32-bit indices and grid")
    lib = LIBRARY.load()
    keys = torch.empty(b * hw, dtype=torch.int64, device=flat.device)
    if points is None:
        points_ptr, c = None, 0
    else:
        points_ptr, c = points.data_ptr(), points.shape[2]
    with torch.cuda.device(flat.device):
        err = lib.c3d_proj_scatter(
            flat.data_ptr(), depth.data_ptr(), points_ptr, keys.data_ptr(),
            *outs, b, p, c, hw, int(mask_excludes_point0), stream_of(flat))
    launch_check(err, name)


def scatter_min(flat: torch.Tensor, depth: torch.Tensor, hw: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, P) flat pixel ids + depths -> per-pixel (min depth, winner id).

    Args:
      flat: (B, P) int32 pixel index of each point in its image; points to
        drop (padding) carry a value outside [0, hw).
      depth: (B, P) float32, non-negative and below ``BIG`` (the projection
        clamps it to the sensor's ``max_depth``). A kept point at ``BIG`` or
        more, or NaN, is outside the contract: the kernel would count its
        pixel as hit, the twin as empty.
      hw: pixels per image.

    Returns (B, hw) float32 min-depth (``BIG`` on empty pixels) and (B, hw)
    int32 winner point index within its scan (P on empty pixels); ties in
    depth go to the lowest index.
    """
    _check(flat, depth)
    if flat.device.type == "cpu":
        return scatter_min_reference(flat, depth, hw)
    b = flat.shape[0]
    min_depth = torch.empty((b, hw), dtype=torch.float32, device=flat.device)
    winner = torch.empty((b, hw), dtype=torch.int32, device=flat.device)
    _launch(flat, depth, hw, "proj_scatter_min", None,
            (min_depth.data_ptr(), winner.data_ptr(), None, None, None, None))
    scatter_min.launches += 1
    return min_depth, winner


scatter_min.launches = 0  # kernel launches; chip_smoke.py reads and resets it


def _check_points(flat: torch.Tensor, points: torch.Tensor) -> None:
    if points.dim() != 3 or points.shape[:2] != flat.shape:
        raise ValueError(f"points must be (B, P, C) over flat "
                         f"{tuple(flat.shape)}, got {tuple(points.shape)}")
    if points.device != flat.device:
        raise ValueError(f"flat on {flat.device}, points on {points.device}")


def project_scatter(flat: torch.Tensor, depth: torch.Tensor,
                    points: torch.Tensor, hw: int,
                    mask_excludes_point0: bool = False
                    ) -> dict[str, torch.Tensor]:
    """The scatter-min and what the projection makes of it, in one kernel.

    Args:
      flat, depth, hw: as :func:`scatter_min`, the bound on depth included.
      points: (B, P, C) float32 rows to gather for each pixel's winner.
      mask_excludes_point0: ``proj_mask = proj_idx > 0`` instead of ``>= 0``.

    Returns flat images: proj_idx (B, hw) int32 (-1 on empty pixels),
    proj_range (B, hw) float32 (-1 fill), proj_mask (B, hw) int32 and
    proj_points (B, hw, C) float32 (-1 fill).
    """
    _check(flat, depth)
    _check_points(flat, points)
    if flat.device.type == "cpu":
        return project_scatter_reference(flat, depth, points, hw,
                                         mask_excludes_point0)
    if points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError("project_scatter kernel needs contiguous float32 "
                         f"points, got {points.dtype}")
    b, _, c = points.shape
    dev = flat.device
    # the three 4-byte images share one allocation
    planes = torch.empty((3, b, hw), dtype=torch.int32, device=dev)
    proj_points = torch.empty((b, hw, c), dtype=torch.float32, device=dev)
    out = {"proj_idx": planes[0], "proj_range": planes[1].view(torch.float32),
           "proj_mask": planes[2], "proj_points": proj_points}
    _launch(flat, depth, hw, "project_scatter", points,
            (None, None, out["proj_idx"].data_ptr(),
             out["proj_range"].data_ptr(), out["proj_mask"].data_ptr(),
             proj_points.data_ptr()), mask_excludes_point0)
    project_scatter.launches += 1
    return out


project_scatter.launches = 0  # as scatter_min.launches, for the fused entry


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


def project_from_winner(min_depth: torch.Tensor, win_local: torch.Tensor,
                        points: torch.Tensor,
                        mask_excludes_point0: bool = False
                        ) -> dict[str, torch.Tensor]:
    """What the projection makes of the scatter-min's two images, as plain
    tensor ops: the fills, the winner-row gather and the mask."""
    b, p, c = points.shape
    hw = win_local.shape[1]
    hit = win_local < p
    proj_idx = torch.where(hit, win_local, -1)
    proj_range = torch.where(hit, min_depth, -1.0)
    base = torch.arange(b, device=points.device, dtype=torch.int64)[:, None] * p
    rows = points.reshape(b * p, c)[
        (base + win_local.clamp(0, p - 1).long()).reshape(-1)]
    proj_points = torch.where(hit.reshape(-1, 1), rows, -1.0).view(b, hw, c)

    if mask_excludes_point0:
        proj_mask = (proj_idx > 0).to(torch.int32)
    else:
        proj_mask = (proj_idx >= 0).to(torch.int32)
    return {"proj_idx": proj_idx, "proj_range": proj_range,
            "proj_mask": proj_mask, "proj_points": proj_points}


def project_scatter_reference(flat: torch.Tensor, depth: torch.Tensor,
                              points: torch.Tensor, hw: int,
                              mask_excludes_point0: bool = False
                              ) -> dict[str, torch.Tensor]:
    """Plain PyTorch twin of :func:`project_scatter`: the scatter-min twin,
    then :func:`project_from_winner`."""
    _check(flat, depth)
    _check_points(flat, points)
    min_depth, win_local = scatter_min_reference(flat, depth, hw)
    return project_from_winner(min_depth, win_local, points,
                               mask_excludes_point0)
