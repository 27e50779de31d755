"""KNN vote: kernel K2 (``csrc/knn_vote.cu``) and its plain twin.

Replaces the TPU kernel ``ops/pallas/knn_vote.py:_kernel`` of the JAX
package (wrapped by ``knn_vote_pallas``): per point, over its S x S window of
the label-packed range image, centre <- own range, dist = |Δr|·(1-gauss) + 1,
k rounds of min-extraction (labels in the 5 low mantissa bits), dist-1 >
cutoff -> invalid class C, vote over 1..C-1, argmax + 1.

Unlike the TPU kernel, K2 does not take pre-gathered (B, P, S²) windows
(240 MB at KITTI size). It buckets the points by image tile (8 rows x 128
columns): a tile histogram, a scan into offsets and a chunk table (chunks
of at most 1024 points, never across a tile), a scatter of 16-byte
records {point, range, y, x} into tile order, then one block per chunk
that reads its tile and halo from the packed (B, H, W) image once,
coalesced, into shared memory, and votes each record from there. So the
window reads are shared and coalesced in any point order. Four launches
behind one C entry point; integer atomics only (the order within a tile
may vary; no label depends on it). The wrapper allocates the scratch.

On a CUDA tensor :func:`knn_vote` launches the kernel; on a CPU tensor it
runs :func:`knn_vote_reference`, the whole window chain in plain PyTorch
(pad, S² shifted views, flat gather, ``torch.topk``, vote). The kernel is
built with ``--fmad=false`` so |Δr|·g + 1 rounds as the twin's separate
ops do, and the card holds the two equal exactly.

What bounds the kernel on an H100 is bytes: at KITTI size 28.8 MB of
per-point inputs (range, px, py), 8.4 MB of image and 9.6 MB of labels out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from coarse3d_tpu_torch.ops._build import KernelLibrary, launch_check, stream_of
from coarse3d_tpu_torch.ops.knn import (
    LABEL_MASK,
    _inv_gaussian_kernel,
    _pack,
    _unpack,
)

SEARCH_SIZES = (3, 5, 7)  # window sizes the kernel is instantiated for
TILE_H, TILE_W = 8, 128   # image tile of one bucket (csrc: kTileH, kTileW)
CHUNK = 1024              # most points of one vote block (csrc: kChunk)
MAX_TILES = 232448 // 4   # tile histogram in one block's shared memory
INT32_MAX = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i32 = ctypes.c_int32
    lib.c3d_knn_vote.argtypes = [
        p, p, p, p, p, p,                    # packed, range, px, py, gauss, out
        p,                                   # scratch
        ctypes.c_int64, ctypes.c_int64,      # b, p
        i32, i32, i32, i32, i32,             # h, w, search, n_classes, knn
        ctypes.c_float, p]                   # cutoff, stream
    lib.c3d_knn_vote.restype = ctypes.c_int
    lib.c3d_knn_vote_scratch.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                         i32, i32]
    lib.c3d_knn_vote_scratch.restype = ctypes.c_int64


# --fmad=false: no multiply-add contraction, so the kernel's distances round
# like the twin's separate mul and add (never -use_fast_math: it flushes
# denormals, and the packed label bits of a small range with them)
LIBRARY = KernelLibrary("knn_vote", _bind, extra_flags=("--fmad=false",))


def _check(packed, point_range, px, py, n_classes, knn, search) -> None:
    if packed.dim() != 3 or point_range.dim() != 2:
        raise ValueError(f"packed must be (B, H, W) and point_range (B, P), "
                         f"got {tuple(packed.shape)}, {tuple(point_range.shape)}")
    if not (point_range.shape == px.shape == py.shape
            and packed.shape[0] == point_range.shape[0]):
        raise ValueError("point_range, px, py must be (B, P) with packed's B")
    if packed.dtype != torch.float32 or point_range.dtype != torch.float32:
        raise TypeError("packed and point_range must be float32")
    if px.dtype != torch.int32 or py.dtype != torch.int32:
        raise TypeError("px and py must be int32")
    if len({t.device for t in (packed, point_range, px, py)}) != 1:
        raise ValueError("packed, point_range, px, py on different devices")
    if search not in SEARCH_SIZES:
        raise ValueError(f"search must be one of {SEARCH_SIZES}, got {search}")
    if not 1 <= knn <= search * search:
        raise ValueError(f"knn={knn} outside [1, {search * search}]")
    if not 2 <= n_classes <= LABEL_MASK:
        raise ValueError(f"n_classes={n_classes} must fit the mantissa pack "
                         f"(2..{LABEL_MASK})")


def knn_vote(
    packed: torch.Tensor,
    point_range: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    *,
    n_classes: int,
    knn: int,
    search: int,
    sigma: float,
    cutoff: float,
) -> torch.Tensor:
    """Fused window fetch + distance + top-k + vote.

    Args:
      packed: (B, H, W) float32 label-packed range image (``knn._pack``
        convention, empty pixels already pushed to ``EMPTY_RANGE``).
      point_range: (B, P) float32 true per-point range.
      px, py: (B, P) int32 pixel of each point.

    Returns (B, P) int32 voted labels in [1, n_classes-1].
    """
    _check(packed, point_range, px, py, n_classes, knn, search)
    if packed.device.type == "cpu":
        return knn_vote_reference(
            packed, point_range, px, py, n_classes=n_classes, knn=knn,
            search=search, sigma=sigma, cutoff=cutoff)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not all(t.is_contiguous() for t in (packed, point_range, px, py)):
        raise ValueError("knn_vote kernel needs contiguous inputs")
    b, h, w = packed.shape
    p = point_range.shape[1]
    n_tiles, _ = tile_layout(b, p, h, w)
    if b * p > INT32_MAX or b * h * w > INT32_MAX:
        raise ValueError(f"K2 indexes in int32: B*P={b * p} and B*H*W="
                         f"{b * h * w} must be <= {INT32_MAX}")
    if n_tiles > MAX_TILES or max(h, w, b) > 65535:
        raise ValueError(f"K2 takes at most {MAX_TILES} image tiles and H, "
                         f"W, B <= 65535; got B={b}, H={h}, W={w}")
    lib = LIBRARY.load()
    gauss = np.ascontiguousarray(_inv_gaussian_kernel(search, sigma))
    dev = packed.device
    out = torch.empty((b, p), dtype=torch.int32, device=dev)
    # one allocation; the C entry point carves it and zeroes the counts
    scratch = torch.empty(lib.c3d_knn_vote_scratch(b, p, h, w),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.c3d_knn_vote(
            packed.data_ptr(), point_range.data_ptr(), px.data_ptr(),
            py.data_ptr(), gauss.ctypes.data, out.data_ptr(),
            scratch.data_ptr(), b, p, h, w,
            search, n_classes, knn, cutoff, stream_of(packed))
    launch_check(err, "knn_vote")
    knn_vote.launches += 1
    return out


knn_vote.launches = 0  # kernel launches; chip_smoke.py reads and resets it


def tile_layout(b: int, p: int, h: int, w: int) -> tuple[int, int]:
    """(number of image tiles, most vote chunks) of K2 at this shape: each
    tile holds ceil(count / CHUNK) chunks, so at most one more than its
    share of B*P / CHUNK."""
    n_tiles = b * -(-h // TILE_H) * -(-w // TILE_W)
    return n_tiles, n_tiles + -(-(b * p) // CHUNK)


def knn_vote_reference(
    packed: torch.Tensor,
    point_range: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    *,
    n_classes: int,
    knn: int,
    search: int,
    sigma: float,
    cutoff: float,
) -> torch.Tensor:
    """Plain PyTorch twin of :func:`knn_vote`: the JAX package's XLA chain
    (``knn_postprocess`` after the pack) step for step."""
    _check(packed, point_range, px, py, n_classes, knn, search)
    b, h, w = packed.shape
    pad = (search - 1) // 2
    s2 = search * search
    center = s2 // 2
    # zero padding parity: borders contribute range 0, label 0 == packed 0.0
    padded = F.pad(packed, (pad, pad, pad, pad), value=0.0)
    windows = torch.stack(
        [padded[:, dy:dy + h, dx:dx + w]
         for dy in range(search) for dx in range(search)],
        dim=-1).reshape(b * h * w, s2)
    base = torch.arange(b, device=packed.device, dtype=torch.int64)[:, None]
    idx = base * (h * w) + py.long() * w + px.long()
    # the JAX take clips out-of-range rows (mode="clip")
    neigh = windows[idx.reshape(-1).clamp(0, b * h * w - 1)].view(b, -1, s2)

    neigh_range, neigh_label = _unpack(neigh)
    # centre replaced by the point's own range (distance 0, label kept)
    neigh_range[..., center] = point_range
    inv_gauss = torch.from_numpy(_inv_gaussian_kernel(search, sigma).copy()).to(
        packed.device)
    # +1 offset: zero distances (the centre) would otherwise pack into
    # denormals whose label bits flush-to-zero arithmetic loses
    dist = torch.abs(neigh_range - point_range[..., None]) * inv_gauss + 1.0
    dist = _pack(dist, neigh_label)   # labels ride through topk

    neg_top = torch.topk(-dist, knn, dim=-1).values       # knn smallest
    knn_dist, knn_label = _unpack(-neg_top)
    knn_dist = knn_dist - 1.0
    if cutoff > 0:
        knn_label = torch.where(knn_dist > cutoff, n_classes, knn_label)

    # vote over classes 1..C-1 (never unlabeled 0 / invalid C); argmax
    # returns the first maximum, the lowest class
    classes = torch.arange(1, n_classes, device=packed.device, dtype=torch.int32)
    votes = (knn_label[..., None] == classes).sum(dim=-2)
    return (torch.argmax(votes, dim=-1) + 1).to(torch.int32)
