"""Bytes and operations of the kernels K1, K2 and K3 for one launch,
counted from the launch's input shapes and data: each input read once,
each output written once, and only the arithmetic the data needs. The
work counted does not depend on what implements it."""

from __future__ import annotations

from benchmark.roofline import peaks


def bound_s(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """Least seconds the card could take, and which resource bounds it."""
    by_bytes = nbytes / peaks.HBM_BYTES_PER_S
    by_ops = ops / peaks.FP32_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")


def k1_projection(b: int, p: int, c: int, hw: int) -> tuple[float, float]:
    """Fused projection of (B, P, C) float32 points to B images of ``hw``
    pixels: reads the per-point pixel id (int32), depth (float32) and the
    points; writes proj_idx, proj_range, proj_mask (4 bytes a pixel each)
    and proj_points (C floats a pixel). A 64-bit compare a point and a copy
    a pixel: no floating-point work to count."""
    return 4.0 * b * p * (2 + c) + 4.0 * b * hw * (3 + c), 0.0


def k2_knn_vote(b: int, p: int, hw: int, knn: int, search: int
                ) -> tuple[float, float]:
    """KNN vote of B x P points over B packed (range, label) images:
    reads the image, the per-point range, px and py; writes a label a
    point. Per point, on every window tap |dr| * g + 1 (3 ops), the
    k-smallest selection's compares (k (S^2 - 1)) and the cutoff test
    (2 a pick)."""
    s2 = search * search
    nbytes = 4.0 * b * hw + 4.0 * b * p * 4
    ops = float(b * p) * (3 * s2 + knn * (s2 - 1) + 2 * knn)
    return nbytes, ops


def k3_prototypes(rows: int, c: int, m: int, k: int, d: int
                  ) -> tuple[float, float]:
    """Prototype tail over ``rows`` valid class rows (of C x M slots) of
    D floats with C x K sub-prototypes: reads the rows, the validity mask,
    the memory and the Gumbel noise of the valid rows; writes the memory.
    Float32 work the valid rows need: the similarity to all C x K
    prototypes, the own-class block, and one add of each row into its
    sub-prototype."""
    nbytes = 4.0 * rows * (d + k) + c * m + 2 * 4.0 * c * k * d
    ops = 2.0 * rows * c * k * d + 2.0 * rows * k * d + rows * d
    return nbytes, ops
