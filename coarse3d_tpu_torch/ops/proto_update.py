"""Prototype Sinkhorn/EMA tail: kernel K3 (``csrc/proto_update.cu``) and
its plain twin.

Replaces the TPU kernel ``ops/pallas/proto_update.py:_kernel`` of the JAX
package (called from ``fused_proto_tail``): per class c over its M gathered
rows — row LayerNorm + l2; similarity to the whole (C*K, D) memory; per-class
max; LayerNorm over classes; argmax; agreement mask (pred == c) & valid;
own-class (M, K) similarity / 0.05; masked max-shift, exp, 3 masked Sinkhorn
rounds; argmax(Q + gumbel); masked one-hot^T @ feat -> (K, D); l2; EMA on
occupied rows of non-ignore classes; l2 renorm.

On a CUDA tensor :func:`proto_tail` launches K3; on a CPU tensor it runs
:func:`proto_tail_reference`, ``fused_proto_tail`` step for step in plain
PyTorch. The kernel sums in another order than the twin, so the card holds
the two by tolerance (``chip_smoke.py``), not exactly.

K3 is three launches behind one C entry point (``csrc/proto_update.cu``):
- a one-block pre-pass that lists the (class, 64-row tile) pairs holding a
  valid row;
- the row pass, persistent blocks walking (live pair, chunk of whole
  classes of the memory) units: a register-tiled float32 product against
  the chunk staged in depth slices of 32 (cp.async, double-buffered), the
  class maxima folded per row;
- the class pass, one cluster of 8 CTAs per class, each holding a slice
  of Q up to the last valid slot: the agreement from the class maxima,
  the max, total and Sinkhorn column sums combined through distributed
  shared memory in rank order, and the contraction by assignment groups
  in registers.

What bounds K3 on an H100 is float32 operations (TF32 stays off): at KITTI
size (C=20, M=2048, K=20, D=256, every row valid) the similarity is
2·C·M·C·K·D = 8.39 G, the own-class block and the contraction 0.42 G each:
9.23 GFLOP, 0.138 ms at 67 TFLOP/s, against 46.6 MB of bytes (0.014 ms at
3.35 TB/s). The work follows the valid rows, not the M slots.
"""

from __future__ import annotations

import ctypes

import torch

from coarse3d_tpu_torch.ops._build import KernelLibrary, launch_check, stream_of
from coarse3d_tpu_torch.ops.sinkhorn import masked_sinkhorn

SINKHORN_ITERS = 3
SINKHORN_EPS = 0.05
MAX_CLASSES = 32        # one lane per class in the row pass
MAX_SUB_PROTOS = 32     # one lane per sub-prototype bucket in the class pass
DIM_MULTIPLE = 32       # D is staged in depth slices of 32 (csrc: kSlice)
SMEM_LIMIT = 232448     # bytes of shared memory one H100 block may use
ROWS_PER_TILE = 64      # rows of one row-pass block (csrc: kRows)
PROTOS_PER_CHUNK = 128  # prototype columns of one chunk (csrc: kProtos)
SLICE_LD = 36           # padded depth slice row, floats (csrc: kSliceLd)
CLUSTER = 8             # CTAs of one class in the class pass (csrc: kCluster)


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i32 = ctypes.c_int32
    f32 = ctypes.c_float
    lib.c3d_proto_tail.argtypes = [
        i32,                         # pass: -1 both, 0 row pass, 1 class pass
        p, p, p, p,                  # feat, valid, protos, gumbel
        p, p,                        # scratch, out
        i32, i32, i32, i32,          # c, m, k, d
        f32, f32, f32, i32, i32,     # momentum, 1 - momentum, eps, ignore, iters
        p]                           # stream
    lib.c3d_proto_tail.restype = ctypes.c_int
    lib.c3d_proto_tail_scratch.argtypes = [i32, i32, i32, i32]
    lib.c3d_proto_tail_scratch.restype = ctypes.c_int64


# IEEE division and expf throughout: never -use_fast_math
LIBRARY = KernelLibrary("proto_update", _bind)


def smem_bytes(c: int, m: int, k: int, d: int) -> tuple[int, int]:
    """Dynamic shared memory of the row pass and the class pass (the sums
    in ``csrc/proto_update.cu:row_smem_bytes`` and ``class_smem_bytes``)."""
    del c
    row = 4 * (ROWS_PER_TILE * (d + 4) + 2 * PROTOS_PER_CHUNK * SLICE_LD)
    r = -(-m // CLUSTER)                 # most rows one CTA holds
    floats = (k * d + r * (k + 1) + -(-k // CLUSTER) * d + (2 + 2 * k) + k
              + 66)
    ints = k + (k + 1) + 2 * r
    return row, 4 * floats + 4 * ints + 2 * r


def _check(feat_rows, valid, protos_n, gumbel) -> None:
    if feat_rows.dim() != 3 or protos_n.dim() != 3:
        raise ValueError("feat_rows must be (C, M, D) and protos_n (C, K, D), "
                         f"got {tuple(feat_rows.shape)}, {tuple(protos_n.shape)}")
    c, m, d = feat_rows.shape
    k = protos_n.shape[1]
    if protos_n.shape != (c, k, d):
        raise ValueError(f"protos_n {tuple(protos_n.shape)} != (C, K, D) = "
                         f"{(c, k, d)}")
    if valid.shape != (c, m) or gumbel.shape != (c, m, k):
        raise ValueError(f"valid {tuple(valid.shape)} must be {(c, m)} and "
                         f"gumbel {tuple(gumbel.shape)} {(c, m, k)}")
    if not all(t.dtype == torch.float32 for t in (feat_rows, protos_n, gumbel)):
        raise TypeError("feat_rows, protos_n and gumbel must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if len({t.device for t in (feat_rows, valid, protos_n, gumbel)}) != 1:
        raise ValueError("feat_rows, valid, protos_n, gumbel on different "
                         "devices")


def proto_tail(
    feat_rows: torch.Tensor,
    valid: torch.Tensor,
    protos_n: torch.Tensor,
    gumbel: torch.Tensor,
    *,
    momentum: float,
    ignore_cls: int = 0,
) -> torch.Tensor:
    """Dense tail of the prototype update.

    Args:
      feat_rows: (C, M, D) float32 raw gathered embedding rows.
      valid: (C, M) bool budget mask.
      protos_n: (C, K, D) float32 l2-normalized memory.
      gumbel: (C, M, K) float32 Gumbel noise.

    Returns the new (C, K, D) float32 memory (l2-renormalized).
    """
    _check(feat_rows, valid, protos_n, gumbel)
    if feat_rows.device.type == "cpu":
        return proto_tail_reference(feat_rows, valid, protos_n, gumbel,
                                    momentum=momentum, ignore_cls=ignore_cls)
    if feat_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {feat_rows.device}")
    buffers = _kernel_buffers(feat_rows, valid, protos_n, gumbel)
    _launch(-1, feat_rows, valid, protos_n, gumbel, buffers, momentum,
            ignore_cls)
    proto_tail.launches += 1
    return buffers[-1]


proto_tail.launches = 0  # kernel launches; chip_smoke.py reads and resets it


def _kernel_buffers(feat_rows, valid, protos_n, gumbel):
    """Check what the kernel takes; return its scratch (one allocation,
    carved by the C entry point: featn, simc, the class maxima and the list
    of live tiles) and its output: the kernel allocates nothing."""
    if not all(t.is_contiguous() for t in (feat_rows, valid, protos_n,
                                           gumbel)):
        raise ValueError("proto_tail kernel needs contiguous inputs")
    c, m, d = feat_rows.shape
    k = protos_n.shape[1]
    if c > MAX_CLASSES or k > MAX_SUB_PROTOS or d % DIM_MULTIPLE:
        raise ValueError(f"K3 takes C <= {MAX_CLASSES}, K <= {MAX_SUB_PROTOS}"
                         f" and D a multiple of {DIM_MULTIPLE}; got C={c}, "
                         f"K={k}, D={d}")
    need = max(smem_bytes(c, m, k, d))
    # the pre-pass holds one int flag per (class, row tile) pair
    if need > SMEM_LIMIT or 4 * c * -(-m // ROWS_PER_TILE) > SMEM_LIMIT - 1024:
        raise ValueError(f"K3 needs {need} bytes of shared memory per block "
                         f"at C={c}, M={m}, K={k}, D={d} (> {SMEM_LIMIT})")
    dev = feat_rows.device
    words = LIBRARY.load().c3d_proto_tail_scratch(c, m, k, d)
    return (torch.empty(words, dtype=torch.float32, device=dev),
            torch.empty((c, k, d), dtype=torch.float32, device=dev))


def _launch(which, feat_rows, valid, protos_n, gumbel, buffers, momentum,
            ignore_cls) -> None:
    c, m, d = feat_rows.shape
    k = protos_n.shape[1]
    scratch, out = buffers
    with torch.cuda.device(feat_rows.device):
        err = LIBRARY.load().c3d_proto_tail(
            which, feat_rows.data_ptr(), valid.data_ptr(),
            protos_n.data_ptr(), gumbel.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), c, m, k, d, momentum, 1.0 - momentum,
            SINKHORN_EPS, ignore_cls, SINKHORN_ITERS, stream_of(feat_rows))
    launch_check(err, "proto_tail")


def pass_timer(feat_rows, valid, protos_n, gumbel, *, momentum: float,
               ignore_cls: int = 0):
    """For timing each of K3's two passes alone on CUDA tensors: returns
    ``run(which)`` that launches the row pass (0) or the class pass (1) on
    scratch allocated once (the class pass reads what the row pass left).
    These launches are measurements, not the path's: they are not counted
    in ``proto_tail.launches``."""
    _check(feat_rows, valid, protos_n, gumbel)
    if feat_rows.device.type != "cuda":
        raise ValueError("pass_timer times the kernel: CUDA tensors only")
    buffers = _kernel_buffers(feat_rows, valid, protos_n, gumbel)
    _launch(0, feat_rows, valid, protos_n, gumbel, buffers, momentum,
            ignore_cls)

    def run(which: int) -> None:
        _launch(which, feat_rows, valid, protos_n, gumbel, buffers,
                momentum, ignore_cls)

    return run


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.sqrt(torch.sum(x * x, dim=-1,
                                                    keepdim=True)), 1e-12)


def _layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def proto_tail_reference(
    feat_rows: torch.Tensor,
    valid: torch.Tensor,
    protos_n: torch.Tensor,
    gumbel: torch.Tensor,
    *,
    momentum: float,
    ignore_cls: int = 0,
) -> torch.Tensor:
    """Plain PyTorch twin of :func:`proto_tail`: the JAX package's
    ``fused_proto_tail`` step for step, all classes at once."""
    _check(feat_rows, valid, protos_n, gumbel)
    c, m, d = feat_rows.shape
    k = protos_n.shape[1]
    cls = torch.arange(c, device=feat_rows.device)
    feat = _l2(_layer_norm(feat_rows))                          # (C, M, D)

    # similarity to every sub-prototype, max within each class
    sim_full = torch.einsum("cmd,jd->cmj", feat, protos_n.reshape(c * k, d))
    nearest = sim_full.reshape(c, m, c, k).amax(dim=-1)         # (C, M, C)
    pred = torch.argmax(_layer_norm(nearest), dim=-1)           # (C, M)
    agree = (pred == cls[:, None]) & valid

    # own-class block + masked Sinkhorn
    sim_c = torch.einsum("cmd,ckd->cmk", feat, protos_n)        # (C, M, K)
    onehot, _ = masked_sinkhorn(sim_c, valid, gumbel, SINKHORN_ITERS,
                                SINKHORN_EPS)
    m_q = onehot * agree[..., None].to(torch.float32)

    # contraction + EMA + renorm
    f = _l2(torch.einsum("cmk,cmd->ckd", m_q, feat))            # (C, K, D)
    n_assigned = m_q.sum(dim=1)                                 # (C, K)
    occupied = (n_assigned > 0) & (cls[:, None] != ignore_cls)
    new = torch.where(occupied[..., None],
                      momentum * protos_n + (1.0 - momentum) * f, protos_n)
    return _l2(new)
