"""Entropy-driven pseudo-label expansion.

Port of the JAX package's ``losses/entropy_selection.py``. Behavioral
model: trainer.py:447-518 (``entropy_based_selection``): per-pixel entropy
of the softmax output gives sampling weights exp(-entropy); for every class
that appears in an image's *weak* labels, floor(ratio * |pixels predicted
as c|) of that class's predicted pixels are sampled without replacement
(probability ∝ weight); ground truth stays on weak pixels.

Sampling without replacement is Gumbel top-k over one flat sort of the
whole batch, as in the JAX package: the batch is folded into one composite
int32 key (image, class, quantised -score), sorted stably, and each
(image, class) segment keeps its first k. Here the segment-run starts are a
``torch.cummax`` over start positions, and each run's budget is gathered at
its start instead of the JAX package's flagged segmented scan; both give
each position the value at its run's start.

The Gumbel noise is an argument, so the JAX package and the port can be fed
the same numbers; ``train/step.py`` draws it from the state's generator.
"""

from __future__ import annotations

import torch


def _run_starts(is_start: torch.Tensor, iota: torch.Tensor) -> torch.Tensor:
    """For each position, the index of its segment-run's first element."""
    return torch.cummax(torch.where(is_start, iota, 0), dim=0).values


def entropy_based_selection(
    probs: torch.Tensor,
    wss_mask: torch.Tensor,
    eval_mask: torch.Tensor,
    train_label: torch.Tensor,
    select_ratio,
    gumbel: torch.Tensor,
    ignore_cls: int = 0,
    global_batch: int | None = None,
):
    """Batched pseudo-label expansion.

    Args:
      probs: (B, H, W, C) softmax output.
      wss_mask: (B, H, W) bool weak-label mask.
      eval_mask: (B, H, W) bool valid-pixel mask.
      train_label: (B, H, W) int weak labels.
      select_ratio: scalar keep ratio in [0, 1] (float or 0-d tensor).
      gumbel: (B*H*W,) float32 standard Gumbel noise.
      global_batch: when the inputs are one rank's stripe of a larger
        batch, that batch's size. Segments are per image, so the selection
        is the rank's own; only the key width, and with it the score
        quantisation, depends on the batch size, and it is taken from the
        global one.

    Returns (pseudo_label (B, H, W) int32, pseudo_mask (B, H, W) bool).
    """
    b, h, w, c = probs.shape
    n = h * w
    total = b * n
    dev = probs.device
    seg_per_img = c + 1  # classes 0..C-1 + non-candidate sentinel C
    n_seg = b * seg_per_img
    # quantized score width: segment id must fit in the remaining high bits
    key_seg = (global_batch or b) * seg_per_img
    q_bits = 31 - max((key_seg - 1).bit_length(), 1)
    if q_bits < 16:
        raise ValueError(f"B={b}, C={c} leave {q_bits} < 16 score bits")
    q_max = (1 << q_bits) - 1

    p = probs.reshape(total, c).float()
    entropy = -torch.sum(p * torch.log(p + 1e-10), dim=-1)
    pseudo = torch.argmax(p, dim=-1).to(torch.int32)
    eval_m = eval_mask.reshape(total)
    wss_m = wss_mask.reshape(total)
    gt = train_label.reshape(total).to(torch.int32)
    pseudo = torch.where(eval_m, pseudo, ignore_cls)

    score = -entropy + gumbel.reshape(total)
    cand = eval_m & (pseudo != ignore_cls)

    iota = torch.arange(total, dtype=torch.int32, device=dev)
    img = iota // n
    seg = img * seg_per_img + torch.where(cand, pseudo, c)
    # clamp bound q_max rounds to float32, as in the JAX package
    q = torch.clamp((score + 8.0) * ((1 << q_bits) / 16.0), 0.0,
                    float(q_max)).to(torch.int32)
    keys = seg * (1 << q_bits) + (q_max - q)  # ascending seg, desc score

    sorted_keys, order = torch.sort(keys, stable=True)
    sorted_seg = sorted_keys >> q_bits

    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_seg[1:] != sorted_seg[:-1]])
    run_start = _run_starts(is_start, iota)
    rank = iota - run_start

    starts = torch.searchsorted(
        sorted_seg, torch.arange(n_seg + 1, dtype=torch.int32, device=dev))
    counts = starts[1:] - starts[:-1]

    # classes eligible for expansion: present among the image's weak
    # labels (out-of-range labels masked here, as in the JAX package)
    weak_seg = torch.where(wss_m & (gt >= 0) & (gt < c),
                           img * seg_per_img + gt, n_seg)
    weak_present = torch.zeros(n_seg + 1, dtype=torch.bool, device=dev)
    # index_fill_ takes the Python scalar as it is; ``x[idx] = True`` would
    # build a host tensor and copy it over, which makes the host wait
    weak_present.index_fill_(0, weak_seg.long(), True)
    weak_present = weak_present[:n_seg]

    seg_cls = torch.arange(n_seg, dtype=torch.int32, device=dev) % seg_per_img
    # a Python float multiplies as a float32 scalar, with no copy to the
    # device (a copy from pageable memory makes the host wait)
    ratio = (select_ratio.to(dev, torch.float32)
             if torch.is_tensor(select_ratio) else float(select_ratio))
    k_per_seg = torch.floor(counts.to(torch.float32) * ratio).to(torch.int32)
    k_eff = torch.where(
        weak_present & (seg_cls != ignore_cls) & (seg_cls != c)
        & (k_per_seg >= 1), k_per_seg, 0)

    # each nonempty segment's budget at its run start, then read back at
    # every position from its run's start
    start_idx = torch.where(counts > 0, starts[:-1], total)
    k_at_start = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    k_at_start[start_idx.long()] = k_eff
    k_run = k_at_start[run_start.long()]
    selected_sorted = rank < k_run

    out_sorted = torch.where(
        selected_sorted,
        torch.clamp_max(torch.remainder(sorted_seg, seg_per_img), c - 1),
        ignore_cls).to(torch.int32)
    out = torch.empty(total, dtype=torch.int32, device=dev)
    out[order] = out_sorted                  # the one unsort scatter
    out = torch.where(wss_m, gt, out)        # ground truth always wins
    return out.reshape(b, h, w), (out != ignore_cls).reshape(b, h, w)
