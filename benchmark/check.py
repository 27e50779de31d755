"""The numbers that decide ``correct``, and their comparison with the
cell's limits (``benchmark/limits/<workload>.json``: for each number its
``limit``, and the ``lower`` and ``upper`` readings it was set between).

Serving (``drivers/serve.py:mismatch_numbers``): ``label_mismatch_rel``,
the share of valid points whose served label differs from the float32
reference's, over the share that float8 convolutions change; and
``scan_mismatch_rel_max``, the same ratio for each checked scan alone, the
largest over the scans.

Training, over the first three steps, which the program and the reference
take from the same weights, memory, raw scans and noise:

- ``loss_gap``: the largest relative gap of a step's total loss
  (``loss_gap_first``: the first step's alone);
- ``grad_gap``: the first gradient as the optimizer holds it, by the worst
  parameter: the gap between the two norms of a leaf over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for the parameters' change over the three
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
- ``memory_gap``: the same for the memory's move over the three steps
  (from its l2-normalised start), by the worst class, over the classes
  that either side moved by more than a thousandth of the reference's
  largest move; the median is over the classes the reference moved;
- each of the last three also by the median leaf or class
  (``..._median``), which the worst one's noise does not move;
- ``proto_gap_median`` (:func:`sub_proto_gaps`): the memory's move by
  sub-prototype, as vectors, the median over the rows either side moved.

A class's move is the sum of a few sub-prototype updates, each decided by
whether a row's nearest class is its own; bfloat16 rounding flips that for
a few rows a run, so the move by class (``memory_gap_median``) jumps
between discrete values and is only a reading. By sub-prototype a flip
moves one row of some forty, and the median does not see it.
"""

from __future__ import annotations

import math
import statistics
import sys

TINY_GRAD = 1e-3


def _worst_leaf(prog: dict, ref: dict, names, over=None) -> float:
    """Largest |prog - ref| over max(ref, the median of ``ref`` over
    ``over``, by default over ``names``)."""
    names = list(names)
    med = statistics.median(ref[n] for n in (names if over is None
                                             else over))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def _median_leaf(prog: dict, ref: dict, names, over=None) -> float:
    """As :func:`_worst_leaf`, the median over ``names`` instead of the
    largest."""
    names = list(names)
    med = statistics.median(ref[n] for n in (names if over is None
                                             else over))
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                             for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [3 floats], "grad": {leaf: norm},
    "change": {leaf: norm}, "memory": (C, K, D), "memory0": (C, K, D)}
    (memories l2-normalised)."""
    import torch

    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    gmed = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= TINY_GRAD * gmed]
    def moves(side):
        return {c: float(v) for c, v in enumerate(torch.linalg.vector_norm(
            (side["memory"] - ref["memory0"]).flatten(1), dim=1))}

    ref_moves, prog_moves = moves(ref), moves(prog)
    floor = TINY_GRAD * max(ref_moves.values())
    ref_moved = [c for c, v in ref_moves.items() if v > floor]
    either = [c for c in ref_moves
              if max(ref_moves[c], prog_moves[c]) > floor]
    out = {"loss_gap": loss_gap,
           "loss_gap_first": abs(prog["losses"][0] - ref["losses"][0])
           / max(abs(ref["losses"][0]), 1e-30)}
    for name, fn in (("", _worst_leaf), ("_median", _median_leaf)):
        out["grad_gap" + name] = fn(prog["grad"], ref["grad"], ref["grad"])
        out["change_gap" + name] = fn(prog["change"], ref["change"], moved)
        out["memory_gap" + name] = fn(prog_moves, ref_moves, either,
                                      ref_moved) if ref_moved else 0.0
    out.update(sub_proto_gaps(prog["memory"], ref["memory"], ref["memory0"]))
    return out


def sub_proto_gaps(prog_mem, ref_mem, mem0) -> dict:
    """The memory's move over the three steps by sub-prototype (row of the
    (C, K, D) memory), as vectors: for each row that either side moved by
    more than a thousandth of the reference's largest row move, the norm of
    the difference of the two moves over the larger of the reference's
    move of that row and the median of its moved rows. ``..._median`` is
    the median over those rows; ``..._both_median`` the median over the
    rows that both sides moved."""
    import torch

    d = ref_mem.shape[-1]
    pm = (prog_mem.to(mem0.device) - mem0).reshape(-1, d)
    rm = (ref_mem - mem0).reshape(-1, d)
    pn, rn = (torch.linalg.vector_norm(x, dim=1) for x in (pm, rm))
    floor = TINY_GRAD * float(rn.max())
    ref_moved, prog_moved = rn > floor, pn > floor
    if not bool(ref_moved.any()):
        return {"proto_gap_median": 0.0, "proto_gap_both_median": 0.0}
    med = float(rn[ref_moved].median())
    gap = torch.linalg.vector_norm(pm - rm, dim=1) / rn.clamp_min(med)
    both = ref_moved & prog_moved
    return {"proto_gap_median":
            float(gap[ref_moved | prog_moved].median()),
            "proto_gap_both_median":
            float(gap[both].median()) if bool(both.any()) else 1.0}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number against its limit; a number with no limit, or one that
    is not finite, is not correct. Numbers without a limit are printed on
    standard error as readings."""
    checks, ok = {}, True
    for name, entry in limits.items():
        value = numbers.get(name)
        limit = entry["limit"]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    for name, value in numbers.items():
        if name not in limits:
            print(f"reading {name} = {value!r} (not compared)", file=sys.stderr)
    return ok and bool(checks), checks
