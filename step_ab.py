#!/usr/bin/env python3
"""Time the bare SalsaNext training steps of two checkouts of the PyTorch
port on one NVIDIA card, in alternating processes.

    python3 step_ab.py --trees A B [--pairs 3] [--out FILE]

Each process imports ``coarse3d_tpu_torch`` from one tree, builds the
``kitti`` preset's SalsaNext (parity stem, full width 64x2048, bf16
autocast) from seed 0, and on B=4 synthetic KITTI scans (120k points, weak
ratio 0.001) times the warmup step and the contrast step as
``chip_smoke.py`` phase 8 does: CUDA events, the median of 10 steps after 3
untimed ones. It then profiles 5 contrast steps (torch.profiler) and sums
the device time of every kernel and of the BatchNorm kernels (names with
``batch_norm`` or ``bn_``: the library's own and cuDNN's). The processes
run in the order A B, B A, A B, ... (``--pairs`` pairs), so that a drift
of the card or of the host falls on both trees alike. One JSON line per
process, then the card's name and power limit and a summary line; with
``--out`` the lines also go to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

N_POINTS = 120_000
TRAIN_BATCH = 4
SELECT_RATIO = 0.3
REPS = 10
WARMUP = 3
PROFILED = 5


def _time_ms(fn) -> float:
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn) -> tuple[float, float]:
    """Mean device ms a call of fn() spends in all kernels and in the
    BatchNorm kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    total = bn = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = e.device_time_total
        total += us
        if "batch_norm" in e.key.lower() or "bn_" in e.key.lower():
            bn += us
    return total / PROFILED / 1e3, bn / PROFILED / 1e3


def one(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import coarse3d_tpu_torch
    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.data.synthetic import synthetic_batch
    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import batch_to_device, make_train_step

    here = os.path.dirname(os.path.abspath(coarse3d_tpu_torch.__file__))
    assert here == os.path.join(os.path.abspath(tree), "coarse3d_tpu_torch")
    dev = torch.device("cuda")
    cfg = preset("kitti")
    host = synthetic_batch(np.random.default_rng(5), cfg, TRAIN_BATCH,
                           n_points=N_POINTS, weak_ratio=0.001)
    batch = batch_to_device(host, dev)
    state = build_state(cfg, device=dev, seed=0, steps_per_epoch=100)
    alpha = build_alpha(cfg)
    warm = make_train_step(cfg, alpha, with_contrast=False)
    contrast = make_train_step(cfg, alpha, with_contrast=True)
    out = {"tree": tree,
           "contrast_ms": _time_ms(lambda: contrast(state, batch,
                                                    SELECT_RATIO)),
           "warmup_ms": _time_ms(lambda: warm(state, batch))}
    out["contrast_device_ms"], out["contrast_bn_ms"] = _device_ms(
        lambda: contrast(state, batch, SELECT_RATIO))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trees", nargs=2, metavar=("A", "B"))
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out")
    p.add_argument("--one", metavar="TREE", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        print(json.dumps(one(args.one)))
        return 0
    if not args.trees:
        p.error("--trees A B is required")
    a, b = args.trees
    order = [t for i in range(args.pairs) for t in ((a, b) if i % 2 == 0
                                                      else (b, a))]
    lines, runs = [], {a: [], b: []}
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(res)
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    lines.append(gpu)
    summary = {t: {k: [r[k] for r in rs] for k in rs[0] if k != "tree"}
               for t, rs in runs.items()}
    lines.append(json.dumps({"order": order, "runs": summary}))
    print("\n".join(lines[-2:]))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
