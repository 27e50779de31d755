#!/usr/bin/env python3
"""Smoke run of the PyTorch port (coarse3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. builds the port's four CUDA kernels from csrc/ with nvcc (all at once) and
   the native host preprocessing library with g++;
2. K1 (projection scatter-min) at KITTI size (B=16 scans of 120k points
   padded to 150k, 64x2048 images), kernel vs its plain twin: exact, for
   the scatter-min entry and for the fused projection entry (all four
   images, both mask conventions), also at a conflict case (every valid
   point of an image on one pixel, depths tied), at B=1, at a P that 4 does
   not divide and at C=5; per-launch device times (torch.profiler);
3. K2 (KNN vote) on the same projection, 20 classes, in two point orders
   (the scans' random order, and each scan sorted by flat pixel, the ring
   order of a real scan): kernel vs twin: exact in both;
3b. K3 (prototype Sinkhorn/EMA tail) at KITTI training shapes (C=20,
   M=2048, K=20, D=256; an empty ignore class, one more empty class, one
   full class, random counts elsewhere), kernel vs twin: max abs error
   <= 2e-5 at momentum 0.999; >= 0.95 of the (C, K) rows within 1e-4 at
   momentum 0 (a rare argmax flip moves a whole row); no NaN; the empty
   classes keep l2(memory); two runs bit-identical; each pass timed alone;
3c. K4 (SqueezeSegV3's fused SAC attention and 1x1 mix) at the seven SAC
   blocks of a SqueezeSegV3-21 serving batch (B=8, 64 rows; c and W of
   32x2048, 64x1024, 2 x 128x512, 3 x 256x256; seeded weights, BatchNorm
   statistics from the inputs): kernel vs its twin within 1e-2 of the
   largest output and no output beyond a bf16 ulp of the twin's plus 1e-3
   of the largest, kernel vs the unfused modules within 5e-2; at W=200
   (a ragged row segment) and W=100 (rows that 8 does not divide); the
   kernel's, the twin's and the modules' times (the modules as
   ``library_ms``) and the bound; K4's launches on a SqueezeSegV3-21
   serving batch of 8 scans (one a SAC block: 7), a SalsaNext batch (0)
   and a SqueezeSegV3-21 training forward and backward plus an eval
   forward with grad on (0);
4. the serving path: SalsaNext (parity stem, full width, bf16 compute,
   seeded random weights, BatchNorm statistics calibrated on two scans so
   the label map is not constant) answers 3 batches of 16 scans through
   ``make_inference_fn`` and ``tools/infer.py`` runs over synthetic .bin
   scans; every kernel's launch count went up in that run, labels are in
   [1, 19]; one scan through the float32 path on the CPU agrees with the
   card's float32 run (TF32 off) on >= 0.99 of its points;
5. timings (CUDA events, median of 20 after warm-up) of each kernel and its
   twin, of the path's stages and of a whole batch;
6. the training path: SalsaNext at full width (bf16 autocast, D=256, K=20,
   M=2048, A=512) on B=4 synthetic KITTI scans (120k points padded to 150k,
   weak ratio 0.001) through ``build_state`` / ``make_train_step``: one
   warmup step and 3 contrast steps at select ratio 0.3, then
   ``make_eval_step(use_knn=True)``; K3 and K2 launched in that run, every
   loss finite, the memory moved and stays unit-norm, the parameters
   changed, each confusion matrix counts every valid point;
6b. K3 again, at the size the training path gives it: the rows, valid
   mask and memory that ``update_prototypes``'s gather makes of phase 6's
   batch (embedding from an eval-mode forward of the trained state), the
   step's Gumbel noise; the same gates as 3b;
7. one float32 contrast step on one scan, CPU vs card (TF32 off, dropout
   0, same state, batch and noise): focal and Lovász within 1e-3
   relative, contrast within 1e-2 (an anchor draw may fall on the other
   side of a CDF boundary), the memory after the step within 1e-4;
8. training timings (CUDA events, median of 10 after warm-up): the
   contrast and warmup steps, their stages, peak memory;
9. the run loop at full width through the CLIs: ``tools/train.py`` for 2
   epochs of 4 steps on 16 synthetic scans (a warmup epoch, a contrast
   epoch, a KNN validation epoch after each), then ``--resume --epochs 3``,
   then ``tools/evaluate.py --run_dir --ckpt latest --knn``: K3 launched
   in the contrast epochs and K2 in validation, losses finite, rolling and
   best checkpoints exist and at most two rolling ones remain, the resumed
   run starts at epoch 2 with the saved step and learning rate, and
   evaluate's confusion matrix equals the Trainer's last validation's
   count for count;
9b. the Trainer driven directly on 32 such scans: steps/s of a warmup
   and a contrast epoch of 8 steps beside the bare step (an epoch's time
   holds its fixed costs: the first batch's wait, the log read at step 0,
   the read at its end), mean data wait (DT) and enqueue time (PT), the
   host's waits for the card in two steady steps of each kind
   (torch.profiler), checkpoint save / restore seconds and size.

10. the other families, serving: RangeNet-21, SqueezeSegV3-21 and SalsaNext
   with the width-only ``s2d_w`` stem at full width (bf16, BatchNorm
   calibrated as in phase 4) each answer 2 batches of 16 scans through
   ``make_inference_fn``: labels in [1, 19], K1 and K2 each launched once a
   batch, one scan CPU vs card in float32 agrees on >= 0.99 of its points;
   ms per batch, scans/s and peak memory per family; RangeNet-53 and
   SqueezeSegV3-53 (uncalibrated) serve one batch each;
11. the other families, training: RangeNet-21 and SqueezeSegV3-21 through
   ``build_state`` / ``make_train_step`` at B=4 (D=256, K=20, M=2048): one
   warmup and two contrast steps, every loss finite, K3 launched once a
   contrast step, the memory unit-norm; step ms and peak memory;
12. the CRF and the border mask: ``crf_refine`` on a served batch (B=16,
   20 classes), card against CPU in float32 within 1e-5; ``border_mask`` on
   the served label map, card against CPU exact; ``make_eval_step(
   use_crf=True, use_knn=True)`` launches K2 and its confusion matrix
   counts every valid point; ``tools/train_crf.py`` for 1 epoch on phase
   9's run directory and ``tools/evaluate.py --crf --crf_kernel --knn`` on
   its output, in-process; the CRF's ms at B=16 and the eval step's ms with
   and without it;
13. data parallelism over an NCCL group of one, in process, at full width
   (B=4, float32 with TF32 off, dropout on, the same batch and noise as
   the plain step): the group's collectives issued for real (all-reduce
   and all-gather forward and backward, int64, uint8, the generator's
   broadcast), then one warmup and two contrast steps through
   ``make_train_step(mesh=...)`` with PyTorch's deterministic algorithms,
   K3 launched once a contrast step; the
   same program as the plain step, so against it the first step's losses
   within 1e-6 and its confusion equal and, three steps on, losses 1e-4, confusion exact,
   BatchNorm statistics 1e-5, memory 1e-5, gradient cosines 0.999,
   parameters 1e-5; the contrast step's ms over the group and plain, in
   bf16, and the BatchNorm kernels' device time in each (torch.profiler);
14. two ranks spawned on the one card over gloo (NCCL refuses two ranks
   on one device), B=2 each: one warmup and one contrast step equal phase
   13's group of one on the concatenated batch (losses 1e-4, confusion
   exact, BatchNorm statistics 1e-5, memory 1e-5, gradient cosines 0.999,
   parameters 1e-5), the ranks' states bit-identical, K3 launched on each
   rank; then ``tools/evaluate.py --multihost --knn`` of 4 scans over the
   two ranks counts as one rank does, count for count, K2 launched;
15. the tools on the card: ``tools/contrast_ablation.py`` on a grid of two
   arms (``full``, ``nocontrast``) x one seed x 2 epochs at full SalsaNext
   width on 64x2048 images (8 hard synthetic scans of 20k points, B=4,
   contrast from epoch 1, KNN validation): K3 once a contrast step of
   ``full`` and none in ``nocontrast``, K2 once a validation step, the
   report's runs complete; ``entry()`` once (probabilities of the kitti
   shape, finite, summing to 1); ``dryrun_multichip(2)`` as two gloo ranks
   sharing the card (K3 twice a rank: the contrast step and the
   reference's per-rank memory update; K2 once a rank);
   ``tools/export_torch_ckpt.py --run_dir`` on phase 9's run, then
   ``tools/visualize.py --weights --knn`` of one scan from that ``.pth``
   (K1 and K2 once each), whose predicted labels equal
   ``tools/infer.py``'s for the scan (their PLY files, one colour a
   class, byte for byte); ``tools/convert_torch_ckpt.py`` of the ``.pth``
   gives back every tensor bit for bit.

The build fails the run if ptxas reports a spill in any kernel; it prints
each source's nvcc seconds.
It prints the card's name and power limit (nvidia-smi), one line per timing
tagged with them, a ``{"kernels": [...]}`` line (K2's time in both point
orders, K3's at both sizes and per pass, beside the common fields), and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX; the port's
JAX reference is only named, in the ``replaces`` fields.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCH = 16
N_POINTS = 120_000          # per synthetic scan (bench.py's KITTI shape)
N_REQUESTS = 3              # batches served on the main path
REPS = 20                   # timed repetitions (median)
WARMUP = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BN_GAIN = 0.8               # see calibrated_state
TRAIN_BATCH = 4             # scans per training step (bench.py:main_train)
CONTRAST_STEPS = 3
SELECT_RATIO = 0.3
TRAIN_REPS = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms: CUDA events around each call,
    after WARMUP untimed calls."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_batches(cfg, n_batches: int, seed: int):
    """n_batches of BATCH synthetic scans, padded to cfg.data.max_points."""
    from coarse3d_tpu_torch.data.synthetic import pad_points, synthetic_scan

    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        pts, valid = [], []
        for _ in range(BATCH):
            scan = synthetic_scan(rng, N_POINTS, cfg.data.n_classes,
                                  cfg.sensor)
            p, v = pad_points(scan["points"], cfg.data.max_points, fill=0.0)
            pts.append(p)
            valid.append(v)
        batches.append((np.stack(pts), np.stack(valid)))
    return batches


def calibrated_state(cfg, points, valid):
    """Seeded random weights whose BatchNorm running statistics are taken
    from the given scans, as a trained model's are. With init statistics
    (mean 0, var 1) the random convs shrink the signal until the class
    head's bias alone picks the label, and every pixel gets the same one;
    calibrated, the labels vary over the image, so the kernels and the
    CPU-vs-card comparison see a real label map."""
    import torch

    from coarse3d_tpu_torch.models.blocks import Dropout2d
    from coarse3d_tpu_torch.ops.projection import (
        build_range_features,
        normalize_features,
        range_project_batch,
    )
    from coarse3d_tpu_torch.train.setup import build_model

    cfg32 = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    model = build_model(cfg32, device="cpu", seed=0).train()
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.momentum = 1.0          # running stats := this batch's
        elif isinstance(mod, Dropout2d):
            mod.p = 0.0
    proj = range_project_batch(torch.from_numpy(points),
                               torch.from_numpy(valid), cfg.sensor)
    x = normalize_features(
        build_range_features(proj["proj_points"], proj["proj_range"]),
        proj["proj_idx"] >= 0, cfg.sensor)
    with torch.no_grad():
        model(x.permute(0, 3, 1, 2).contiguous())
        # A random network with calibrated BatchNorm is chaotic: one input
        # pixel that differs (an ulp of atan2 at a pixel edge, CPU vs card)
        # flips labels across its whole receptive field. Damping every BN
        # gain to BN_GAIN keeps a many-class map but stops that spread, as
        # the smoother maps of a trained network do.
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.mul_(BN_GAIN)
    return model.state_dict()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_report(log_path: str):
    """(kernel, registers line, spill line) for each entry function of an
    nvcc -Xptxas=-v log."""
    import re

    out, func, spill = [], None, ""
    if not os.path.exists(log_path):
        return out
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                # the kernel's own name, and its template arguments, out of
                # the mangled one
                name = re.search(r"(row_pass|class_pass|live_tiles|tile_[a-z]+"
                                 r"|scatter_min_keys|decode_keys|scatter_keys|emit_pixels"
                                 r"|sac_fused_kernel)", m.group(1))
                args = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
                flag = re.search(r"IL[ib](\d+)EE", m.group(1))
                func = (name.group(1) if name else m.group(1)) + (
                    "<%s,%s>" % args.groups() if args else
                    "<%s>" % flag.group(1) if flag else "")
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and func:
                out.append((func, line.strip().replace("ptxas info    : ", ""),
                            spill))
                func = None
    return out


def pixel_sorted(prange, pxi, pyi, w: int):
    """The same points with each scan sorted by flat pixel: the ring order
    in which a real scan arrives."""
    import torch

    idx = torch.argsort(pyi.long() * w + pxi.long(), dim=1, stable=True)
    return tuple(torch.gather(t, 1, idx).contiguous()
                 for t in (prange, pxi, pyi))


def profile_launches(fn, reps: int = 10) -> dict[str, float]:
    """Mean device time in microseconds of each kernel (and memset) that
    ``reps`` calls of fn() launch, by name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and not e.key.startswith("aten::"):
            name = e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0].strip()
            out[name] = e.device_time_total / reps
    check(bool(out), "torch.profiler recorded no device time")
    return out


def k1_phase(k1, points, valid, sensor, tag):
    """Phase 2: both K1 entries against their twins, exactly, at the
    serving batch and at the edge cases; their times, per-launch device
    times, and both bounds."""
    import torch

    from coarse3d_tpu_torch.ops.projection import scatter_inputs

    hw = sensor.proj_h * sensor.proj_w
    flat, depth, _, _ = scatter_inputs(points, valid, sensor)
    dev = flat.device
    b, p = flat.shape
    gen = torch.Generator(device=dev).manual_seed(11)
    pix = torch.randint(0, hw, (b, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    odd = p - 3                       # 4 does not divide it
    check(odd % 4 != 0, f"P - 3 = {odd} divides by 4")
    cases = {
        "serving batch": (flat, depth, points),
        # every valid point of an image on one pixel, depths in {1, 2, 3}:
        # the lowest index among the many points at depth 1 must win
        "one pixel an image": (
            torch.where(valid, pix, hw).to(torch.int32).contiguous(),
            torch.randint(1, 4, (b, p), generator=gen,
                          device=dev).float(), points),
        "B=1": (flat[:1].contiguous(), depth[:1].contiguous(),
                points[:1].contiguous()),
        f"P={odd}": (flat[:, :odd].contiguous(), depth[:, :odd].contiguous(),
                     points[:, :odd].contiguous()),
        "C=5": (flat, depth,
                torch.cat([points, points[..., :1] * 2], dim=-1).contiguous()),
    }
    err = 0.0
    for name, (fl, de, pts) in cases.items():
        got = k1.scatter_min(fl, de, hw)
        want = k1.scatter_min_reference(fl, de, hw)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K1 scatter_min differs from its twin ({name})")
        err = max(err, float((got[0] - want[0]).abs().max()))
        for excl0 in (False, True):
            got = k1.project_scatter(fl, de, pts, hw, excl0)
            want = k1.project_scatter_reference(fl, de, pts, hw, excl0)
            torch.cuda.synchronize()
            for key in want:
                check(got[key].dtype == want[key].dtype
                      and torch.equal(got[key], want[key]),
                      f"K1 project_scatter {key} differs from its twin "
                      f"({name}, mask_excludes_point0={excl0})")
                err = max(err, float((got[key].float()
                                      - want[key].float()).abs().max()))
    hit_rate = float((k1.scatter_min(flat, depth, hw)[1] < p).float().mean())
    print(f"K1 B={b} P={p} hw={hw}: scatter_min and project_scatter (4 "
          f"images, both masks) == their twins exactly at {list(cases)}; "
          f"{hit_rate:.4f} of pixels hit")

    runs = {
        "scatter_min": lambda: k1.scatter_min(flat, depth, hw),
        "project_scatter": lambda: k1.project_scatter(flat, depth, points,
                                                      hw),
    }
    ms = {name: time_ms(fn) for name, fn in runs.items()}
    plain = time_ms(lambda: k1.scatter_min_reference(flat, depth, hw))
    fused_plain = time_ms(lambda: k1.project_scatter_reference(
        flat, depth, points, hw))
    prof = {name: profile_launches(fn) for name, fn in runs.items()}
    # neither entry does float arithmetic (one 64-bit atomic a point, one
    # decode and copy a pixel), so bytes bound both: inputs read once,
    # outputs written once
    out = k1.project_scatter(flat, depth, points, hw)
    sm_bytes = nbytes(flat, depth, *k1.scatter_min(flat, depth, hw))
    fused_bytes = nbytes(flat, depth, points, *out.values())
    res = {"err": err, "ms": ms["scatter_min"], "plain": plain,
           "bytes": sm_bytes, "bound": sm_bytes / HBM_BYTES_PER_S * 1e3,
           "fused_ms": ms["project_scatter"], "fused_plain": fused_plain,
           "fused_bytes": fused_bytes,
           "fused_bound": fused_bytes / HBM_BYTES_PER_S * 1e3,
           "profile_us": prof}
    for name, launches in prof.items():
        print(f"profile {tag} K1 {name}, device time per launch: "
              + ", ".join(f"{k} {v:.1f} us" for k, v in launches.items())
              + f"; sum {sum(launches.values()):.1f} us")
    return res


def k3_case(dev, seed: int = 3, shape=(20, 2048, 20, 256)):
    """Seeded K3 inputs at ``shape`` = (C, M, K, D), KITTI training shapes
    by default: normal rows, a l2-normed memory, Gumbel noise; class 0
    (ignore) and class 1 empty, class 2 full, random valid counts elsewhere
    (valid rows are a prefix, as the class gather gives them)."""
    import torch

    c, m, k, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.randn(c, m, d, generator=g, device=dev)
    protos = torch.randn(c, k, d, generator=g, device=dev)
    protos = protos / protos.norm(dim=-1, keepdim=True)
    u = torch.rand(c, m, k, generator=g, device=dev).clamp_min(1e-30)
    gumbel = -torch.log(-torch.log(u))
    counts = torch.randint(1, m, (c,), generator=g, device=dev)
    counts[0] = 0
    counts[1] = 0
    counts[2] = m
    valid = torch.arange(m, device=dev)[None, :] < counts[:, None]
    return feat, valid, protos, gumbel


def k3_training_case(cfg, dev, state, batch):
    """Phase 6b's K3 inputs: what ``update_prototypes``'s gather makes of
    the training batch, with the step's Gumbel noise."""
    import torch

    from coarse3d_tpu_torch.models.prototypes import gather_class_rows
    from coarse3d_tpu_torch.train.step import _prepare_inputs, draw_noise

    feats, label, _, wss, _ = _prepare_inputs(batch, cfg)
    state.model.eval()
    with torch.no_grad():
        emb = state.model(feats.permute(0, 3, 1, 2).contiguous(),
                          return_feat=True)["embedding"].permute(0, 2, 3, 1)
    feat, valid, protos = gather_class_rows(
        state.prototypes, emb, label, wss, cfg.contrast, cfg.train.ignore_cls)
    b, h, w = label.shape
    gumbel = draw_noise(state.generator, cfg, b, h, w)["proto"]
    return feat, valid, protos, gumbel.contiguous()


def k3_phase(k3, feat, valid, protos, gumbel, ignore, name, tag,
             timed: bool = True):
    """K3 against its twin on one set of inputs: the gates of phase 3b,
    two runs bit-identical; with ``timed``, its time, its twin's, each pass
    alone, and the bound this run's valid rows give."""
    import torch

    kw = dict(momentum=0.999, ignore_cls=ignore)
    got = k3.proto_tail(feat, valid, protos, gumbel, **kw)
    again = k3.proto_tail(feat, valid, protos, gumbel, **kw)
    want = k3.proto_tail_reference(feat, valid, protos, gumbel, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"K3 {name}: NaN/inf")
    check(torch.equal(got, again), f"K3 {name}: two runs differ")
    check(err <= 2e-5, f"K3 {name} vs twin at momentum 0.999: {err} > 2e-5")
    empty = [c for c in range(feat.shape[0])
             if c == ignore or not bool(valid[c].any())]
    l2_mem = protos / protos.norm(dim=-1, keepdim=True)
    empty_err = float((got[empty] - l2_mem[empty]).abs().max())
    check(empty_err <= 1e-6, f"K3 {name} empty/ignore classes moved: "
          f"{empty_err}")
    got0 = k3.proto_tail(feat, valid, protos, gumbel, momentum=0.0,
                         ignore_cls=ignore)
    want0 = k3.proto_tail_reference(feat, valid, protos, gumbel,
                                    momentum=0.0, ignore_cls=ignore)
    torch.cuda.synchronize()
    row_err = (got0 - want0).abs().amax(dim=-1)                # (C, K)
    rows_out = int((row_err > 1e-4).sum())
    check(bool(torch.isfinite(got0).all()), f"K3 {name}: NaN/inf (m=0)")
    check(rows_out <= 0.05 * row_err.numel(),
          f"K3 {name} vs twin at momentum 0: {rows_out} of "
          f"{row_err.numel()} rows off by > 1e-4")
    n = int(valid.sum())
    c, m, d = feat.shape
    k = protos.shape[1]
    print(f"K3 proto_tail {name}: C={c} M={m} K={k} D={d}, {n} valid rows "
          f"in {len(empty)} empty/ignore and {c - len(empty)} other classes:"
          f" momentum 0.999 max abs err {err:.3e}; momentum 0 max abs err "
          f"{float(row_err.max()):.3e}, {rows_out} of {row_err.numel()} rows"
          f" off by > 1e-4; empty classes err {empty_err:.1e}; two runs "
          "bit-identical")
    if not timed:
        return {"err": err, "rows": n}
    ms = time_ms(lambda: k3.proto_tail(feat, valid, protos, gumbel, **kw))
    plain = time_ms(lambda: k3.proto_tail_reference(feat, valid, protos,
                                                    gumbel, **kw))
    run = k3.pass_timer(feat, valid, protos, gumbel, **kw)
    passes = {"row": time_ms(lambda: run(0)), "class": time_ms(lambda: run(1))}
    print(f"timing {tag} K3 passes alone, {name} ({n} valid rows): row pass "
          f"{passes['row']:.4f} ms, class pass {passes['class']:.4f} ms")
    # float32 work this run's valid rows need: LayerNorm + l2 aside, the
    # similarity to all C*K prototypes, the own-class block, and one add
    # of each contributing row into its sub-prototype
    ops = 2 * n * c * k * d + 2 * n * k * d + n * d
    nbytes_ = 4 * n * (d + k) + valid.numel() + 2 * protos.numel() * 4
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
    return {"err": err, "ms": ms, "plain": plain, "passes": passes,
            "bound": max(ops_ms, bytes_ms), "ops": ops, "bytes": nbytes_,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "rows": n,
            "by": "operations" if ops_ms >= bytes_ms else "bytes"}


# SqueezeSegV3-21's SAC blocks at B=8 on the 64x2048 KITTI image: (width,
# image width) of each of its seven blocks, in forward order
K4_SHAPES = ((32, 2048), (64, 1024), (128, 512), (128, 512), (256, 256),
             (256, 256), (256, 256))
K4_BATCH = 8
K4_HEIGHT = 64
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores


def k4_case(dev, c: int, w: int, seed: int):
    """A SAC block of width c with seeded weights, its BatchNorm statistics
    taken from the seeded inputs (float32, one training-mode pass), in eval
    mode; xyz (K4_BATCH, 3, K4_HEIGHT, w) float32 and a ReLU'd bf16
    feature (K4_BATCH, c, K4_HEIGHT, w)."""
    import torch

    from coarse3d_tpu_torch.models.squeezesegv3 import SACBlock
    from coarse3d_tpu_torch.train.setup import init_weights

    blk = SACBlock(c)
    init_weights(blk, torch.Generator().manual_seed(seed))
    blk = blk.to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.randn(K4_BATCH, 3, K4_HEIGHT, w, generator=g, device=dev)
    feat = torch.randn(K4_BATCH, c, K4_HEIGHT, w, generator=g,
                       device=dev).relu()
    for mod in blk.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.momentum = 1.0
    with torch.no_grad():
        blk.train()(xyz, feat)
    return blk.eval(), xyz, feat.to(torch.bfloat16)


def k4_phase(k4, dev, host, tag):
    """K4 at the seven SAC blocks of a SqueezeSegV3-21 serving batch (B=8):
    kernel against its twin and against the unfused modules; the kernel's,
    the twin's and the modules' times, the bound; then K4's launches on a
    SqueezeSegV3-21 serving batch (one a block), a SalsaNext serving batch
    and a SqueezeSegV3-21 training forward and backward (none)."""
    import torch

    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.eval.inference import make_inference_fn
    from coarse3d_tpu_torch.models.squeezesegv3 import unfold3x3
    from coarse3d_tpu_torch.train.setup import build_model

    rows, seen = [], {}
    for i, (c, w) in enumerate(K4_SHAPES):
        blk, xyz, feat = k4_case(dev, c, w, seed=11 + i)
        with torch.inference_mode(), torch.autocast(dev.type, torch.bfloat16):
            weights = blk.folded(torch.bfloat16)
            xb = xyz.to(torch.bfloat16).contiguous()

            def kernel():
                return k4.sac_fused(xb, feat, weights)

            def modules():
                att = blk.attention_x(xyz)
                return blk.position_mlp_2[:3](unfold3x3(feat)
                                              * att.to(feat.dtype))

            got = kernel().float()
            want = k4.sac_fused_reference(xb, feat, weights).float()
            chain = modules().float()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            abs_err = float((got - want).abs().max())
            err = abs_err / scale
            # beyond one bf16 ulp of the twin's value (both round float32
            # sums of the same bf16 operands, summed in another order)
            off = float(((got - want).abs()
                         > want.abs() * 2.0 ** -7 + 1e-3 * scale)
                        .float().mean())
            err_modules = float((got - chain).abs().max()) / scale
            check(err <= 1e-2 and off <= 1e-4,
                  f"K4 c={c} W={w}: kernel vs twin max error {err:.3e} of "
                  f"the output's max, {off:.2e} of outputs beyond an ulp")
            check(err_modules <= 5e-2, f"K4 c={c} W={w}: kernel vs the "
                  f"unfused modules {err_modules:.3e} of the output's max")
            if (c, w) not in seen:
                ms = time_ms(kernel)
                device_us = sum(profile_launches(kernel).values())
                plain = time_ms(lambda: k4.sac_fused_reference(xb, feat,
                                                               weights),
                                reps=5)
                library = time_ms(modules)
                pix = K4_BATCH * K4_HEIGHT * w
                ops = 2 * pix * 9 * c * (k4.TAPS + c)
                nb = nbytes(xb, feat, got.to(torch.bfloat16), *weights)
                bound = max(ops / BF16_OPS_PER_S, nb / HBM_BYTES_PER_S) * 1e3
                seen[(c, w)] = dict(ms=ms, device_us=device_us, plain=plain,
                                    library=library, bound=bound, ops=ops,
                                    bytes=nb)
        rows.append(dict(c=c, w=w, err=err, abs_err=abs_err, off=off,
                         err_modules=err_modules, **seen[(c, w)]))
        print(f"timing {tag} K4 sac_fused block {i} B={K4_BATCH} c={c} "
              f"{K4_HEIGHT}x{w}: kernel {rows[-1]['ms']:.4f} ms (device "
              f"{rows[-1]['device_us']:.1f} us), twin {rows[-1]['plain']:.4f}"
              f" ms, unfused modules (library) {rows[-1]['library']:.4f} ms, "
              f"bound {rows[-1]['bound']:.4f} ms ({rows[-1]['ops'] / 1e9:.1f}"
              f" GFLOP at 989 TFLOP/s); vs twin {err:.2e} ({off:.1e} beyond "
              f"an ulp), vs modules {err_modules:.2e}")
        del blk, xyz, feat, xb, got, want, chain
    # ragged: a width the 128-pixel row segment does not divide, and one
    # that 8 does not (the scalar loads and stores)
    for c, w in ((64, 200), (32, 100)):
        blk, xyz, feat = k4_case(dev, c, w, seed=40 + c)
        with torch.inference_mode():
            weights = blk.folded(torch.bfloat16)
            xb = xyz.to(torch.bfloat16).contiguous()
            got = k4.sac_fused(xb, feat, weights).float()
            want = k4.sac_fused_reference(xb, feat, weights).float()
            err = float((got - want).abs().max() / want.abs().max())
        check(err <= 1e-2, f"K4 c={c} W={w}: kernel vs twin {err:.3e}")
        print(f"K4 c={c} W={w} (ragged): kernel vs twin {err:.2e}")

    # launches by path, on the first 8 scans of the serving batch
    cfg = preset("kitti")
    points = torch.from_numpy(host[0][0][:K4_BATCH]).to(dev)
    valid = torch.from_numpy(host[0][1][:K4_BATCH]).to(dev)
    launches = {}
    for name in ("squeezesegv3_21", "salsanext"):
        fcfg = family_cfg(cfg, name) if name != "salsanext" else cfg
        infer = make_inference_fn(build_model(fcfg, device=dev, seed=0),
                                  fcfg)
        infer(points, valid)
        torch.cuda.synchronize()
        before = k4.sac_fused.launches
        infer(points, valid)
        torch.cuda.synchronize()
        launches[f"serving_{name}"] = k4.sac_fused.launches - before
    model = build_model(family_cfg(cfg, "squeezesegv3_21"), device=dev)
    x = torch.randn(TRAIN_BATCH, 5, K4_HEIGHT, cfg.sensor.proj_w,
                    device=dev)
    before = k4.sac_fused.launches
    model.train()
    out = model(x, generator=torch.Generator(device=dev).manual_seed(0))
    out["logits"].float().mean().backward()
    model.eval()
    model(x)["logits"].float().mean().backward()    # eval, grad on
    torch.cuda.synchronize()
    launches["training_squeezesegv3_21"] = k4.sac_fused.launches - before
    print(f"K4 launches: {launches}")
    check(launches == {"serving_squeezesegv3_21": len(K4_SHAPES),
                       "serving_salsanext": 0,
                       "training_squeezesegv3_21": 0},
          f"K4 launches by path: {launches}")
    return rows, launches


def k2_check(k2, proj_range, depth, px, py, n_classes, knn_cfg, name):
    """K2 against its twin, ``torch.equal``, on one projection with a
    seeded label image of ``n_classes``; returns the max abs difference."""
    import torch

    from coarse3d_tpu_torch.ops.knn import pack_range_image

    gen = torch.Generator(device=proj_range.device).manual_seed(2)
    argmax = torch.randint(0, n_classes, proj_range.shape, generator=gen,
                           device=proj_range.device, dtype=torch.int32)
    packed = pack_range_image(proj_range.float(), argmax)
    kw = dict(n_classes=n_classes, knn=knn_cfg.knn, search=knn_cfg.search,
              sigma=knn_cfg.sigma, cutoff=knn_cfg.cutoff)
    args = (depth.float().contiguous(), px.to(torch.int32).contiguous(),
            py.to(torch.int32).contiguous())
    got = k2.knn_vote(packed, *args, **kw)
    want = k2.knn_vote_reference(packed, *args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K2 knn_vote {name} differs from its "
          f"twin ({int((got != want).sum())} of {got.numel()} points)")
    b, h, w = proj_range.shape
    print(f"K2 knn_vote {name}: B={b} {h}x{w} P={depth.shape[1]} "
          f"C={n_classes}: kernel == twin exactly")
    return float((got - want).abs().max())


def train_phase(cfg, dev):
    """Phase 6: the training path at full width, B=TRAIN_BATCH."""
    import torch

    from coarse3d_tpu_torch.data.synthetic import synthetic_batch
    from coarse3d_tpu_torch.ops import knn_vote as k2
    from coarse3d_tpu_torch.ops import proto_update as k3
    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import (
        batch_to_device,
        make_eval_step,
        make_train_step,
    )

    host = synthetic_batch(np.random.default_rng(5), cfg, TRAIN_BATCH,
                           n_points=N_POINTS, weak_ratio=0.001)
    batch = batch_to_device(host, dev)
    state = build_state(cfg, device=dev, seed=0, steps_per_epoch=100)
    alpha = build_alpha(cfg)
    warm = make_train_step(cfg, alpha, with_contrast=False)
    contrast = make_train_step(cfg, alpha, with_contrast=True)
    evaluate = make_eval_step(cfg, use_knn=True)
    params0 = [p.detach().clone() for p in state.model.parameters()]
    protos0 = state.prototypes.clone()
    n_valid = int(host["point_valid"].sum())

    k3.proto_tail.launches = 0
    k2.knn_vote.launches = 0
    state, m = warm(state, batch)
    metrics = [m]
    for _ in range(CONTRAST_STEPS):
        state, m = contrast(state, batch, SELECT_RATIO)
        metrics.append(m)
    ev = evaluate(state, batch)
    torch.cuda.synchronize()
    launches = {"proto_tail": k3.proto_tail.launches,
                "knn_vote": k2.knn_vote.launches}
    print(f"training path: 1 warmup + {CONTRAST_STEPS} contrast steps at "
          f"B={TRAIN_BATCH}, select ratio {SELECT_RATIO}, then the KNN eval "
          f"step; launches {launches}")
    check(launches["proto_tail"] >= CONTRAST_STEPS,
          f"K3 did not run on every contrast step: {launches}")
    check(launches["knn_vote"] >= 1, f"K2 did not run in eval: {launches}")

    for i, m in enumerate(metrics):
        losses = {k: float(v) for k, v in m["losses"].items()}
        print(f"step {i}: losses {losses}" + (
            f", diag { {k: float(v) for k, v in m['diag'].items()} }"
            if "diag" in m else ""))
        check(all(np.isfinite(v) for v in losses.values()),
              f"step {i}: a loss is not finite: {losses}")
        check(int(m["confusion"].sum()) == n_valid,
              f"step {i}: confusion sums to {int(m['confusion'].sum())}, "
              f"not {n_valid} valid points")
    check(int(ev["confusion"].sum()) == n_valid, "eval confusion count")
    moved = float((state.prototypes - protos0).abs().max())
    norm_err = float((state.prototypes.norm(dim=-1) - 1).abs().max())
    changed = sum(not torch.equal(a, b.detach()) for a, b in
                  zip(params0, state.model.parameters()))
    print(f"memory moved by {moved:.3e}, unit norm within {norm_err:.1e}; "
          f"{changed} of {len(params0)} parameter tensors changed; eval "
          f"confusion counts {int(ev['confusion'].sum())} points")
    check(moved > 0, "the prototype memory did not move")
    check(norm_err <= 1e-5, f"memory rows off unit norm by {norm_err}")
    check(changed > 0, "no parameter changed")
    return state, batch, host, launches


def train_cpu_vs_card(cfg, dev, host):
    """Phase 7: one float32 contrast step on one scan, CPU vs card."""
    import torch

    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import batch_to_device, make_train_step

    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32", dropout_rate=0.0))
    one = {k: v[:1] for k, v in host.items()}
    h, w = cfg.sensor.proj_h, cfg.sensor.proj_w
    c, m, k = (cfg.data.n_classes, cfg.contrast.max_pixels_per_class,
               cfg.contrast.sub_proto_size)
    rng = np.random.default_rng(7)

    def gumbel(shape):
        u = np.maximum(rng.random(shape, dtype=np.float32),
                       np.finfo(np.float32).tiny)
        return -np.log(-np.log(u))

    noise = {"select": gumbel((h * w,)),
             "anchor": rng.random((1, c, cfg.contrast.num_anchor),
                                  dtype=np.float32),
             "proto": gumbel((c, m, k))}
    out = {}
    for where in ("cpu", dev):
        state = build_state(cfg32, device=where, seed=0, steps_per_epoch=100)
        step = make_train_step(cfg32, build_alpha(cfg32), with_contrast=True)
        t0 = time.perf_counter()
        state, metrics = step(state, batch_to_device(one, torch.device(where)),
                              SELECT_RATIO, noise)
        losses = {name: float(v) for name, v in metrics["losses"].items()}
        out[str(where)] = (losses, state.prototypes.cpu(),
                           time.perf_counter() - t0)
    (cpu_l, cpu_p, cpu_s), (card_l, card_p, _) = out["cpu"], out[str(dev)]
    rel = {name: abs(card_l[name] - cpu_l[name]) / max(abs(cpu_l[name]), 1e-12)
           for name in ("focal", "lovasz", "contrast")}
    proto_err = float((card_p - cpu_p).abs().max())
    print(f"training CPU vs card float32 (TF32 off), one scan: CPU losses "
          f"{cpu_l}, card losses {card_l}, relative gaps "
          f"{ {name: f'{v:.2e}' for name, v in rel.items()} }, memory max abs "
          f"err {proto_err:.3e} (CPU step {cpu_s:.1f} s)")
    check(rel["focal"] <= 1e-3 and rel["lovasz"] <= 1e-3,
          f"CPU vs card focal/Lovász gap {rel}")
    check(rel["contrast"] <= 1e-2, f"CPU vs card contrast gap {rel}")
    check(proto_err <= 1e-4, f"CPU vs card memory gap {proto_err}")


def train_timings(cfg, dev, state, batch, tag):
    """Phase 8: step and stage times of the training path."""
    import torch

    from coarse3d_tpu_torch.losses.contrast import contrast_mem_loss
    from coarse3d_tpu_torch.losses.entropy_selection import (
        entropy_based_selection,
    )
    from coarse3d_tpu_torch.losses.focal import focal_softmax_loss
    from coarse3d_tpu_torch.losses.lovasz import lovasz_softmax_loss
    from coarse3d_tpu_torch.models.prototypes import update_prototypes
    from coarse3d_tpu_torch.train.setup import build_alpha
    from coarse3d_tpu_torch.train.step import (
        _prepare_inputs,
        draw_noise,
        make_train_step,
    )

    alpha = build_alpha(cfg)
    contrast = make_train_step(cfg, alpha, with_contrast=True)
    warm = make_train_step(cfg, alpha, with_contrast=False)
    t_con = time_ms(lambda: contrast(state, batch, SELECT_RATIO),
                    reps=TRAIN_REPS)
    t_warm = time_ms(lambda: warm(state, batch), reps=TRAIN_REPS)
    torch.cuda.reset_peak_memory_stats()
    contrast(state, batch, SELECT_RATIO)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    model, ignore = state.model, cfg.train.ignore_cls
    feats, label, _, wss, eval_mask = _prepare_inputs(batch, cfg)
    x = feats.permute(0, 3, 1, 2).contiguous()
    alpha_t = torch.from_numpy(alpha).to(dev)
    b, h, w = label.shape
    noise = draw_noise(state.generator, cfg, b, h, w)

    def fwd_bwd():
        model.train()
        model.zero_grad(set_to_none=True)
        probs = model(x, return_feat=True, generator=state.generator)[
            "probs"].permute(0, 2, 3, 1)
        loss = (focal_softmax_loss(probs, label, alpha_t, wss)
                + lovasz_softmax_loss(probs, label, ignore=ignore,
                                      budget=cfg.train.lovasz_budget))
        loss.backward()

    with torch.no_grad():
        out = model(x, return_feat=True, generator=state.generator)
    probs = out["probs"].permute(0, 2, 3, 1)
    emb = out["embedding"].permute(0, 2, 3, 1)
    pseudo = entropy_based_selection(probs, wss, eval_mask, label,
                                     SELECT_RATIO, noise["select"], ignore)
    t_fwd_bwd = time_ms(fwd_bwd, reps=TRAIN_REPS)
    for p in model.parameters():        # as the step does: every parameter
        if p.grad is None:              # has a gradient for AdamW
            p.grad = torch.zeros_like(p)
    stages = {
        "forward + backward (focal + Lovász)": t_fwd_bwd,
        "entropy selection": time_ms(lambda: entropy_based_selection(
            probs, wss, eval_mask, label, SELECT_RATIO, noise["select"],
            ignore), reps=TRAIN_REPS),
        "contrast loss (forward)": time_ms(lambda: contrast_mem_loss(
            emb, probs, pseudo[0], pseudo[1], state.prototypes,
            noise["anchor"], cfg.contrast, ignore), reps=TRAIN_REPS),
        "prototype update (gather + K3)": time_ms(lambda: update_prototypes(
            state.prototypes, emb, label, wss, noise["proto"], cfg.contrast,
            ignore), reps=TRAIN_REPS),
        "optimizer (AdamW + schedule)": time_ms(
            lambda: state.optimizer.step(), reps=TRAIN_REPS),
    }
    lines = [
        f"training contrast step B={TRAIN_BATCH}: {t_con:.3f} ms, "
        f"{TRAIN_BATCH * 1e3 / t_con:.2f} scans/s; warmup step {t_warm:.3f} "
        f"ms; peak memory {peak_gb:.2f} GB (one contrast step)",
        "training stages B=%d: " % TRAIN_BATCH + ", ".join(
            f"{k} {v:.3f} ms" for k, v in stages.items()),
    ]
    for line in lines:
        print(f"timing {tag} {line}")
    return {"contrast_ms": t_con, "warmup_ms": t_warm}


RUN_SCANS = 16              # synthetic scans in the run loop's catalog
TIMED_SCANS = 32            # and in the catalog of phase 9b's timed epochs
RUN_LOOP_ARGS = ["--preset", "kitti", "--synthetic", str(RUN_SCANS),
                 "--synthetic_points", str(N_POINTS), "--batch_size",
                 str(TRAIN_BATCH), "--set", "contrast.contrast_warmup=1",
                 "--set", "train.val_use_knn=true"]


def run_loop_phase(dev, k2, k3, tmp):
    """Phase 9: train 2 epochs, resume for a third, evaluate the run dir,
    all through the CLIs' main(). The run directory, ``tmp``/run, stays
    for phase 12."""
    import torch

    from coarse3d_tpu_torch.tools import evaluate as evaluate_cli
    from coarse3d_tpu_torch.tools import train as train_cli

    steps = RUN_SCANS // TRAIN_BATCH
    run_dir = os.path.join(tmp, "run")
    ckpt_dir = os.path.join(run_dir, "checkpoint")
    common = RUN_LOOP_ARGS + ["--save_path", run_dir, "--device",
                              dev.type]
    k3.proto_tail.launches = 0
    k2.knn_vote.launches = 0
    trainer = train_cli.main(common + ["--epochs", "2"])
    torch.cuda.synchronize()
    first = {"proto_tail": k3.proto_tail.launches,
             "knn_vote": k2.knn_vote.launches}
    hist = trainer.history
    check([(h["epoch"], h["mode"], h["with_contrast"]) for h in hist]
          == [(0, "Train", False), (0, "Validation", False),
              (1, "Train", True), (1, "Validation", False)],
          f"epochs ran out of order: {hist}")
    check(first["proto_tail"] == steps,
          f"K3 launched {first['proto_tail']} times in a contrast epoch "
          f"of {steps} steps")
    check(first["knn_vote"] == 2 * trainer.val_pipe.steps_per_epoch(),
          f"K2 launched {first['knn_vote']} times in two validation "
          "epochs")
    for h in hist:
        check(all(np.isfinite(v) for v in h["loss"].values())
              and np.isfinite(h["3DIOU"]),
              f"epoch {h['epoch']} {h['mode']}: not finite: {h}")
    check(trainer.state.step == 2 * steps, f"step {trainer.state.step}")
    saved = sorted(os.listdir(ckpt_dir))
    check(saved == ["best_3DAcc.pth", "best_3DIOU.pth", "epoch_0000.pth",
                    "epoch_0001.pth"], f"checkpoints: {saved}")
    want_lr = trainer.state.optimizer.param_groups[0]["lr"]

    resumed = train_cli.main(common + ["--epochs", "3", "--resume"])
    torch.cuda.synchronize()
    check(resumed.resumed is not None and resumed.resumed["epoch"] == 1
          and resumed.resumed["step"] == 2 * steps
          and resumed.resumed["lr"] == want_lr,
          f"resume restored {resumed.resumed}, expected epoch 1, step "
          f"{2 * steps}, lr {want_lr}")
    check([h["epoch"] for h in resumed.history] == [2, 2]
          and resumed.state.step == 3 * steps,
          f"the resumed run ran {resumed.history}")
    check(all(np.isfinite(v) for h in resumed.history
              for v in h["loss"].values()), "resumed run: loss not finite")
    rolling = sorted(f for f in os.listdir(ckpt_dir)
                     if f.startswith("epoch_"))
    check(rolling == ["epoch_0001.pth", "epoch_0002.pth"],
          f"rolling checkpoints after resume: {rolling}")
    last_val = resumed.history[-1]
    cfg = resumed.cfg

    summary = os.path.join(tmp, "summary.json")
    out = evaluate_cli.main([
        "--preset", "kitti", "--synthetic", str(max(RUN_SCANS // 4, 1)),
        "--synthetic_points", str(N_POINTS), "--synthetic_seed",
        str(cfg.train.seed + 1), "--batch_size", str(TRAIN_BATCH),
        "--run_dir", run_dir, "--ckpt", "latest", "--knn",
        "--summary_json", summary, "--device", dev.type])
    with open(summary) as f:
        written = json.load(f)
    check(written["mIoU_3D"] == out["mIoU_3D"], "summary_json differs")
    conf = np.asarray(out["confusion"], dtype=np.int64)
    check(conf.sum() > 0 and np.array_equal(conf, last_val["confusion"]),
          f"evaluate's confusion matrix differs from the Trainer's last "
          f"validation's in {int((conf != last_val['confusion']).sum())} "
          f"cells (mIoU {out['mIoU_3D']} against {last_val['3DIOU']})")
    launches = {"proto_tail": k3.proto_tail.launches,
                "knn_vote": k2.knn_vote.launches}
    print(f"run loop: train 2 epochs x {steps} steps (warmup, contrast) + "
          f"resume 1 epoch + evaluate; launches {launches}; losses "
          f"{[round(h['loss'].get('total', 0.0), 4) for h in hist + resumed.history if h['mode'] == 'Train']}; "
          f"resumed at epoch {resumed.resumed['epoch'] + 1}, step "
          f"{resumed.resumed['step']}, lr {resumed.resumed['lr']:.6g}; "
          f"rolling {rolling}; evaluate's confusion matrix ({int(conf.sum())} "
          f"points, mIoU {out['mIoU_3D']}) == the last validation's (mIoU "
          f"{last_val['3DIOU']:.6f}) count for count")
    return launches


def run_loop_timings(cfg, dev, bare, tag):
    """Phase 9b: what the Trainer adds to the bare step."""
    import torch

    from coarse3d_tpu_torch.configs import apply_overrides
    from coarse3d_tpu_torch.data.pipeline import DataPipeline
    from coarse3d_tpu_torch.data.synthetic import SyntheticDataset
    from coarse3d_tpu_torch.train.trainer import Trainer
    from coarse3d_tpu_torch.utils.profiling import count_calls

    with tempfile.TemporaryDirectory() as tmp:
        cfg = apply_overrides(cfg, ["contrast.contrast_warmup=1"])
        cfg = dataclasses.replace(cfg, save_path=tmp, train=dataclasses.replace(
            cfg.train, n_epochs=2, batch_size_train=TRAIN_BATCH,
            batch_size_val=TRAIN_BATCH))
        ds = SyntheticDataset(TIMED_SCANS, N_POINTS, cfg.data.n_classes,
                              cfg.sensor, seed=cfg.train.seed)
        pipes = [DataPipeline(ds, cfg, TRAIN_BATCH, train=t,
                              seed=cfg.train.seed, pin_memory=True)
                 for t in (True, False)]
        trainer = Trainer(cfg, *pipes, device=dev)
        for epoch, kind in ((0, "warmup"), (1, "contrast")):
            trainer.run_epoch(epoch, "Train")      # warm: scans get cached
            trainer.run_epoch(epoch, "Train")
            t = dict(trainer.last_epoch_timing)
            ms = t["epoch_s"] / t["steps"] * 1e3
            trainer.profile_steps, trainer.profile_epoch = (1, 3), epoch
            trainer.run_epoch(epoch, "Train")
            trainer.profile_steps = None
            calls = trainer.last_profile_syncs
            print(f"timing {tag} Trainer {kind} epoch of {t['steps']} steps "
                  f"B={TRAIN_BATCH}: {ms:.3f} ms/step, {1e3 / ms:.3f} "
                  f"steps/s (bare step {bare[kind + '_ms']:.3f} ms); mean "
                  f"DT {t['data_s'] * 1e3:.3f} ms (first step "
                  f"{t['data_first_s'] * 1e3:.3f} ms, later steps "
                  f"{t['data_later_s'] * 1e3:.3f} ms), mean PT "
                  f"{t['proc_s'] * 1e3:.3f} ms; host waits in 2 steady "
                  f"steps: {count_calls(calls)} synchronisations, "
                  f"{count_calls(calls, ('cudaMemcpyAsync', 'cudaMemcpy'))} "
                  f"copies: {calls}")
        t0 = time.perf_counter()
        trainer.ckpt.save_rolling(trainer.state, 1)
        save_s = time.perf_counter() - t0
        path = os.path.join(trainer.ckpt.root, "epoch_0001.pth")
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        trainer.ckpt.restore(trainer.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        print(f"timing {tag} checkpoint: save {save_s:.3f} s, restore "
              f"{restore_s:.3f} s, {size_mb:.1f} MB")


FAMILIES = {                # name -> model overrides on the kitti preset
    "rangenet21": dict(net_type="rangenet", layers=21),
    "squeezesegv3_21": dict(net_type="squeezesegv3", layers=21),
    "salsanext_s2d_w": dict(net_type="salsanext", stem="s2d_w"),
}
DEEP_FAMILIES = {           # served once, uncalibrated
    "rangenet53": dict(net_type="rangenet", layers=53),
    "squeezesegv3_53": dict(net_type="squeezesegv3", layers=53),
}
FAMILY_REQUESTS = 2
FAMILY_REPS = 5
FAMILY_CONTRAST_STEPS = 2


def family_cfg(cfg, name):
    over = {**FAMILIES, **DEEP_FAMILIES}[name]
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **over))


def serve_family(cfg, dev, host, name, k1, k2, tag):
    """Phase 10, one family: BatchNorm calibrated, FAMILY_REQUESTS batches
    through make_inference_fn, one scan CPU vs card in float32."""
    import torch

    from coarse3d_tpu_torch.eval.inference import make_inference_fn
    from coarse3d_tpu_torch.train.setup import build_model

    fcfg = family_cfg(cfg, name)
    n_classes = fcfg.data.n_classes
    state = calibrated_state(fcfg, host[0][0][:2], host[0][1][:2])
    model = build_model(fcfg, device=dev, seed=0)
    model.load_state_dict(state)
    infer = make_inference_fn(model, fcfg, use_knn=True)
    points = torch.from_numpy(host[0][0]).to(dev)
    valid = torch.from_numpy(host[0][1]).to(dev)
    infer(points, valid)                        # warm-up, not counted
    torch.cuda.synchronize()

    k1.project_scatter.launches = 0
    k2.knn_vote.launches = 0
    labels = [infer(torch.from_numpy(p), torch.from_numpy(v))
              for p, v in host[1:FAMILY_REQUESTS + 1]]
    torch.cuda.synchronize()
    launches = {"proj_scatter_min": k1.project_scatter.launches,
                "knn_vote": k2.knn_vote.launches}
    check(launches == {"proj_scatter_min": FAMILY_REQUESTS,
                       "knn_vote": FAMILY_REQUESTS},
          f"{name}: {FAMILY_REQUESTS} served batches launched {launches}")
    for lab in labels:
        check(lab.shape == (BATCH, fcfg.data.max_points)
              and lab.dtype == torch.int32, f"{name}: labels {lab.shape}")
        check(int(lab.min()) >= 1 and int(lab.max()) <= n_classes - 1,
              f"{name}: labels outside [1, {n_classes - 1}]")
    seen = torch.unique(labels[0]).tolist()
    check(len(seen) > 1, f"{name}: the served label map is constant")

    cfg32 = dataclasses.replace(fcfg, model=dataclasses.replace(
        fcfg.model, compute_dtype="float32"))
    one_p = torch.from_numpy(host[0][0][:1])
    one_v = torch.from_numpy(host[0][1][:1])
    out = {}
    for where in ("cpu", dev):
        m32 = build_model(cfg32, device=where)
        m32.load_state_dict(state)
        out[str(where)] = make_inference_fn(m32, cfg32)(one_p, one_v).cpu()
        del m32
    n_valid = int(one_v.sum())
    agree = float((out["cpu"][0, :n_valid]
                   == out[str(dev)][0, :n_valid]).float().mean())
    check(agree >= 0.99, f"{name}: CPU vs card agreement {agree} < 0.99")

    t_batch = time_ms(lambda: infer(points, valid), reps=FAMILY_REPS)
    torch.cuda.reset_peak_memory_stats()
    infer(points, valid)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if fcfg.model.net_type == "squeezesegv3":
        # what one full-resolution SAC block holds at once: the 3x3 unfold
        # of its 32 channels, the attention map and their product
        sac_gb = BATCH * 9 * 32 * fcfg.sensor.proj_h * fcfg.sensor.proj_w * 2
        print(f"{name}: one full-resolution SAC block holds 3 maps of "
              f"({BATCH}, 288, {fcfg.sensor.proj_h}, {fcfg.sensor.proj_w}) "
              f"bf16, {sac_gb / 1e9:.2f} GB each, {3 * sac_gb / 1e9:.2f} GB "
              f"reckoned; measured peak {peak_gb:.2f} GB")
    print(f"timing {tag} family {name} serving B={BATCH}: {t_batch:.3f} "
          f"ms/batch, {BATCH * 1e3 / t_batch:.2f} scans/s, peak memory "
          f"{peak_gb:.2f} GB; launches {launches}; classes seen {seen}; CPU "
          f"vs card float32 agreement {agree:.6f} on {n_valid} points")
    return launches, model


def serve_deep_family(cfg, dev, host, name, k1, k2, tag):
    """Phase 10, the 53-layer depths: one batch, seeded weights as built."""
    import torch

    from coarse3d_tpu_torch.eval.inference import make_inference_fn
    from coarse3d_tpu_torch.train.setup import build_model

    fcfg = family_cfg(cfg, name)
    infer = make_inference_fn(build_model(fcfg, device=dev, seed=0), fcfg)
    points, valid = (torch.from_numpy(a).to(dev) for a in host[1])
    infer(points, valid)                        # warm-up
    before = (k1.project_scatter.launches, k2.knn_vote.launches)
    torch.cuda.reset_peak_memory_stats()
    t_batch = time_ms(lambda: infer(points, valid), reps=1)
    lab = infer(points, valid)
    torch.cuda.synchronize()
    check(k1.project_scatter.launches > before[0]
          and k2.knn_vote.launches > before[1], f"{name}: no kernel launch")
    check(int(lab.min()) >= 0 and int(lab.max()) <= fcfg.data.n_classes - 1,
          f"{name}: labels out of range")
    print(f"timing {tag} family {name} serving B={BATCH} (one batch, "
          f"uncalibrated weights): {t_batch:.3f} ms/batch, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def train_family(cfg, dev, batch, n_valid, name, k3, tag):
    """Phase 11, one family: a warmup step and FAMILY_CONTRAST_STEPS
    contrast steps at B=TRAIN_BATCH, then their times."""
    import torch

    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import make_train_step

    fcfg = family_cfg(cfg, name)
    state = build_state(fcfg, device=dev, seed=0, steps_per_epoch=100)
    alpha = build_alpha(fcfg)
    warm = make_train_step(fcfg, alpha, with_contrast=False)
    contrast = make_train_step(fcfg, alpha, with_contrast=True)
    k3.proto_tail.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state, m = warm(state, batch)
    metrics = [m]
    for _ in range(FAMILY_CONTRAST_STEPS):
        state, m = contrast(state, batch, SELECT_RATIO)
        metrics.append(m)
    torch.cuda.synchronize()
    launches = k3.proto_tail.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == FAMILY_CONTRAST_STEPS,
          f"{name}: K3 launched {launches} times in "
          f"{FAMILY_CONTRAST_STEPS} contrast steps")
    for i, m in enumerate(metrics):
        losses = {k: float(v) for k, v in m["losses"].items()}
        print(f"{name} step {i}: losses {losses}")
        check(all(np.isfinite(v) for v in losses.values()),
              f"{name} step {i}: a loss is not finite: {losses}")
        check(int(m["confusion"].sum()) == n_valid,
              f"{name} step {i}: confusion count")
    norm_err = float((state.prototypes.norm(dim=-1) - 1).abs().max())
    check(norm_err <= 1e-5, f"{name}: memory rows off unit norm by "
          f"{norm_err}")
    t_con = time_ms(lambda: contrast(state, batch, SELECT_RATIO),
                    reps=FAMILY_REPS)
    t_warm = time_ms(lambda: warm(state, batch), reps=FAMILY_REPS)
    print(f"timing {tag} family {name} training B={TRAIN_BATCH}: contrast "
          f"step {t_con:.3f} ms, warmup step {t_warm:.3f} ms, peak memory "
          f"{peak_gb:.2f} GB (1 warmup + {FAMILY_CONTRAST_STEPS} contrast "
          f"steps); K3 launches {launches}; memory unit norm within "
          f"{norm_err:.1e}")
    return launches, state


def crf_phase(cfg, dev, host, served_model, state, batch, n_valid, run_tmp,
              k2, tag):
    """Phase 12: the CRF and the border mask on the card against the CPU,
    the CRF eval step, and train_crf + evaluate --crf through their CLIs."""
    import torch

    from coarse3d_tpu_torch.ops.projection import (
        build_range_features,
        normalize_features,
        range_project_batch,
    )
    from coarse3d_tpu_torch.postproc import border_mask, crf_refine
    from coarse3d_tpu_torch.postproc.crf import init_compat_kernel
    from coarse3d_tpu_torch.tools import evaluate as evaluate_cli
    from coarse3d_tpu_torch.tools import train_crf as train_crf_cli
    from coarse3d_tpu_torch.train.step import make_eval_step

    n_classes = cfg.data.n_classes
    with torch.inference_mode():
        points = torch.from_numpy(host[1][0]).to(dev)
        valid = torch.from_numpy(host[1][1]).to(dev)
        proj = range_project_batch(points, valid, cfg.sensor)
        mask = proj["proj_idx"] >= 0
        x = normalize_features(build_range_features(
            proj["proj_points"], proj["proj_range"]), mask, cfg.sensor)
        probs = served_model(x.permute(0, 3, 1, 2).contiguous())[
            "probs"].permute(0, 2, 3, 1).contiguous()
        xyz = proj["proj_points"][..., :3].contiguous()
        kernel = init_compat_kernel(n_classes, 0.1)
        got = crf_refine(xyz, probs, mask, kernel.to(dev))
        t0 = time.perf_counter()
        want = crf_refine(xyz.cpu(), probs.cpu(), mask.cpu(), kernel)
        cpu_s = time.perf_counter() - t0
        err = float((got.cpu() - want).abs().max())
        moved = float((got.argmax(-1) != probs.argmax(-1)).float().mean())
        check(bool(torch.isfinite(got).all()), "crf_refine: NaN/inf")
        check(err <= 1e-5, f"crf_refine card vs CPU: {err} > 1e-5")
        t_crf = time_ms(lambda: crf_refine(xyz, probs, mask, kernel.to(dev)),
                        reps=TRAIN_REPS)
        labels = probs.argmax(-1).to(torch.int32)
        # a random network's map is salt and pepper, all border; the same
        # map in 8x32 blocks has interiors too
        blocky = labels[:, ::8, ::32].repeat_interleave(
            8, dim=1).repeat_interleave(32, dim=2)
        for name, lab in (("served", labels), ("blocky", blocky)):
            for kind in ("cross", "square"):
                for size in (1, 3):
                    b_card = border_mask(lab, n_classes, size, kind)
                    b_cpu = border_mask(lab.cpu(), n_classes, size, kind)
                    check(torch.equal(b_card.cpu(), b_cpu),
                          f"border_mask {name} {kind} {size}: card differs "
                          "from CPU")
        border_share = [float(border_mask(lab, n_classes).float().mean())
                        for lab in (labels, blocky)]
        check(0 < border_share[1] < 1, f"blocky border share {border_share}")
    print(f"timing {tag} CRF B={BATCH} {tuple(probs.shape)}: crf_refine "
          f"{t_crf:.3f} ms (3 iterations, 3x5 window); card vs CPU float32 "
          f"max abs err {err:.3e} (CPU run {cpu_s:.1f} s); it moved the "
          f"argmax on {moved:.4f} of pixels; border_mask cross/square x "
          f"1/3 == CPU exactly on the served map ({border_share[0]:.4f} of "
          f"pixels on a border) and on its 8x32-block version "
          f"({border_share[1]:.4f})")

    steps = {"plain": make_eval_step(cfg, use_knn=True),
             "crf": make_eval_step(cfg, use_knn=True, use_crf=True)}
    k2.knn_vote.launches = 0
    ev = steps["crf"](state, batch)
    torch.cuda.synchronize()
    launches = k2.knn_vote.launches
    check(launches == 1, f"the CRF eval step launched K2 {launches} times")
    check(int(ev["confusion"].sum()) == n_valid,
          f"CRF eval step: confusion sums to {int(ev['confusion'].sum())}, "
          f"not {n_valid} valid points")
    t_eval = {k: time_ms(lambda: fn(state, batch), reps=TRAIN_REPS)
              for k, fn in steps.items()}
    print(f"timing {tag} eval step B={TRAIN_BATCH} (KNN): "
          f"{t_eval['plain']:.3f} ms without the CRF, "
          f"{t_eval['crf']:.3f} ms with it; confusion counts {n_valid} "
          "points")

    run_dir = os.path.join(run_tmp, "run")
    out = os.path.join(run_tmp, "crf_kernel.npz")
    data = ["--preset", "kitti", "--synthetic", str(TRAIN_BATCH),
            "--synthetic_points", str(N_POINTS), "--batch_size",
            str(TRAIN_BATCH), "--run_dir", run_dir, "--ckpt", "latest",
            "--device", dev.type]
    t0 = time.perf_counter()
    fit = train_crf_cli.main(data + [
        "--synthetic_task", "bands", "--weak", "0.001", "--epochs", "1",
        "--out", out])
    fit_s = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in fit["history"])
          and bool(np.isfinite(fit["kernel"]).all()), f"train_crf: {fit}")
    init = init_compat_kernel(n_classes, 0.1).numpy()
    drift = float(np.abs(fit["kernel"] - init).max())
    check(drift > 0, "train_crf left the kernel at its init")
    k2.knn_vote.launches = 0
    res = evaluate_cli.main(data + ["--knn", "--crf", "--crf_kernel", out])
    torch.cuda.synchronize()
    cli_launches = k2.knn_vote.launches
    total = int(np.sum(res["confusion"]))
    check(res["crf"] and res["knn"] and cli_launches >= 1
          and total == TRAIN_BATCH * N_POINTS,
          f"evaluate --crf --crf_kernel: {res['mIoU_3D']}, {total} points, "
          f"K2 launches {cli_launches}")
    print(f"CRF CLIs: train_crf 1 epoch on the run dir in {fit_s:.1f} s, "
          f"weak-CE {fit['history']}, kernel moved by {drift:.3e}; evaluate "
          f"--knn --crf --crf_kernel: mIoU {res['mIoU_3D']}, {total} points,"
          f" K2 launches {cli_launches}")
    return launches + cli_launches


MESH_CONTRAST_STEPS = 2     # contrast steps of phases 13-14, after a warmup
MESH_REPS = 5
EVAL_SCANS = 4              # scans of phase 14's evaluate
EVAL_PRESET = "kitti"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_inputs(cfg, thost):
    """The float32 config (TF32 off), B=TRAIN_BATCH host batch and global
    noise that phases 13 and 14 share; dropout stays on (every rank draws
    the global masks and keeps its stripe)."""
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    h, w = cfg.sensor.proj_h, cfg.sensor.proj_w
    c, m, k = (cfg.data.n_classes, cfg.contrast.max_pixels_per_class,
               cfg.contrast.sub_proto_size)
    rng = np.random.default_rng(11)

    def gumbel(shape):
        u = np.maximum(rng.random(shape, dtype=np.float32),
                       np.finfo(np.float32).tiny)
        return -np.log(-np.log(u))

    noise = {"select": gumbel((TRAIN_BATCH * h * w,)),
             "anchor": rng.random((TRAIN_BATCH, c, cfg.contrast.num_anchor),
                                  dtype=np.float32),
             "proto": gumbel((c, m, k))}
    return cfg32, thost, noise


def run_mesh_steps(cfg, dev, host, noise, mesh, rank: int = 0,
                   contrast_steps: int = MESH_CONTRAST_STEPS):
    """One warmup and ``contrast_steps`` contrast steps from build_state's
    seed-0 state on ``rank``'s stripe of the host batch (all of it without
    a mesh); the result after the last, as CPU tensors."""
    import torch

    from coarse3d_tpu_torch.parallel.mesh import replicate_to_mesh
    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import batch_to_device, make_train_step

    world = mesh.world if mesh is not None else 1
    n = TRAIN_BATCH // world
    batch = batch_to_device({k: v[rank * n:(rank + 1) * n]
                             for k, v in host.items()}, dev)
    state = build_state(cfg, device=dev, seed=0, steps_per_epoch=100)
    if mesh is not None:
        replicate_to_mesh(state, mesh)
    alpha = build_alpha(cfg)
    state, first = make_train_step(cfg, alpha, with_contrast=False,
                                   mesh=mesh)(state, batch)
    contrast = make_train_step(cfg, alpha, with_contrast=True, mesh=mesh)
    for _ in range(contrast_steps):
        state, metrics = contrast(state, batch, SELECT_RATIO, noise)
    named = dict(state.model.named_parameters())
    return {
        "first_losses": {k: float(v) for k, v in first["losses"].items()},
        "first_confusion": first["confusion"].cpu(),
        "losses": {k: float(v) for k, v in metrics["losses"].items()},
        "confusion": metrics["confusion"].cpu(),
        "protos": state.prototypes.cpu(),
        "buffers": {k: v.cpu() for k, v in state.model.state_dict().items()
                    if "running" in k},
        "params": {k: p.detach().cpu() for k, p in named.items()},
        "mu": {k: state.optimizer.state[p]["exp_avg"].cpu()
               for k, p in named.items()}}


def compare_steps(got, want) -> dict[str, float]:
    """Largest differences of two step results: the first step's losses
    and the last step's (relative), confusion (points counted
    differently), BatchNorm statistics (relative to each tensor's
    largest), memory (absolute), gradients (Adam's first moment: the worst
    tensor's cosine) and parameters (absolute, where the moment is at
    least 1e-3 of its tensor's largest: below that Adam's step is the sign
    of a rounding)."""
    import torch

    def rel(a, b):
        return max(abs(a[k] - v) / max(abs(v), 1e-12) for k, v in b.items())

    def points(key):
        return int((got[key] - want[key]).abs().sum()) // 2

    out = {
        "first_loss_rel": rel(got["first_losses"], want["first_losses"]),
        "first_confusion_points": points("first_confusion"),
        "loss_rel": rel(got["losses"], want["losses"]),
        "confusion_points": points("confusion"),
        "stats_rel": max(float((got["buffers"][k] - v).abs().max()
                               / v.abs().max().clamp_min(1e-12))
                         for k, v in want["buffers"].items()),
        "memory_abs": float((got["protos"] - want["protos"]).abs().max()),
        "grad_cos": 1.0, "param_abs": 0.0}
    for k, mu in want["mu"].items():
        top = float(mu.abs().max())
        if not top > 1e-6:
            continue                # a gradient that is 0 but for rounding
        g = got["mu"][k]
        out["grad_cos"] = min(out["grad_cos"], float(torch.nn.functional
                                                     .cosine_similarity(
                                                         g.flatten(),
                                                         mu.flatten(), 0)))
        big = mu.abs() >= 1e-3 * top
        out["param_abs"] = max(out["param_abs"], float(
            (got["params"][k] - want["params"][k])[big].abs().max()))
    return out


def nccl_collectives(dev, generator) -> None:
    """Phase 13's collectives over the NCCL group of one, issued for real
    (the step's wrappers skip them at world size 1): the differentiable
    all-reduce and all-gather forward and backward on float32, the
    confusion's int64 all-reduce, a uint8 all-gather (a bool mask's), and
    the broadcast of the step generator's state."""
    import torch
    import torch.distributed as dist

    from coarse3d_tpu_torch.parallel.mesh import _AllGather, _AllReduceSum

    x = torch.linspace(-1.0, 1.0, 257, device=dev).requires_grad_()
    y = _AllReduceSum.apply(x)
    z = _AllGather.apply(x, 0, 1)
    (3.0 * y + 2.0 * z).sum().backward()
    conf = torch.arange(400, dtype=torch.int64, device=dev).view(20, 20)
    summed = conf.clone()
    dist.all_reduce(summed)
    mask = (torch.arange(1000, device=dev) % 3 == 0).to(torch.uint8)
    parts = [torch.empty_like(mask)]
    dist.all_gather(parts, mask)
    gen = generator.get_state().to(dev)
    sent = gen.clone()
    dist.broadcast(sent, src=0)
    torch.cuda.synchronize()
    ok = {"all_reduce": torch.equal(y.detach(), x.detach()),
          "all_gather": torch.equal(z.detach(), x.detach()),
          "backward": torch.equal(x.grad, torch.full_like(x, 5.0)),
          "int64": torch.equal(summed, conf),
          "uint8": torch.equal(parts[0], mask),
          "broadcast": torch.equal(sent, gen)}
    print(f"NCCL collectives over the group of one: {ok}")
    check(all(ok.values()), f"an NCCL collective failed: {ok}")


def bn_profile(step, state, batch, reps: int = 5) -> tuple[float, float]:
    """Mean device ms of one call of step(state, batch) in all kernels and
    in the BatchNorm kernels (names with ``batch_norm`` or ``bn_``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, batch, SELECT_RATIO)
        torch.cuda.synchronize()
    total = bn = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        total += e.device_time_total
        if "batch_norm" in e.key.lower() or "bn_" in e.key.lower():
            bn += e.device_time_total
    check(total > 0, "torch.profiler recorded no device time")
    return total / reps / 1e3, bn / reps / 1e3


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's included), warning where
    an operation has none; uninitialised memory is left as it is."""
    import torch
    import torch.utils.deterministic

    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def world_one_phase(cfg, dev, thost, k3, tag):
    """Phase 13: the data-parallel step over an NCCL group of one, in
    process, at full width: the group's collectives, the step against the
    plain step, K3's launches, and its time beside the plain step's."""
    import torch

    from coarse3d_tpu_torch.parallel import destroy_mesh, make_mesh
    from coarse3d_tpu_torch.parallel.mesh import replicate_to_mesh
    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import batch_to_device, make_train_step

    cfg32, host, noise = mesh_inputs(cfg, thost)
    mesh = make_mesh(dev, init_method=f"tcp://localhost:{_free_port()}",
                     rank=0, world_size=1)
    try:
        check(torch.distributed.get_backend() == "nccl", "not NCCL")
        nccl_collectives(dev, build_state(cfg32, device=dev, seed=0,
                                          steps_per_epoch=100).generator)
        # deterministic algorithms for the comparisons (here and in phase
        # 14's ranks): the default backward convolutions and scatter-adds
        # may sum in another order from run to run, and a random network's
        # later steps make more of that than of any difference between
        # programs
        with deterministic():
            plain = run_mesh_steps(cfg32, dev, host, noise, None)
            k3.proto_tail.launches = 0
            one = run_mesh_steps(cfg32, dev, host, noise, mesh)
            torch.cuda.synchronize()
            launches = k3.proto_tail.launches
            # phase 14's reference: one contrast step
            first = run_mesh_steps(cfg32, dev, host, noise, mesh,
                                   contrast_steps=1)
        diff = compare_steps(one, plain)
        print(f"multi-GPU step over an NCCL group of one, B={TRAIN_BATCH}, "
              f"float32, 1 warmup + {MESH_CONTRAST_STEPS} contrast steps, "
              f"against the plain step: largest differences {diff}; K3 "
              f"launches {launches}")
        check(launches == MESH_CONTRAST_STEPS,
              f"K3 launched {launches} times in {MESH_CONTRAST_STEPS} "
              f"contrast steps over the mesh")
        # the same program (BatchNorm and every loss compute the same
        # statistics over a group of one as without one): the first step
        # equal to rounding, the last within tests/test_torch_parallel.py's
        # tolerances
        check(diff["first_loss_rel"] <= 1e-6
              and diff["first_confusion_points"] == 0,
              f"group of one vs plain, first step: {diff}")
        check(diff["loss_rel"] <= 1e-4 and diff["confusion_points"] == 0
              and diff["stats_rel"] <= 1e-5 and diff["memory_abs"] <= 1e-5
              and diff["grad_cos"] >= 0.999 and diff["param_abs"] <= 1e-5,
              f"group of one vs plain: {diff}")

        # time on the real configuration (bf16 autocast), contrast step,
        # and the BatchNorm kernels' share of its device time
        batch = batch_to_device(host, dev)
        alpha = build_alpha(cfg)
        ms, prof = {}, {}
        for name, m in (("plain", None), ("mesh", mesh)):
            state = build_state(cfg, device=dev, seed=0, steps_per_epoch=100)
            if m is not None:
                replicate_to_mesh(state, m)
            step = make_train_step(cfg, alpha, with_contrast=True, mesh=m)
            ms[name] = time_ms(lambda: step(state, batch, SELECT_RATIO),
                               reps=MESH_REPS)
            prof[name] = bn_profile(step, state, batch)
            del state
        print(f"timing {tag} contrast step B={TRAIN_BATCH} (bf16) over an "
              f"NCCL group of one {ms['mesh']:.3f} ms, plain step "
              f"{ms['plain']:.3f} ms; device time (torch.profiler) "
              + ", ".join(f"{k} {v[0]:.3f} ms of which BatchNorm kernels "
                          f"{v[1]:.3f} ms" for k, v in prof.items()))
    finally:
        destroy_mesh()
    return first, launches, ms


def _rank_worker(rank, port, tmp, eval_argv):
    """Phase 14's rank: the step on its stripe, then tools/evaluate.py
    --multihost over the same gloo group (both ranks on one card)."""
    import torch

    from coarse3d_tpu_torch.ops import knn_vote as k2
    from coarse3d_tpu_torch.ops import proto_update as k3
    from coarse3d_tpu_torch.parallel import make_mesh
    from coarse3d_tpu_torch.tools import evaluate

    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    dev = inputs["device"]
    mesh = make_mesh(dev, "gloo", init_method=f"tcp://localhost:{port}",
                     rank=rank, world_size=2)
    with deterministic():                   # as phase 13's reference
        out = run_mesh_steps(inputs["cfg"], mesh.device, inputs["host"],
                             inputs["noise"], mesh, rank, contrast_steps=1)
    out["proto_launches"] = k3.proto_tail.launches
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    out["evaluate"] = evaluate.main(eval_argv + ["--multihost"])
    out["knn_launches"] = k2.knn_vote.launches
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def two_rank_phase(cfg, dev, thost, one, tag):
    """Phase 14: two ranks spawned on the one card over gloo, B=2 each:
    a warmup and a contrast step equal phase 13's group of one on the
    concatenated batch, and a two-rank evaluate counts as one rank does."""
    import torch
    import torch.multiprocessing as mp

    from coarse3d_tpu_torch.tools import evaluate

    cfg32, host, noise = mesh_inputs(cfg, thost)
    eval_argv = ["--preset", EVAL_PRESET, "--synthetic", str(EVAL_SCANS),
                 "--batch_size", "2", "--knn", "--num_workers", "2",
                 "--device", str(dev)]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"cfg": cfg32, "host": host, "noise": noise,
                    "device": str(dev)}, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        mp.spawn(_rank_worker, args=(_free_port(), tmp, eval_argv),
                 nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    want = evaluate.main(eval_argv)
    launches = {"proto_tail": sum(r["proto_launches"] for r in ranks),
                "knn_vote": sum(r["knn_launches"] for r in ranks)}
    diffs = [compare_steps(r, one) for r in ranks]
    print(f"multi-GPU step over two gloo ranks on one card, B=2 each, "
          f"float32, 1 warmup + 1 contrast step, against the group of one "
          f"on B={TRAIN_BATCH}: largest "
          f"differences {diffs[0]} (rank 0), {diffs[1]} (rank 1); ranks "
          f"spawned and run in {spawn_s:.1f} s; launches {launches}")
    for r in ranks[1:]:
        check(all(torch.equal(v, r["params"][k])
                  for k, v in ranks[0]["params"].items())
              and torch.equal(r["protos"], ranks[0]["protos"]),
              "the two ranks hold different states")
    for d in diffs:
        # the same arithmetic on a split batch: tests/test_torch_parallel.py's
        # tolerances
        check(d["first_loss_rel"] <= 1e-4 and d["loss_rel"] <= 1e-4
              and d["first_confusion_points"] == 0
              and d["confusion_points"] == 0 and d["stats_rel"] <= 1e-5
              and d["memory_abs"] <= 1e-5 and d["grad_cos"] >= 0.999
              and d["param_abs"] <= 1e-5, f"two ranks vs one: {d}")
    check(launches["proto_tail"] == 2,
          f"K3 launches over two ranks: {launches}")
    check(launches["knn_vote"] >= 2, f"K2 launches in evaluate: {launches}")
    got = [r["evaluate"]["confusion"] for r in ranks]
    print(f"evaluate of {EVAL_SCANS} scans over two ranks: confusion "
          f"{'equal' if got[0] == got[1] == want['confusion'] else 'UNEQUAL'}"
          f" to one rank's, {sum(map(sum, want['confusion']))} points")
    check(got[0] == got[1] == want["confusion"],
          "two-rank evaluate does not count as one rank does")
    return launches


ABLATION_SCANS = 8          # phase 15's grid: hard synthetic scans a run
ABLATION_POINTS = 20_000
ABLATION_ARMS = ("full", "nocontrast")
ABLATION_CLASSES = 8        # the tool's --classes default, as the dry run's


def tools_phase(dev, host, run_dir, k1, k2, k3, tmp, tag):
    """Phase 15: the tools ported last and the repo-level entry's analog on
    the card; returns each path's kernel launches and the largest K2 and
    K3 differences from their twins at this phase's shapes."""
    import torch

    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.data.label_maps import get_label_spec
    from coarse3d_tpu_torch.data.synthetic import synthetic_batch
    from coarse3d_tpu_torch.entry import _dryrun_config, dryrun_multichip
    from coarse3d_tpu_torch.entry import entry
    from coarse3d_tpu_torch.ops.projection import range_project_batch
    from coarse3d_tpu_torch.tools import contrast_ablation
    from coarse3d_tpu_torch.tools import convert_torch_ckpt
    from coarse3d_tpu_torch.tools import export_torch_ckpt
    from coarse3d_tpu_torch.tools import infer as infer_cli
    from coarse3d_tpu_torch.tools import visualize
    from coarse3d_tpu_torch.visualizer.vis import colorize_labels, save_ply

    def zero():
        k1.project_scatter.launches = k1.scatter_min.launches = 0
        k2.knn_vote.launches = k3.proto_tail.launches = 0

    def read():
        torch.cuda.synchronize()
        return {"proj_scatter_min": k1.project_scatter.launches
                + k1.scatter_min.launches,
                "knn_vote": k2.knn_vote.launches,
                "proto_tail": k3.proto_tail.launches}

    seconds = {}
    launches = {}

    # K2 and K3 against their twins at the shapes the dry run (16x64, 8
    # classes, the tiny memory) and the ablation (64x2048, 8 classes, the
    # kitti memory) give them; these launches come before the counts are
    # zeroed and do not count
    t0 = time.perf_counter()
    dcfg, kcfg = _dryrun_config(), preset("kitti")
    errs = {"knn_vote": 0.0, "proto_tail": 0.0}
    for name, cc in (("dry run", dcfg.contrast), ("ablation", kcfg.contrast)):
        shape = (ABLATION_CLASSES, cc.max_pixels_per_class,
                 cc.sub_proto_size, cc.proj_dim)
        got = k3_phase(k3, *k3_case(dev, shape=shape), ignore=0, name=name,
                       tag=tag, timed=False)
        errs["proto_tail"] = max(errs["proto_tail"], got["err"])
    dry_host = synthetic_batch(np.random.default_rng(0), dcfg, batch_size=2,
                               n_points=1500, weak_ratio=0.01)
    d = {k: torch.from_numpy(dry_host[k]).to(dev)
         for k in ("features", "point_depth", "point_px", "point_py")}
    errs["knn_vote"] = k2_check(
        k2, d["features"][..., 0], d["point_depth"], d["point_px"],
        d["point_py"], ABLATION_CLASSES, dcfg.knn, "dry run")
    n_val = kcfg.train.batch_size_val
    proj = range_project_batch(
        torch.from_numpy(host[0][0][:n_val]).to(dev),
        torch.from_numpy(host[0][1][:n_val]).to(dev), kcfg.sensor)
    errs["knn_vote"] = max(errs["knn_vote"], k2_check(
        k2, proj["proj_range"], proj["depth"], proj["px"], proj["py"],
        ABLATION_CLASSES, kcfg.knn, "ablation"))
    del d, proj
    seconds["kernels_at_tool_shapes"] = time.perf_counter() - t0

    # the ablation grid: 2 arms x 1 seed x 2 epochs, contrast from epoch 1
    t0 = time.perf_counter()
    zero()
    report = contrast_ablation.main([
        "--arms", *ABLATION_ARMS, "--seeds", "1", "--epochs", "2",
        "--scans", str(ABLATION_SCANS), "--points", str(ABLATION_POINTS),
        "--weak", "0.01", "--num_workers", "2",
        "--work", os.path.join(tmp, "ablation"),
        "--out", os.path.join(tmp, "ablation", "report.json"),
        "--set", "contrast.contrast_warmup=1",
        "--set", "train.val_use_knn=true", "--device", dev.type])
    launches["ablation"] = read()
    seconds["ablation"] = time.perf_counter() - t0
    steps = ABLATION_SCANS // 4                 # kitti's batch_size_train
    val_steps = -(-max(ABLATION_SCANS // 4, 4) // 4)
    runs = report["runs"]
    check([r["arm"] for r in runs] == list(ABLATION_ARMS)
          and all(len(r["series"]) == 2 and np.isfinite(r["series"]).all()
                  for r in runs), f"ablation runs: {runs}")
    check(launches["ablation"]["proto_tail"] == steps,
          f"ablation: K3 launched {launches['ablation']} times; one a "
          f"contrast step of 'full' is {steps}")
    check(launches["ablation"]["knn_vote"] == 2 * 2 * val_steps,
          f"ablation: K2 launched {launches['ablation']}; one a validation "
          f"step is {2 * 2 * val_steps}")
    # the arms share their seed, data, initial memory and warmup epoch;
    # only `full`'s contrast epoch runs K3 and the contrast loss, so the
    # two final checkpoints must differ in memory and in parameters
    ck = {arm: torch.load(
              os.path.join(tmp, "ablation", f"{arm}_s1", "checkpoint",
                           "epoch_0001.pth"),
              map_location="cpu", weights_only=False)
          for arm in ABLATION_ARMS}
    mem_diff = float((ck["full"]["prototypes"]
                      - ck["nocontrast"]["prototypes"]).abs().max())
    par_diff = max(float((v.float() - ck["nocontrast"]["model"][k].float())
                         .abs().max())
                   for k, v in ck["full"]["model"].items())
    check(mem_diff > 0 and par_diff > 0,
          f"ablation: 'full' and 'nocontrast' end with memories {mem_diff} "
          f"and parameters {par_diff} apart; the contrast epoch trained "
          "nothing")
    print(f"contrast_ablation: {len(runs)} runs x 2 epochs, series "
          f"{[r['series'] for r in runs]}; full vs nocontrast at the end: "
          f"memory max abs diff {mem_diff:.3e}, parameters {par_diff:.3e}; "
          f"launches {launches['ablation']}")
    del ck

    # entry(): the kitti forward
    t0 = time.perf_counter()
    fn, (x,) = entry(dev)
    probs = fn(x)
    torch.cuda.synchronize()
    seconds["entry"] = time.perf_counter() - t0
    check(tuple(probs.shape) == (1, 64, 2048, 20)
          and bool(torch.isfinite(probs).all())
          and float((probs.sum(-1) - 1).abs().max()) < 1e-4,
          f"entry(): probs {tuple(probs.shape)} {probs.dtype}")
    print(f"entry(): probs {tuple(probs.shape)} {probs.dtype}")
    del fn, x, probs

    # dryrun_multichip(2): two gloo ranks on the one card
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    dry = dryrun_multichip(2, dev)
    seconds["dryrun_multichip"] = time.perf_counter() - t0
    # the dry run's batch is projected on the host (synthetic_batch), so
    # K1 does not run in it
    launches["dryrun"] = dry["launches"]
    check(dry["backend"] == "gloo"
          and dry["launches"] == {"proj_scatter_min": 0, "knn_vote": 2,
                                  "proto_tail": 4},
          f"dryrun_multichip(2): backend {dry['backend']}, launches "
          f"{dry['launches']} (K1 0, K2 2, K3 4 expected)")

    # export phase 9's run, visualize one scan from the .pth, against
    # infer.py on the same scan; convert the .pth back
    t0 = time.perf_counter()
    pth = os.path.join(tmp, "exported.pth")
    exported, epoch = export_torch_ckpt.main([
        "--run_dir", run_dir, "--preset", "kitti", "--out", pth,
        "--device", dev.type])
    n = int(host[0][1][0].sum())
    scan = os.path.join(tmp, "000000.bin")
    host[0][0][0, :n].tofile(scan)
    zero()
    visualize.main(["--preset", "kitti", "--scan", scan, "--weights", pth,
                    "--knn", "--out", os.path.join(tmp, "vis"),
                    "--device", dev.type])
    launches["visualize"] = read()
    infer_cli.main(["--preset", "kitti", "--weights", pth, "--scans", scan,
                    "--out", os.path.join(tmp, "infer"), "--batch_size", "1",
                    "--train_ids", "--device", dev.type])
    pred = np.fromfile(os.path.join(tmp, "infer", "000000.label"), np.int32)
    spec = get_label_spec("semantic_kitti")
    save_ply(os.path.join(tmp, "infer.ply"), host[0][0][0, :n, :3],
             colorize_labels(pred, spec))
    with open(os.path.join(tmp, "infer.ply"), "rb") as f:
        want = f.read()
    with open(os.path.join(tmp, "vis", "000000_pred.ply"), "rb") as f:
        got = f.read()
    check(launches["visualize"] == {"proj_scatter_min": 1, "knn_vote": 1,
                                    "proto_tail": 0},
          f"visualize: launches {launches['visualize']}")
    check(pred.shape == (n,) and got == want,
          "visualize's predicted labels differ from tools/infer.py's")
    converted = convert_torch_ckpt.main([
        "--pth", pth, "--net", "salsanext",
        "--out", os.path.join(tmp, "converted", "model.pth"),
        "--device", dev.type])
    model_keys = [k for k in exported if k != "prototypes"]
    check(sorted(converted) == sorted(model_keys)
          and all(torch.equal(converted[k], exported[k]) for k in model_keys),
          "convert_torch_ckpt did not give the exported tensors back")
    seconds["export_visualize_convert"] = time.perf_counter() - t0
    print(f"export_torch_ckpt: {len(exported)} tensors, epoch {epoch}; "
          f"visualize --knn of one scan ({n} points, "
          f"{len(np.unique(pred))} classes): labels == tools/infer.py's; "
          f"convert_torch_ckpt round trip: {len(converted)} tensors equal; "
          f"launches {launches['visualize']}")
    print(f"timing {tag} tools phase seconds: "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return launches, errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs on an NVIDIA card", file=sys.stderr)
        return 1

    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.data.label_maps import get_label_spec
    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.eval.inference import make_inference_fn
    from coarse3d_tpu_torch.ops import knn_vote as k2
    from coarse3d_tpu_torch.ops import proj_scatter as k1
    from coarse3d_tpu_torch.ops import proto_update as k3
    from coarse3d_tpu_torch.ops import sac_fused as k4
    from coarse3d_tpu_torch.ops._build import build_all
    from coarse3d_tpu_torch.ops.knn import knn_postprocess, pack_range_image
    from coarse3d_tpu_torch import native
    from coarse3d_tpu_torch.ops.projection import (
        build_range_features,
        normalize_features,
        range_project_batch,
        scatter_inputs,
    )
    from coarse3d_tpu_torch.tools import infer as infer_cli
    from coarse3d_tpu_torch.train.setup import build_model
    from coarse3d_tpu_torch.train.step import batch_to_device

    card = gpu_line()
    print(card)
    dev = resolve_device("cuda")   # also pins TF32 off (device.py)
    tag = f"[{card}]"

    # -- 1. build ----------------------------------------------------------
    phase_s: dict[str, float] = {}
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        torch.cuda.synchronize()
        phase_s[name] = round(time.perf_counter() - t_phase, 1)
        t_phase = time.perf_counter()

    t0 = time.perf_counter()
    libs = [k1.LIBRARY, k2.LIBRARY, k3.LIBRARY, k4.LIBRARY]
    build_all(libs)
    build_s = {lib.name: round(lib.build_s or 0.0, 1) for lib in libs}
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {len(libs)} "
          f"sources at once; each source's nvcc seconds {build_s})")
    for lib in libs:
        for func, regs, spill in ptxas_report(lib.log_path):
            print(f"ptxas {lib.name} {func}: {regs}; {spill}")
            check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
                  f"ptxas: {lib.name} {func} spills: {spill}")
    check(native.available(), "the native host preprocessing library did "
          "not build (g++): the run loop's samples would come from numpy")
    print("host preprocessing: native library built (g++); build_sample "
          "projects through it")
    phase_done("1 build")

    cfg = preset("kitti")
    sensor, knn_cfg, n_classes = cfg.sensor, cfg.knn, cfg.data.n_classes
    hw = sensor.proj_h * sensor.proj_w
    host = make_batches(cfg, N_REQUESTS + 1, seed=0)
    points = torch.from_numpy(host[0][0]).to(dev)
    valid = torch.from_numpy(host[0][1]).to(dev)

    # -- 2. K1 -------------------------------------------------------------
    k1r = k1_phase(k1, points, valid, sensor, tag)
    phase_done("2 K1")

    # -- 3. K2 -------------------------------------------------------------
    proj = range_project_batch(points, valid, sensor)
    gen = torch.Generator(device=dev).manual_seed(1)
    argmax = torch.randint(0, n_classes, proj["proj_range"].shape,
                           generator=gen, device=dev, dtype=torch.int32)
    packed = pack_range_image(proj["proj_range"], argmax)
    prange = proj["depth"]
    pxi, pyi = proj["px"].contiguous(), proj["py"].contiguous()
    kw = dict(n_classes=n_classes, knn=knn_cfg.knn, search=knn_cfg.search,
              sigma=knn_cfg.sigma, cutoff=knn_cfg.cutoff)
    orders = {"random": (prange, pxi, pyi),
              "pixel_sorted": pixel_sorted(prange, pxi, pyi, sensor.proj_w)}
    k2_err, k2_ms_by, k2_plain_by = 0.0, {}, {}
    for order, args in orders.items():
        got = k2.knn_vote(packed, *args, **kw)
        want = k2.knn_vote_reference(packed, *args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 knn_vote ({order} order) "
              f"differs from its twin ({int((got != want).sum())} of "
              f"{got.numel()} points)")
        k2_err = max(k2_err, float((got - want).abs().max()))
        k2_ms_by[order] = time_ms(lambda: k2.knn_vote(packed, *args, **kw))
        k2_plain_by[order] = time_ms(
            lambda: k2.knn_vote_reference(packed, *args, **kw))
    k2_ms, k2_plain = k2_ms_by["random"], k2_plain_by["random"]
    k2_bytes = nbytes(packed, prange, pxi, pyi, got)
    # float32 operations per point: |dr| * g + 1 on every tap (3), the
    # selection's compares (knn * (S*S - 1)) and the cutoff test (2 a pick)
    s2 = knn_cfg.search ** 2
    k2_ops = prange.numel() * (3 * s2 + knn_cfg.knn * (s2 - 1)
                               + 2 * knn_cfg.knn)
    k2_bytes_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_ops_ms = k2_ops / FP32_OPS_PER_S * 1e3
    k2_bound = max(k2_bytes_ms, k2_ops_ms)
    k2_by = "bytes" if k2_bytes_ms >= k2_ops_ms else "operations"
    print(f"K2 knn_vote B={BATCH} P={prange.shape[1]} C={n_classes} "
          f"k={knn_cfg.knn} S={knn_cfg.search}: kernel == twin exactly in "
          f"{' and '.join(orders)} order")
    del proj, packed, got, want, orders
    phase_done("3 K2")

    # -- 3b. K3 ------------------------------------------------------------
    k3_dense = k3_phase(k3, *k3_case(dev), ignore=0, name="dense", tag=tag)
    phase_done("3b K3 dense")

    # -- 3c. K4 ------------------------------------------------------------
    k4_rows, k4_launches = k4_phase(k4, dev, host, tag)
    phase_done("3c K4")

    # -- 4. the serving path -------------------------------------------------
    state = calibrated_state(cfg, host[0][0][:2], host[0][1][:2])
    model = build_model(cfg, device=dev, seed=0)
    model.load_state_dict(state)
    infer = make_inference_fn(model, cfg, use_knn=True)
    infer(points, valid)               # warm-up (cuDNN plans), not counted
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        scan_dir = os.path.join(tmp, "scans")
        os.makedirs(scan_dir)
        n_bin = min(4, BATCH)
        counts = []
        for i in range(n_bin):
            n = int(host[0][1][i].sum())
            host[0][0][i, :n].tofile(os.path.join(scan_dir, f"{i:06d}.bin"))
            counts.append(n)
        weights = os.path.join(tmp, "model.pth")
        torch.save(model.state_dict(), weights)

        k1.scatter_min.launches = 0
        k1.project_scatter.launches = 0
        k2.knn_vote.launches = 0
        labels = [infer(torch.from_numpy(p), torch.from_numpy(v))
                  for p, v in host[1:N_REQUESTS + 1]]
        infer_cli.main(["--preset", "kitti", "--weights", weights,
                        "--scan_dir", scan_dir, "--out",
                        os.path.join(tmp, "preds"), "--batch_size", "2",
                        "--device", dev.type])
        torch.cuda.synchronize()
        # K1's two wrappers launch the same kernel; the served path goes
        # through the fused one, and only that one counts for it
        launches = {"proj_scatter_min": k1.project_scatter.launches,
                    "knn_vote": k2.knn_vote.launches}
        check(k1.scatter_min.launches == 0,
              "the serving path called scatter_min beside project_scatter")
        print(f"main path: {N_REQUESTS} batches of {BATCH} scans + "
              f"tools/infer.py on {n_bin} .bin scans; launches {launches}")
        check(all(n > 0 for n in launches.values()),
              f"a kernel of the path never launched: {launches}")

        raw_ids = set(get_label_spec("semantic_kitti").lut_inv[1:].tolist())
        for i, n in enumerate(counts):
            pred = np.fromfile(os.path.join(tmp, "preds", f"{i:06d}.label"),
                               dtype=np.int32)
            check(pred.shape == (n,), f"infer.py wrote {pred.shape} for {n}")
            check(set(np.unique(pred).tolist()) <= raw_ids,
                  "infer.py wrote ids outside the KITTI raw-id map")
    for lab in labels:
        check(lab.shape == (BATCH, cfg.data.max_points)
              and lab.dtype == torch.int32, f"labels {lab.shape} {lab.dtype}")
        check(int(lab.min()) >= 1 and int(lab.max()) <= n_classes - 1,
              f"labels outside [1, {n_classes - 1}]")
    seen = torch.unique(labels[0]).tolist()
    print(f"labels in [1, {n_classes - 1}]; classes seen in batch 1: {seen}")
    check(len(seen) > 1, "the served label map is constant")

    # float32 path on the CPU vs the card, one scan
    cfg32 = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    one_p, one_v = host[0][0][:1], host[0][1][:1]
    cpu_model = build_model(cfg32, device="cpu")
    cpu_model.load_state_dict(state)
    card_model = build_model(cfg32, device=dev)
    card_model.load_state_dict(state)
    t0 = time.perf_counter()
    cpu = make_inference_fn(cpu_model, cfg32)(
        torch.from_numpy(one_p), torch.from_numpy(one_v))
    cpu_s = time.perf_counter() - t0
    card32 = make_inference_fn(card_model, cfg32)(
        torch.from_numpy(one_p), torch.from_numpy(one_v)).cpu()
    n_valid = int(one_v.sum())
    agree = float((cpu[0, :n_valid] == card32[0, :n_valid]).float().mean())
    print(f"CPU vs card float32 (TF32 off), one scan of {n_valid} points: "
          f"label agreement {agree:.6f} (CPU run {cpu_s:.1f} s); classes "
          f"seen {torch.unique(cpu[0, :n_valid]).tolist()}")
    check(agree >= 0.99, f"CPU vs card agreement {agree} < 0.99")
    phase_done("4 serving path")

    # -- 5. timings ----------------------------------------------------------
    with torch.inference_mode():
        proj = range_project_batch(points, valid, sensor)
        mask = proj["proj_idx"] >= 0

        def features():
            feats = build_range_features(proj["proj_points"],
                                         proj["proj_range"])
            x = normalize_features(feats, mask, sensor)
            return x.permute(0, 3, 1, 2).contiguous()

        x = features()
        am = torch.argmax(model(x)["logits"], dim=1).to(torch.int32)
        t_proj = time_ms(lambda: range_project_batch(points, valid, sensor))
        t_coord = time_ms(lambda: scatter_inputs(points, valid, sensor))
        t_feat = time_ms(features)
        t_fwd = time_ms(lambda: model(x)["logits"])
        t_knn = time_ms(lambda: knn_postprocess(
            proj["proj_range"], proj["depth"], am, proj["px"], proj["py"],
            n_classes=n_classes, knn=knn_cfg.knn, search=knn_cfg.search,
            sigma=knn_cfg.sigma, cutoff=knn_cfg.cutoff))
        t_batch = time_ms(lambda: infer(points, valid), reps=10)
    torch.cuda.reset_peak_memory_stats()
    infer(points, valid)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in (
        f"K1 scatter_min: kernel {k1r['ms']:.4f} ms, twin "
        f"{k1r['plain']:.4f} ms, bound "
        f"{k1r['bound']:.4f} ms ({k1r['bytes'] / 1e6:.1f} MB at 3.35 TB/s); "
        "library: none (no single PyTorch call computes it)",
        f"K1 project_scatter (fused projection): kernel "
        f"{k1r['fused_ms']:.4f} ms, twin {k1r['fused_plain']:.4f} ms, bound "
        f"{k1r['fused_bound']:.4f} ms ({k1r['fused_bytes'] / 1e6:.1f} MB at "
        "3.35 TB/s); library: none",
        f"K2 knn_vote, random order: kernel {k2_ms:.4f} ms, twin "
        f"{k2_plain:.4f} ms; pixel-sorted order: kernel "
        f"{k2_ms_by['pixel_sorted']:.4f} ms, twin "
        f"{k2_plain_by['pixel_sorted']:.4f} ms; "
        f"bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.1f} MB at 3.35 TB/s: "
        f"{k2_bytes_ms:.4f} ms; {k2_ops / 1e9:.3f} G float32 ops at 67 "
        f"TFLOP/s: {k2_ops_ms:.4f} ms); "
        "library: none (no single PyTorch call computes it)",
        f"projection B={BATCH}: {t_proj:.3f} ms = coordinate math "
        f"(scatter_inputs) {t_coord:.3f} ms + K1 project_scatter "
        f"{k1r['fused_ms']:.3f} ms + rest (allocation, views) "
        f"{t_proj - t_coord - k1r['fused_ms']:.3f} ms",
        f"stages B={BATCH}: projection {t_proj:.3f} ms, features "
        f"{t_feat:.3f} ms, SalsaNext bf16 forward {t_fwd:.3f} ms, KNN "
        f"{t_knn:.3f} ms",
        f"end to end B={BATCH} (device-resident scans): {t_batch:.3f} "
        f"ms/batch, {BATCH * 1e3 / t_batch:.2f} scans/s, peak memory "
        f"{peak_gb:.2f} GB",
        f"K3 proto_tail, dense ({k3_dense['rows']} valid rows): kernel "
        f"{k3_dense['ms']:.4f} ms, twin {k3_dense['plain']:.4f} ms, bound "
        f"{k3_dense['bound']:.4f} ms ({k3_dense['ops'] / 1e9:.3f} G float32 "
        f"ops at 67 TFLOP/s: {k3_dense['ops_ms']:.4f} ms; "
        f"{k3_dense['bytes'] / 1e6:.1f} MB at 3.35 TB/s: "
        f"{k3_dense['bytes_ms']:.4f} ms); library: none (no single PyTorch "
        "call computes it)",
    ):
        print(f"timing {tag} {line}")

    phase_done("5 serving timings")

    # -- 6-8. the training path ----------------------------------------------
    state, tbatch, thost, train_launches = train_phase(cfg, dev)
    phase_done("6 training path")
    k3_train = k3_phase(k3, *k3_training_case(cfg, dev, state, tbatch),
                        ignore=cfg.train.ignore_cls, name="training batch",
                        tag=tag)
    print(f"timing {tag} K3 proto_tail, training batch "
          f"({k3_train['rows']} valid rows): kernel {k3_train['ms']:.4f} ms, "
          f"twin {k3_train['plain']:.4f} ms, bound {k3_train['bound']:.4f} ms"
          f" ({k3_train['by']})")
    phase_done("6b K3 training batch")
    train_cpu_vs_card(cfg, dev, thost)
    phase_done("7 training CPU vs card")
    bare = train_timings(cfg, dev, state, tbatch, tag)
    phase_done("8 training timings")
    del state, tbatch

    with tempfile.TemporaryDirectory() as run_tmp:
        # -- 9. the run loop ------------------------------------------------
        loop_launches = run_loop_phase(dev, k2, k3, run_tmp)
        phase_done("9 run loop (CLIs)")
        run_loop_timings(cfg, dev, bare, tag)
        phase_done("9b run loop timings")

        # -- 10. the other families, serving --------------------------------
        family_serving = {"proj_scatter_min": 0, "knn_vote": 0}
        for name in FAMILIES:
            got, served_model = serve_family(cfg, dev, host, name, k1, k2,
                                             tag)
            for key, n in got.items():
                family_serving[key] += n
        for name in DEEP_FAMILIES:
            serve_deep_family(cfg, dev, host, name, k1, k2, tag)
        phase_done("10 families, serving")

        # -- 11. the other families, training -------------------------------
        tbatch = batch_to_device(thost, dev)
        n_valid = int(thost["point_valid"].sum())
        family_training = 0
        for name in ("rangenet21", "squeezesegv3_21"):
            got, fstate = train_family(cfg, dev, tbatch, n_valid, name, k3,
                                       tag)
            family_training += got
        phase_done("11 families, training")

        # -- 12. the CRF and the border mask --------------------------------
        # the served s2d_w SalsaNext gives the softmax, the trained
        # SqueezeSegV3 state runs the eval step
        crf_launches = crf_phase(cfg, dev, host, served_model, fstate, tbatch,
                                 n_valid, run_tmp, k2, tag)
        phase_done("12 CRF and border mask")
        del served_model, fstate, tbatch

        # -- 13-14. data parallelism -----------------------------------------
        one, mesh_launches, _ = world_one_phase(cfg, dev, thost, k3, tag)
        phase_done("13 multi-GPU, NCCL group of one")
        two_launches = two_rank_phase(cfg, dev, thost, one, tag)
        phase_done("14 multi-GPU, two gloo ranks")

        # -- 15. the tools ----------------------------------------------------
        torch.cuda.empty_cache()
        tool_launches, tool_errs = tools_phase(
            dev, host, os.path.join(run_tmp, "run"), k1, k2, k3, run_tmp,
            tag)
        phase_done("15 tools")
    print(f"timing {tag} wall seconds per phase: {phase_s}")

    kernels = [
        {"name": "proj_scatter_min", "route": "cuda",
         "source": "coarse3d_tpu_torch/csrc/proj_scatter.cu",
         "replaces": "coarse3d_tpu/ops/pallas/proj_scatter.py:57",
         # the headline fields are those of the entry the served path
         # launches (project_scatter); scatter_min's own stand beside them
         "entry": "project_scatter",
         "launches": launches["proj_scatter_min"],
         "launches_by_path": {
             "serving": launches["proj_scatter_min"],
             "families_serving": family_serving["proj_scatter_min"],
             **{f"tools_{path}": n["proj_scatter_min"]
                for path, n in tool_launches.items()}},
         "max_abs_err": k1r["err"],
         "ms": k1r["fused_ms"], "plain_ms": k1r["fused_plain"],
         "bound_ms": k1r["fused_bound"], "bound_by": "bytes",
         "library_ms": None,
         "scatter_min": {"launches": 0, "ms": k1r["ms"],
                         "plain_ms": k1r["plain"], "bound_ms": k1r["bound"]},
         "launch_us": k1r["profile_us"]},
        {"name": "knn_vote", "route": "cuda",
         "source": "coarse3d_tpu_torch/csrc/knn_vote.cu",
         "replaces": "coarse3d_tpu/ops/pallas/knn_vote.py:34",
         "launches": launches["knn_vote"],
         "launches_by_path": {"serving": launches["knn_vote"],
                              "training": train_launches["knn_vote"],
                              "run_loop": loop_launches["knn_vote"],
                              "families_serving": family_serving["knn_vote"],
                              "crf_eval": crf_launches,
                              "multi_gpu": two_launches["knn_vote"],
                              **{f"tools_{path}": n["knn_vote"]
                                 for path, n in tool_launches.items()}},
         "max_abs_err": max(k2_err, tool_errs["knn_vote"]),
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None,
         "ms_by_order": k2_ms_by, "plain_ms_by_order": k2_plain_by},
        {"name": "proto_tail", "route": "cuda",
         "source": "coarse3d_tpu_torch/csrc/proto_update.cu",
         "replaces": "coarse3d_tpu/ops/pallas/proto_update.py:40",
         "launches": train_launches["proto_tail"],
         "launches_by_path": {"training": train_launches["proto_tail"],
                              "run_loop": loop_launches["proto_tail"],
                              "families_training": family_training,
                              "multi_gpu": (mesh_launches
                                            + two_launches["proto_tail"]),
                              **{f"tools_{path}": n["proto_tail"]
                                 for path, n in tool_launches.items()}},
         "max_abs_err": max(k3_dense["err"], k3_train["err"],
                            tool_errs["proto_tail"]),
         "ms": k3_dense["ms"], "plain_ms": k3_dense["plain"],
         "bound_ms": k3_dense["bound"], "bound_by": k3_dense["by"],
         "library_ms": None,
         "ms_by_size": {"dense": k3_dense["ms"],
                        "training": k3_train["ms"]},
         "plain_ms_by_size": {"dense": k3_dense["plain"],
                              "training": k3_train["plain"]},
         "bound_ms_by_size": {"dense": k3_dense["bound"],
                              "training": k3_train["bound"]},
         "valid_rows_by_size": {"dense": k3_dense["rows"],
                                "training": k3_train["rows"]},
         "pass_ms_by_size": {"dense": k3_dense["passes"],
                             "training": k3_train["passes"]}},
        {"name": "sac_fused", "route": "cuda",
         "source": "coarse3d_tpu_torch/csrc/sac_fused.cu",
         "replaces": None,     # the JAX SAC block is plain XLA
         "launches": k4_launches["serving_squeezesegv3_21"],
         "launches_by_path": k4_launches,
         "max_abs_err": max(r["abs_err"] for r in k4_rows),
         "ms": sum(r["ms"] for r in k4_rows),
         "plain_ms": sum(r["plain"] for r in k4_rows),
         "bound_ms": sum(r["bound"] for r in k4_rows),
         "bound_by": "bf16 operations",
         "library_ms": sum(r["library"] for r in k4_rows),
         "by_block": k4_rows, "build_s": build_s},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
