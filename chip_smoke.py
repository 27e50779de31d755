#!/usr/bin/env python3
"""Smoke run of the PyTorch port (coarse3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. builds the port's CUDA kernels from csrc/ with nvcc (all at once);
2. K1 (projection scatter-min) at KITTI size (B=16 scans of 120k points
   padded to 150k, 64x2048 images), kernel vs its plain twin: exact;
3. K2 (KNN vote) on the same projection, 20 classes: kernel vs twin: exact;
3b. K3 (prototype Sinkhorn/EMA tail) at KITTI training shapes (C=20,
   M=2048, K=20, D=256; an empty ignore class, one more empty class, one
   full class, random counts elsewhere), kernel vs twin: max abs error
   <= 2e-5 at momentum 0.999; >= 0.95 of the (C, K) rows within 1e-4 at
   momentum 0 (a rare argmax flip moves a whole row); no NaN; the empty
   classes keep l2(memory);
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
7. one float32 contrast step on one scan, CPU vs card (TF32 off, dropout
   0, same state, batch and noise): focal and Lovász within 1e-3
   relative, contrast within 1e-2 (an anchor draw may fall on the other
   side of a CDF boundary), the memory after the step within 1e-4;
8. training timings (CUDA events, median of 10 after warm-up): the
   contrast and warmup steps, their stages, peak memory.

It prints the card's name and power limit (nvidia-smi), one line per timing
tagged with them, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX; the port's
JAX reference is only named, in the ``replaces`` fields.
"""

from __future__ import annotations

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
        elif isinstance(mod, torch.nn.Dropout2d):
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


def k3_case(dev, seed: int = 3):
    """Seeded K3 inputs at KITTI training shapes: normal rows, a l2-normed
    memory, Gumbel noise; class 0 (ignore) and class 1 empty, class 2 full,
    random valid counts elsewhere (valid rows are a prefix, as the class
    gather gives them)."""
    import torch

    c, m, k, d = 20, 2048, 20, 256
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
        probs = model(x, return_feat=True)["probs"].permute(0, 2, 3, 1)
        loss = (focal_softmax_loss(probs, label, alpha_t, wss)
                + lovasz_softmax_loss(probs, label, ignore=ignore,
                                      budget=cfg.train.lovasz_budget))
        loss.backward()

    with torch.no_grad():
        out = model(x, return_feat=True)
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
    from coarse3d_tpu_torch.ops._build import build_all
    from coarse3d_tpu_torch.ops.knn import knn_postprocess, pack_range_image
    from coarse3d_tpu_torch.ops.projection import (
        build_range_features,
        normalize_features,
        range_project_batch,
        scatter_inputs,
    )
    from coarse3d_tpu_torch.tools import infer as infer_cli
    from coarse3d_tpu_torch.train.setup import build_model

    card = gpu_line()
    print(card)
    dev = resolve_device("cuda")   # also pins TF32 off (device.py)
    tag = f"[{card}]"

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build_all([k1.LIBRARY, k2.LIBRARY, k3.LIBRARY])
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, three sources "
          "at once)")
    for lib in (k1.LIBRARY, k2.LIBRARY, k3.LIBRARY):
        if os.path.exists(lib.log_path):
            with open(lib.log_path) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        print(f"ptxas {lib.name}: {line.strip()}")

    cfg = preset("kitti")
    sensor, knn_cfg, n_classes = cfg.sensor, cfg.knn, cfg.data.n_classes
    hw = sensor.proj_h * sensor.proj_w
    host = make_batches(cfg, N_REQUESTS + 1, seed=0)
    points = torch.from_numpy(host[0][0]).to(dev)
    valid = torch.from_numpy(host[0][1]).to(dev)

    # -- 2. K1 -------------------------------------------------------------
    flat, depth, _, _ = scatter_inputs(points, valid, sensor)
    got_d, got_w = k1.scatter_min(flat, depth, hw)
    want_d, want_w = k1.scatter_min_reference(flat, depth, hw)
    torch.cuda.synchronize()
    check(torch.equal(got_d, want_d) and torch.equal(got_w, want_w),
          "K1 scatter_min differs from its twin")
    k1_err = float((got_d - want_d).abs().max())
    hit_rate = float((got_w < flat.shape[1]).float().mean())
    k1_ms = time_ms(lambda: k1.scatter_min(flat, depth, hw))
    k1_plain = time_ms(lambda: k1.scatter_min_reference(flat, depth, hw))
    # K1 does no float arithmetic: one 64-bit atomic per point, one decode
    # per pixel, so bytes bound it
    k1_bytes = nbytes(flat, depth, got_d, got_w)
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    print(f"K1 proj_scatter_min B={BATCH} P={flat.shape[1]} hw={hw}: "
          f"kernel == twin exactly; {hit_rate:.4f} of pixels hit")

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
    got = k2.knn_vote(packed, prange, pxi, pyi, **kw)
    want = k2.knn_vote_reference(packed, prange, pxi, pyi, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K2 knn_vote differs from its twin "
          f"({int((got != want).sum())} of {got.numel()} points)")
    k2_err = float((got - want).abs().max())
    k2_ms = time_ms(lambda: k2.knn_vote(packed, prange, pxi, pyi, **kw))
    k2_plain = time_ms(
        lambda: k2.knn_vote_reference(packed, prange, pxi, pyi, **kw))
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
          f"k={knn_cfg.knn} S={knn_cfg.search}: kernel == twin exactly")
    del proj, packed, got, want

    # -- 3b. K3 ------------------------------------------------------------
    feat3, valid3, protos3, gumbel3 = k3_case(dev)
    kw3 = dict(momentum=0.999, ignore_cls=0)
    got = k3.proto_tail(feat3, valid3, protos3, gumbel3, **kw3)
    want = k3.proto_tail_reference(feat3, valid3, protos3, gumbel3, **kw3)
    torch.cuda.synchronize()
    k3_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "K3 output holds NaN/inf")
    check(k3_err <= 2e-5, f"K3 vs twin at momentum 0.999: {k3_err} > 2e-5")
    l2_mem = protos3 / protos3.norm(dim=-1, keepdim=True)
    empty_err = float((got[:2] - l2_mem[:2]).abs().max())
    check(empty_err <= 1e-6, f"K3 empty/ignore classes moved: {empty_err}")
    got0 = k3.proto_tail(feat3, valid3, protos3, gumbel3, momentum=0.0,
                         ignore_cls=0)
    want0 = k3.proto_tail_reference(feat3, valid3, protos3, gumbel3,
                                    momentum=0.0, ignore_cls=0)
    torch.cuda.synchronize()
    row_err = (got0 - want0).abs().amax(dim=-1)                # (C, K)
    rows_out = int((row_err > 1e-4).sum())
    check(bool(torch.isfinite(got0).all()), "K3 output holds NaN/inf (m=0)")
    check(rows_out <= 0.05 * row_err.numel(),
          f"K3 vs twin at momentum 0: {rows_out} of {row_err.numel()} rows "
          "off by > 1e-4")
    n3 = int(valid3.sum())
    c3, m3, d3 = feat3.shape
    kk3 = protos3.shape[1]
    print(f"K3 proto_tail C={c3} M={m3} K={kk3} D={d3}, {n3} valid rows: "
          f"momentum 0.999 max abs err {k3_err:.3e}; momentum 0 max abs err "
          f"{float(row_err.max()):.3e}, {rows_out} of {row_err.numel()} rows "
          f"off by > 1e-4; empty classes err {empty_err:.1e}")
    k3_ms = time_ms(lambda: k3.proto_tail(feat3, valid3, protos3, gumbel3,
                                          **kw3))
    k3_plain = time_ms(lambda: k3.proto_tail_reference(
        feat3, valid3, protos3, gumbel3, **kw3))
    # float32 work this run's valid rows need: LayerNorm + l2 aside, the
    # similarity to all C*K prototypes, the own-class block, and one add
    # of each contributing row into its sub-prototype
    k3_ops = 2 * n3 * c3 * kk3 * d3 + 2 * n3 * kk3 * d3 + n3 * d3
    k3_bytes = (4 * n3 * (d3 + kk3) + valid3.numel()
                + 2 * protos3.numel() * 4)
    k3_ops_ms = k3_ops / FP32_OPS_PER_S * 1e3
    k3_bytes_ms = k3_bytes / HBM_BYTES_PER_S * 1e3
    k3_bound = max(k3_ops_ms, k3_bytes_ms)
    k3_by = "operations" if k3_ops_ms >= k3_bytes_ms else "bytes"
    del feat3, valid3, protos3, gumbel3, got, want, got0, want0

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
        k2.knn_vote.launches = 0
        labels = [infer(torch.from_numpy(p), torch.from_numpy(v))
                  for p, v in host[1:N_REQUESTS + 1]]
        infer_cli.main(["--preset", "kitti", "--weights", weights,
                        "--scan_dir", scan_dir, "--out",
                        os.path.join(tmp, "preds"), "--batch_size", "2",
                        "--device", dev.type])
        torch.cuda.synchronize()
        launches = {"proj_scatter_min": k1.scatter_min.launches,
                    "knn_vote": k2.knn_vote.launches}
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
        f"K1 proj_scatter_min: kernel {k1_ms:.4f} ms, twin {k1_plain:.4f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_bytes / 1e6:.1f} MB at 3.35 TB/s); "
        "library: none (no single PyTorch call computes it)",
        f"K2 knn_vote: kernel {k2_ms:.4f} ms, twin {k2_plain:.4f} ms, "
        f"bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.1f} MB at 3.35 TB/s: "
        f"{k2_bytes_ms:.4f} ms; {k2_ops / 1e9:.3f} G float32 ops at 67 "
        f"TFLOP/s: {k2_ops_ms:.4f} ms); "
        "library: none (no single PyTorch call computes it)",
        f"stages B={BATCH}: projection {t_proj:.3f} ms, features "
        f"{t_feat:.3f} ms, SalsaNext bf16 forward {t_fwd:.3f} ms, KNN "
        f"{t_knn:.3f} ms",
        f"end to end B={BATCH} (device-resident scans): {t_batch:.3f} "
        f"ms/batch, {BATCH * 1e3 / t_batch:.2f} scans/s, peak memory "
        f"{peak_gb:.2f} GB",
        f"K3 proto_tail: kernel {k3_ms:.4f} ms, twin {k3_plain:.4f} ms, "
        f"bound {k3_bound:.4f} ms ({k3_ops / 1e9:.3f} G float32 ops at 67 "
        f"TFLOP/s: {k3_ops_ms:.4f} ms; {k3_bytes / 1e6:.1f} MB at 3.35 TB/s: "
        f"{k3_bytes_ms:.4f} ms); library: none (no single PyTorch call "
        "computes it)",
    ):
        print(f"timing {tag} {line}")

    # -- 6-8. the training path ----------------------------------------------
    state, tbatch, thost, train_launches = train_phase(cfg, dev)
    train_cpu_vs_card(cfg, dev, thost)
    train_timings(cfg, dev, state, tbatch, tag)

    kernels = [
        {"name": "proj_scatter_min", "route": "cuda",
         "source": "coarse3d_tpu_torch/csrc/proj_scatter.cu",
         "replaces": "coarse3d_tpu/ops/pallas/proj_scatter.py:57",
         "launches": launches["proj_scatter_min"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "knn_vote", "route": "cuda",
         "source": "coarse3d_tpu_torch/csrc/knn_vote.cu",
         "replaces": "coarse3d_tpu/ops/pallas/knn_vote.py:34",
         "launches": launches["knn_vote"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "proto_tail", "route": "cuda",
         "source": "coarse3d_tpu_torch/csrc/proto_update.cu",
         "replaces": "coarse3d_tpu/ops/pallas/proto_update.py:40",
         "launches": train_launches["proto_tail"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
