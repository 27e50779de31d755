"""Multi-seed contrast-machinery ablation grid on the hard synthetic task.

Port of the JAX package's ``tools/contrast_ablation.py``: the same arms,
flags, report and ``--merge`` path, the runs on the port's ``Trainer`` on
``--device`` (the card by default). On a task whose classes the range convs
canNOT separate from geometry (``data/synthetic.py:synthetic_hard_scan``:
texture-frequency classes, identical depth/elevation marginals), run the
REAL recipe and ablate each contrast component:

  full        - the shipped default (contrast + entropy selection +
                prototype EMA; reference mechanism trainer.py:654-690 +
                contrast_pixel_loss.py:8-195)
  nocontrast  - loss_w_contrast=0 (warmup losses only)
  noentropy   - entropy_selection=false (anchors from weak labels only)
  noproto     - use_prototype=false (frozen random prototypes, the
                reference's shipped default)
  minimal     - both ablations composed
  s2d, s2d_w  - the space-to-depth stems with the full mechanism
  staggered   - entropy selection joins 20 epochs after the contrast
                warmup (contrast.selection_warmup=25)

All arms and seeds run in one process, one after another; each run's state
is freed (and the card's cache emptied) before the next. Emits a JSON report
(per-run series, per-arm mean+-std and medians of best and last-5-epoch-mean
val mIoU, escape epochs, paired per-seed deltas against ``nocontrast``)
whose schema is the JAX tool's.

Batch: ``train.batch_size_train`` scans per process. With ``--multihost``
(one process per card under ``torchrun``, as ``tools/train.py
--multihost``) the global batch is that times the number of processes and
only rank 0 writes the report; without it the world is one process.

EMA-timescale caveat: proto_momentum=0.999 is an EMA time-constant of 1000
steps, tuned for the reference's ~230k-step KITTI schedule; on a short
synthetic schedule the memory never leaves its random init and ``full``
degenerates into ``noproto``. For prototype-EMA arms pass
``--set contrast.proto_momentum=<m>`` with m ~= 1 - 1/(0.5*steps_per_epoch).

  python -m coarse3d_tpu_torch.tools.contrast_ablation \
      --out runs/ablation.json --seeds 1 2 3 --epochs 24 --scans 64 \
      --points 120000 --weak 0.001
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

ARMS = {
    "full": [],
    "nocontrast": ["contrast.loss_w_contrast=0"],
    "noentropy": ["contrast.entropy_selection=false"],
    "noproto": ["contrast.use_prototype=false"],
    "minimal": ["contrast.use_prototype=false",
                "contrast.entropy_selection=false"],
    # the space-to-depth stem with the FULL contrast mechanism: pairs s2d
    # against `full` on the same seeds/data, so the faster stem's accuracy
    # question is settled by the same grid
    "s2d": ["model.stem=s2d"],
    # width-only 1x2 space-to-depth (full H, half W): keeps the row
    # resolution the task's stripes live in while still halving the
    # activation traffic
    "s2d_w": ["model.stem=s2d_w"],
    # staggered composition (the balanced grid's interaction hypothesis
    # in the JAX package's record, PERF_TPU.md): prototype EMA forms on
    # clean weak-only anchors for 20
    # epochs after contrast_warmup, THEN entropy selection joins — if the
    # full-stack null comes from prototypes absorbing selection noise while
    # the memory forms, this arm should recover both single-ablation gains.
    # The epoch value assumes the 45-epoch grid protocol (contrast from 5).
    "staggered": ["contrast.selection_warmup=25"],
}


def run_one(arm: str, seed: int, args, device, mesh=None) -> dict:
    """One arm at one seed: ``args.epochs`` of training and validation on
    ``device`` (with ``mesh``, this rank's stripe of every global batch)."""
    import gc

    import numpy as np
    import torch

    from coarse3d_tpu_torch.configs import apply_overrides, preset
    from coarse3d_tpu_torch.data.pipeline import DataPipeline
    from coarse3d_tpu_torch.data.synthetic import SyntheticHardDataset
    from coarse3d_tpu_torch.train.trainer import Trainer
    from coarse3d_tpu_torch.utils import Recorder

    cfg = preset("semantic_kitti")
    n = args.classes
    cfg = apply_overrides(cfg, [
        f"data.n_classes={n}",
        "data.cls_counts=[0" + ",100" * (n - 1) + "]",
        f"train.seed={seed}",
        f"train.n_epochs={args.epochs}",
    ] + ARMS[arm] + args.set)

    ds_kw = dict(weak_ratio=args.weak, n_segments=args.segments,
                 modes_per_class=args.modes, noise=args.noise,
                 weak_label_noise=args.label_noise,
                 imbalance=args.imbalance)
    # the task (scene layout + weak subset) is seed-matched across arms:
    # data seed = run seed, so arm comparisons at one seed share the data
    train_ds = SyntheticHardDataset(args.scans, args.points, n, cfg.sensor,
                                    seed=seed, **ds_kw)
    val_ds = SyntheticHardDataset(max(args.scans // 4, 4), args.points, n,
                                  cfg.sensor, seed=seed + 1000, **ds_kw)

    save = os.path.join(args.work, f"{arm}_s{seed}")
    cfg = dataclasses.replace(cfg, save_path=save)
    rank, world = (mesh.rank, mesh.world) if mesh else (0, 1)
    recorder = Recorder(save, settings=cfg, use_tensorboard=False,
                        enabled=rank == 0)
    # batch_size_train scans per process, as tools/train.py: the global
    # batch is that times the processes, so the ablation runs the batch (BN
    # and contrast statistics) of the recipe it ablates on any number of
    # cards; each process reads its stripe of the catalog
    pipe_kw = dict(process_index=rank, process_count=world,
                   pin_memory=device.type == "cuda")
    train_pipe = DataPipeline(train_ds, cfg, cfg.train.batch_size_train,
                              train=True, seed=seed,
                              num_workers=args.num_workers, **pipe_kw)
    val_pipe = DataPipeline(val_ds, cfg, cfg.train.batch_size_val,
                            train=False, seed=seed,
                            num_workers=args.num_workers, **pipe_kw)
    if rank == 0:
        print(f"[{arm} s{seed}] global batch "
              f"{cfg.train.batch_size_train * world} over {world} "
              f"process(es) on {device}", flush=True)
    trainer = Trainer(cfg, train_pipe, val_pipe, recorder=recorder,
                      device=device, mesh=mesh)
    series = []
    class_series = []
    for epoch in range(cfg.train.n_epochs):
        trainer.run_epoch(epoch, "Train")
        res = trainer.run_epoch(epoch, "Validation")
        series.append(round(float(res["3DIOU"]), 4))
        class_series.append(res["class_IOU"])
        if rank == 0:
            print(f"[{arm} s{seed}] epoch {epoch + 1}/{cfg.train.n_epochs} "
                  f"val mIoU {series[-1]:.4f}", flush=True)
    # final checkpoint: lets evaluate --run_dir re-score the trained model
    trainer.ckpt.save_rolling(trainer.state, cfg.train.n_epochs - 1)
    trainer.ckpt.close()
    recorder.close()
    # multi-run hygiene: free this run's state and cached scans before the
    # next run builds its own
    del trainer
    for d in (train_ds, val_ds):
        if d._cache is not None:
            d._cache.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # rare-class evidence for the imbalanced task: per-class IoU means over
    # the last 5 epochs (the steady-state the paired deltas compare)
    last5_class = [round(float(v), 4)
                   for v in np.mean(np.asarray(class_series[-5:]), axis=0)]
    return {"arm": arm, "seed": seed, "series": series,
            "best": max(series), "last5": float(np.mean(series[-5:])),
            "last5_class_iou": last5_class}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--merge", nargs="+", metavar="REPORT.json",
                   help="merge per-seed/per-arm reports (runs concatenated, "
                        "summary recomputed) into --out instead of training; "
                        "grids split over processes or calls produce these")
    p.add_argument("--merge_exempt", nargs="+", default=[], metavar="KEY",
                   help="config keys additionally exempted from the --merge "
                        "config-match check. Only for parts PROVABLY "
                        "comparable despite the differing key — e.g. 'set' "
                        "when the only override is contrast.proto_momentum "
                        "and every merged arm in the momentum-less parts is "
                        "momentum-independent (nocontrast/noproto/minimal "
                        "never run the EMA update). The "
                        "exemption is recorded in the merged report's "
                        "config for the reader to audit.")
    p.add_argument("--arms", nargs="+", default=list(ARMS),
                   choices=list(ARMS))
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--scans", type=int, default=64)
    p.add_argument("--points", type=int, default=120000)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--weak", type=float, default=0.001)
    p.add_argument("--segments", type=int, default=6)
    p.add_argument("--modes", type=int, default=2)
    p.add_argument("--noise", type=float, default=0.15)
    p.add_argument("--label_noise", type=float, default=0.0)
    p.add_argument("--imbalance", type=float, default=0.0,
                   help="geometric class point-share skew (max/min ratio); "
                        "uniform weak sampling then starves rare classes of "
                        "CE signal — the real-data transfer channel the "
                        "balanced task lacks (data/synthetic.py). 0 = "
                        "balanced 1D-Voronoi sectors.")
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--work", default=os.path.join(
        tempfile.gettempdir(), "contrast_ablation"))
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "contrast_ablation", "report.json"))
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--multihost", action="store_true",
                   help="one process per card under torchrun: each run "
                        "data-parallel over the global batch (NCCL on "
                        "cards, gloo with --device cpu); rank 0 writes the "
                        "report")
    args = p.parse_args(argv)

    if args.merge:
        # per-part grid configs must agree on everything that defines the
        # task/recipe; invocation bookkeeping keys are exempt. A mismatch
        # would silently merge non-comparable runs into one summary.
        exempt = {"merge", "merge_exempt", "arms", "seeds", "out", "work",
                  "num_workers"} | set(args.merge_exempt)
        runs, seen, part_cfgs, ref_cfg = [], set(), {}, None
        for path in args.merge:
            with open(path) as f:
                part = json.load(f)
            cfg = {k: v for k, v in part.get("config", {}).items()
                   if k not in exempt}
            part_cfgs[path] = part.get("config", {})
            if ref_cfg is None:
                ref_cfg = cfg
            elif cfg != ref_cfg:
                diff = {k: (ref_cfg.get(k), cfg.get(k))
                        for k in set(ref_cfg) | set(cfg)
                        if ref_cfg.get(k) != cfg.get(k)}
                raise SystemExit(
                    f"--merge: grid config of {path} differs from "
                    f"{args.merge[0]}: {diff}")
            for r in part["runs"]:
                key = (r["arm"], r["seed"])
                if key in seen:
                    raise SystemExit(
                        f"--merge: duplicate run {key} in {path}")
                seen.add(key)
                runs.append(r)
        arm_order = list(ARMS)
        runs.sort(key=lambda r: (
            r["seed"],
            arm_order.index(r["arm"]) if r["arm"] in arm_order
            else len(arm_order), r["arm"]))
        # the merged report's config is the VALIDATED part config (first
        # part's grid args) + the merge bookkeeping — recording the merge
        # invocation's mostly-default args here would misstate the task and
        # corrupt config-match checks on any future re-merge
        merged_cfg = dict(part_cfgs[args.merge[0]])
        merged_cfg["merge"] = args.merge
        merged_cfg["merge_exempt"] = args.merge_exempt
        merged_cfg["out"] = args.out
        report = _write(args, runs, source_configs=part_cfgs,
                        config=merged_cfg)
        print(json.dumps(report["summary"], indent=2))
        return report

    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.parallel import destroy_mesh, make_mesh

    mesh = make_mesh(args.device) if args.multihost else None
    device = mesh.device if mesh else resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    try:
        runs = []
        for seed in args.seeds:
            for arm in args.arms:
                runs.append(run_one(arm, seed, args, device, mesh))
                if main_rank:
                    _write(args, runs)
    finally:
        if mesh is not None:
            destroy_mesh()
    report = _write(args, runs) if main_rank else None
    if main_rank:
        print(json.dumps(report["summary"], indent=2))
    return report


def _sign_flip_perm_p(deltas, max_exact=20):
    """Exact two-sided sign-flip permutation p-value of the mean delta.

    Enumerates all 2^n sign assignments (n <= max_exact; the grids run <= 8
    seeds) and returns the fraction whose |mean| >= the observed |mean|.
    n=1 degenerates to p=1.0, as it should.
    """
    import itertools

    import numpy as np

    d = np.asarray(deltas, dtype=np.float64)
    n = len(d)
    if n == 0 or n > max_exact:
        return None
    obs = abs(d.mean())
    signs = np.array(list(itertools.product((1.0, -1.0), repeat=n)))
    perm = np.abs(signs @ d) / n
    # 1e-12 tolerance: the observed assignment itself must always count
    return float(np.mean(perm >= obs - 1e-12))


# The hard task is bimodal: a run either stalls on a low plateau or escapes
# well above it (an optimization cliff, in the JAX package's record,
# PERF_TPU.md). Escape timing, not steady-state quality, dominates several
# paired deltas, so the report records it explicitly.
ESCAPE_MIOU = 0.15


def _escape_epoch(series):
    """First epoch whose val mIoU clears the plateau; None = never escaped."""
    return next((i for i, v in enumerate(series) if v > ESCAPE_MIOU), None)


def _write(args, runs, source_configs=None, config=None):
    import numpy as np

    summary = {}
    for r in runs:
        r["escape_epoch"] = _escape_epoch(r["series"])
    arms_present = [a for a in ARMS if any(r["arm"] == a for r in runs)]
    for arm in arms_present:
        rows = [r for r in runs if r["arm"] == arm]
        esc = [r["escape_epoch"] for r in rows]
        summary[arm] = {
            "escape_epochs": esc,
            "escape_median": (float(np.median([e for e in esc
                                               if e is not None]))
                              if any(e is not None for e in esc) else None),
            "n": len(rows),
            "best_mean": float(np.mean([r["best"] for r in rows])),
            "best_std": float(np.std([r["best"] for r in rows])),
            # the hard task's optimization cliff makes per-seed outcomes
            # bimodal (escape or stall); medians
            # resist the outlier seeds that dominate mean+-std
            "best_median": float(np.median([r["best"] for r in rows])),
            "last5_mean": float(np.mean([r["last5"] for r in rows])),
            "last5_std": float(np.std([r["last5"] for r in rows])),
            "last5_median": float(np.median([r["last5"] for r in rows])),
        }
    # Paired per-seed deltas vs the warmup-only baseline: arms at one seed
    # share the scene layout, weak subset, AND model init (both keyed on the
    # run seed), so the seed-matched delta cancels the breakthrough-timing
    # variance that dominates the raw per-arm std.
    paired = {}
    # every arm pairs against the warmup-only baseline; s2d and staggered
    # also pair against `full` — their promotion questions are relative to
    # the shipped composition ("does s2d cost accuracy vs parity stem";
    # "does staggering the selection beat activating both at once")
    vs_full = [a for a in ("s2d", "s2d_w", "staggered") if a in arms_present]
    baselines = ["nocontrast"] + (["full"] if vs_full else [])
    for base_arm in baselines:
        base = {r["seed"]: r for r in runs if r["arm"] == base_arm}
        arms_vs = (arms_present if base_arm == "nocontrast" else vs_full)
        for arm in arms_vs:
            if arm == base_arm:
                continue
            pairs = [(r, base[r["seed"]]) for r in runs
                     if r["arm"] == arm and r["seed"] in base]
            if not pairs:
                continue
            d_best = [r["best"] - b["best"] for r, b in pairs]
            d_last5 = [r["last5"] - b["last5"] for r, b in pairs]
            # per-class paired deltas (rare-class resolution on the
            # imbalanced task); older reports lack last5_class_iou
            d_class = None
            if all("last5_class_iou" in r and "last5_class_iou" in b
                   and len(r["last5_class_iou"]) == len(b["last5_class_iou"])
                   for r, b in pairs):
                dc = np.asarray([
                    np.subtract(r["last5_class_iou"], b["last5_class_iou"])
                    for r, b in pairs])
                d_class = {
                    "mean": [round(float(v), 4) for v in dc.mean(axis=0)],
                    "median": [round(float(v), 4)
                               for v in np.median(dc, axis=0)],
                }
            # escape-timing deltas (epochs; positive = the arm escaped
            # LATER than the baseline); None when either run never escaped
            d_esc = [r["escape_epoch"] - b["escape_epoch"]
                     if r["escape_epoch"] is not None
                     and b["escape_epoch"] is not None else None
                     for r, b in pairs]
            paired[f"{arm}-{base_arm}"] = {
                "n": len(pairs),
                "seeds": [r["seed"] for r, _ in pairs],
                "escape_delta": d_esc,
                "best_delta": [round(d, 4) for d in d_best],
                "best_delta_mean": float(np.mean(d_best)),
                "best_delta_std": float(np.std(d_best)),
                "best_delta_median": float(np.median(d_best)),
                # sign-test counts (|delta| <= 1 pt is a tie): nonparametric
                # evidence direction when the cliff makes deltas heavy-tailed
                "best_wins": int(sum(d > 0.01 for d in d_best)),
                "best_losses": int(sum(d < -0.01 for d in d_best)),
                # exact two-sided sign-flip permutation p of the mean paired
                # delta: under H0 (arm == baseline) each seed's delta is
                # sign-symmetric, so all 2^n sign assignments are equally
                # likely — the correct small-n test when the cliff makes
                # deltas heavy-tailed and t-test normality fails
                "best_perm_p": _sign_flip_perm_p(d_best),
                "last5_delta_mean": float(np.mean(d_last5)),
                "last5_delta_std": float(np.std(d_last5)),
                "last5_delta_median": float(np.median(d_last5)),
                "last5_perm_p": _sign_flip_perm_p(d_last5),
            }
            if d_class is not None:
                paired[f"{arm}-{base_arm}"]["last5_class_delta"] = d_class
    report = {"config": config or {k: v for k, v in vars(args).items()},
              "runs": runs, "summary": summary, "paired": paired}
    if source_configs:
        report["source_configs"] = source_configs
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    # atomic publish: a crash (OOM kill, VM restart) mid-dump must not leave
    # a truncated-but-non-empty artifact that a resumable driver's existence
    # check would skip forever and a later --merge would crash on
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp, args.out)
    return report


if __name__ == "__main__":
    main()
