"""Standalone evaluation CLI: checkpoint -> val-set 3D mIoU (+ optional KNN).

Port of the JAX package's ``tools/evaluate.py``. Covers BASELINE config #1
(released-checkpoint inference) end to end:

  python -m coarse3d_tpu_torch.tools.evaluate --preset semantic_kitti \
      --pcd_root $KITTI/sequences --weights best_3DIOU_model.pth --knn

``--weights`` is a reference-named ``.pth`` state dict. Also accepts run
dirs produced by tools/train.py (--run_dir), and --synthetic for smoke
runs. Runs on the card unless ``--device cpu`` is given. ``--crf`` is not
ported yet and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config")
    p.add_argument("--preset", default="semantic_kitti")
    p.add_argument("--pcd_root")
    p.add_argument("--weights", help="reference-named .pth state dict")
    p.add_argument("--run_dir", help="training run dir (tools/train.py)")
    p.add_argument("--ckpt", default="latest",
                   help="which --run_dir checkpoint to restore: 'latest' "
                        "(rolling) or a best-metric key like 'best_3DIOU' "
                        "(the published BASELINE numbers are "
                        "best-checkpoint numbers)")
    p.add_argument("--knn", action="store_true",
                   help="apply KNN range post-processing")
    p.add_argument("--crf", action="store_true",
                   help="EXPERIMENTAL: refine the 2D softmax with the "
                        "locally-connected xyz CRF before argmax. The "
                        "reference ships but never wires or trains this "
                        "module; the default compatibility kernel is "
                        "untrained — measured mIoU effect is recorded in "
                        "PARITY.md (CRF entry) before relying on it")
    p.add_argument("--crf_kernel", metavar="NPZ",
                   help="trained compatibility kernel from "
                        "tools/train_crf.py (implies --crf semantics only "
                        "when --crf is also passed)")
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic_task", choices=("bands", "hard"),
                   default="bands",
                   help="synthetic label structure (match the training "
                        "task; see data/synthetic.py)")
    p.add_argument("--synthetic_points", type=int, default=0,
                   help="points per synthetic scan (default: half of "
                        "data.max_points, capped at 20000)")
    p.add_argument("--synthetic_seed", type=int, default=0,
                   help="synthetic catalog seed (train.py uses seed+1 for "
                        "its val split)")
    p.add_argument("--synthetic_segments", type=int, default=None,
                   help="hard task: yaw sectors per scan")
    p.add_argument("--synthetic_modes", type=int, default=None,
                   help="hard task: texture modes per class")
    p.add_argument("--synthetic_noise", type=float, default=None,
                   help="hard task: per-point intensity noise sigma "
                        "(match the training task's --synthetic_noise)")
    p.add_argument("--synthetic_imbalance", type=float, default=None,
                   help="hard task: geometric class point-share skew "
                        "(match the training task's --synthetic_imbalance)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, e.g. --set knn.search=7 "
                        "(values parsed as YAML; repeatable)")
    p.add_argument("--save_preds", metavar="DIR",
                   help="write per-scan predictions in the benchmark "
                        "submission layout: sequences/NN/predictions/"
                        "FFFFFF.label uint32 raw ids (KITTI/POSS) or "
                        "lidarseg/<split>/<token>_lidarseg.bin uint8 "
                        "(nuScenes) — see eval/submission.py")
    p.add_argument("--split", default="val",
                   help="split name stamped into the nuScenes submission "
                        "tree (val/test)")
    p.add_argument("--summary_json", metavar="PATH",
                   help="also write the JSON summary to this file "
                        "(robust seam for wrapping programs)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    args = p.parse_args(argv)

    # pure-argument validation up front, before any dataset/model setup
    # (on real data that setup costs minutes)
    if args.weights and (args.run_dir or args.ckpt != "latest"):
        # --weights would silently shadow the run-dir selection and the user
        # could unknowingly score those weights instead of best_3DIOU
        raise SystemExit(
            "--weights is mutually exclusive with --run_dir/--ckpt: pass "
            "exactly one checkpoint source")
    if args.crf_kernel and not args.crf:
        # without this the kernel is loaded but never applied, and the
        # reported mIoU would be silently attributed to the trained CRF
        raise SystemExit("--crf_kernel requires --crf")
    if args.crf:
        raise NotImplementedError(
            "--crf / --crf_kernel are not ported yet (ROADMAP.md Queue 1 "
            "item 16)")

    import numpy as np

    from coarse3d_tpu_torch.configs import apply_overrides, load_config, preset
    from coarse3d_tpu_torch.data.pipeline import DataPipeline
    from coarse3d_tpu_torch.data.pipeline import BATCH_KEYS
    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.metrics.iou import ConfusionState
    from coarse3d_tpu_torch.train.setup import build_state
    from coarse3d_tpu_torch.train.step import batch_to_device, make_eval_step

    device = resolve_device(args.device)

    cfg = load_config(args.config) if args.config else preset(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    over = {}
    if args.pcd_root:
        over["pcd_root"] = args.pcd_root
    if over:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, **over))

    if args.synthetic:
        from coarse3d_tpu_torch.data.synthetic import (SyntheticDataset,
                                                 SyntheticHardDataset,
                                                 hard_task_kwargs)

        ds_cls = (SyntheticHardDataset if args.synthetic_task == "hard"
                  else SyntheticDataset)
        n_pts = args.synthetic_points or min(20000, cfg.data.max_points // 2)
        ds_kw = {}
        if args.synthetic_task == "hard":
            ds_kw.update(hard_task_kwargs(args))
        # cache=False: evaluate is a single pass, every scan read once
        ds = ds_cls(args.synthetic, n_pts, cfg.data.n_classes, cfg.sensor,
                    seed=args.synthetic_seed, cache=False, **ds_kw)
    else:
        from coarse3d_tpu_torch.data.datasets import build_dataset

        ds = build_dataset(cfg, "val")

    bs = args.batch_size or cfg.train.batch_size_val
    pipe = DataPipeline(ds, cfg, bs, train=False,
                        num_workers=args.num_workers,
                        pin_memory=device.type == "cuda")
    state = build_state(cfg, device=device, seed=0, steps_per_epoch=1)

    if args.weights:
        from coarse3d_tpu_torch.tools.convert_jax_params import (
            load_reference_state_dict,
        )

        state.model.load_state_dict(
            load_reference_state_dict(args.weights), strict=True)
    elif args.run_dir:
        from coarse3d_tpu_torch.train.checkpoint import restore_from_run_dir

        state = restore_from_run_dir(state, args.run_dir, args.ckpt)

    eval_step = make_eval_step(cfg, use_knn=args.knn,
                               return_point_pred=bool(args.save_preds))
    evaluator = ConfusionState(cfg.data.n_classes,
                               ignore=(cfg.train.ignore_cls,))
    if args.save_preds:
        from coarse3d_tpu_torch.eval.submission import SubmissionWriter

        # synthetic catalogs carry no label spec; reuse the preset's real
        # spec when the class count matches (so the benchmark-layout seam
        # can be drilled end to end on synthetic runs), else fall back to
        # the writer's flat train-id layout rather than asserting deep in
        # the eval loop
        dataset_kind = cfg.data.dataset
        spec = getattr(ds, "label_spec", None)
        if spec is None:
            from coarse3d_tpu_torch.data.label_maps import get_label_spec

            try:
                spec = get_label_spec(cfg.data.dataset)
            except KeyError:
                spec = None
            if spec is not None and spec.n_classes != cfg.data.n_classes:
                print(f"note: {cfg.data.dataset} label spec has "
                      f"{spec.n_classes} classes but this run has "
                      f"{cfg.data.n_classes}; writing flat train-id files "
                      f"instead of the benchmark tree")
                spec = None
            if spec is None:
                dataset_kind = getattr(ds, "name", "synthetic")
        writer = SubmissionWriter(
            args.save_preds, dataset_kind, label_spec=spec,
            split=args.split)
    for i, host_batch in enumerate(pipe.epoch(0)):
        batch = batch_to_device(
            {k: host_batch[k] for k in BATCH_KEYS}, device)
        out = eval_step(state, batch)
        evaluator.add(out["confusion"])
        if args.save_preds:
            preds = out["point_pred"].cpu().numpy()
            valids = host_batch["point_valid"]
            # scan ids are stamped into the batch by the pipeline, so this
            # is order-independent (correct under multi-process striping) and
            # skips eval-tail padding samples (scan_index == -1)
            for bidx, scan_index in enumerate(host_batch["scan_index"]):
                if scan_index < 0:
                    continue
                seq_id, frame_id = ds.path_info(int(scan_index))
                writer.write(seq_id, frame_id, preds[bidx][valids[bidx]])
        if i % 20 == 0:
            print(f"batch {i + 1}/{pipe.steps_per_epoch()}")
    if args.save_preds:
        writer.finalize()

    mean_iou, class_iou = evaluator.iou()
    mean_acc, _ = evaluator.acc()
    names = getattr(getattr(ds, "label_spec", None), "class_names",
                    [str(i) for i in range(cfg.data.n_classes)])
    class_iou = class_iou.numpy()
    for c, iou in enumerate(class_iou):
        if c != cfg.train.ignore_cls:
            print(f"  class {c:02d} {names[c]:20s} IoU {float(iou):.4f}")
    results = {
        "mIoU_3D": round(float(mean_iou), 4),
        "mAcc_3D": round(float(mean_acc), 4),
        "knn": bool(args.knn),
        "crf": bool(args.crf),
        "scans": len(ds),
    }
    print(json.dumps(results))
    results["class_iou"] = class_iou.tolist()
    # the exact counts behind the rounded figures (rows = predictions)
    results["confusion"] = evaluator.conf.tolist()
    if args.summary_json:
        # machine-readable seam for wrapping programs: parsing the merged
        # stdout/stderr tail is corruptible by late library warnings, a
        # file is not
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
