"""Scan inference CLI: raw .bin scans -> .label files, on the card.

Port of the JAX package's ``tools/infer.py``. Runs the device pipeline
(projection -> SalsaNext -> optional KNN; ``eval/inference.py``) over bare
scan files and writes SemanticKITTI benchmark-format raw-id .label files
(int32 per point), no labels or dataset layout needed.

  python -m coarse3d_tpu_torch.tools.infer --weights model.pth \
      --preset semantic_kitti --scans 000000.bin 000001.bin --out preds/

``--weights`` is a reference-named ``.pth`` state dict: the reference's own
checkpoints, or ``torch.save(model.state_dict())`` of the port;
``--run_dir`` / ``--ckpt`` take a checkpoint of ``tools/train.py`` instead.
``--submission`` writes the benchmark upload tree (``eval/submission.py``).
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config")
    p.add_argument("--preset", default="semantic_kitti")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="reference-named .pth state dict")
    src.add_argument("--run_dir", help="training run dir (tools/train.py)")
    p.add_argument("--ckpt", default="latest",
                   help="which --run_dir checkpoint to restore: 'latest' "
                        "(rolling) or a best-metric key like 'best_3DIOU'")
    p.add_argument("--scans", nargs="+", default=[], help=".bin scan files")
    p.add_argument("--scan_dir", help="directory of .bin scans")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--no_knn", action="store_true",
                   help="skip the KNN range cleanup")
    p.add_argument("--train_ids", action="store_true",
                   help="write train ids (0..C-1) instead of raw dataset "
                        "ids via the inverse learning map")
    p.add_argument("--submission", action="store_true",
                   help="write the benchmark submission tree under --out "
                        "(sequences/NN/predictions/FFFFFF.label for "
                        "KITTI/POSS, NN taken from the scan's "
                        "sequences/NN/velodyne/ path; "
                        "lidarseg/<split>/<token>_lidarseg.bin for nuScenes, "
                        "token = scan file stem) instead of flat files")
    p.add_argument("--split", default="val",
                   help="nuScenes submission split name (with --submission)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE")
    args = p.parse_args(argv)

    if args.weights and args.ckpt != "latest":
        # mirrors evaluate.py: --ckpt only selects within --run_dir
        raise SystemExit("--ckpt requires --run_dir, not --weights")

    import numpy as np
    import torch

    from coarse3d_tpu_torch.configs import apply_overrides, load_config, preset
    from coarse3d_tpu_torch.data.label_maps import get_label_spec
    from coarse3d_tpu_torch.data.readers import (
        read_kitti_scan,
        read_nuscenes_scan,
    )
    from coarse3d_tpu_torch.data.synthetic import pad_points
    from coarse3d_tpu_torch.eval.inference import make_inference_fn
    from coarse3d_tpu_torch.tools.convert_jax_params import (
        load_reference_state_dict,
    )
    from coarse3d_tpu_torch.train.setup import build_model

    cfg = load_config(args.config) if args.config else preset(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    paths = list(args.scans)
    if args.scan_dir:
        paths += sorted(
            os.path.join(args.scan_dir, f)
            for f in os.listdir(args.scan_dir) if f.endswith(".bin"))
    if not paths:
        raise SystemExit("no scans given (--scans / --scan_dir)")

    if args.weights:
        model = build_model(cfg, device=args.device)
        model.load_state_dict(load_reference_state_dict(args.weights),
                              strict=True)
    else:
        from coarse3d_tpu_torch.train.checkpoint import restore_from_run_dir
        from coarse3d_tpu_torch.train.setup import build_state

        state = build_state(cfg, device=args.device, steps_per_epoch=1)
        model = restore_from_run_dir(state, args.run_dir,
                                     args.ckpt).model.eval()
    infer = make_inference_fn(model, cfg, use_knn=not args.no_knn)
    read_scan = (read_nuscenes_scan if cfg.data.dataset == "nuscenes"
                 else read_kitti_scan)
    spec = None
    if not args.train_ids:
        try:
            spec = get_label_spec(cfg.data.dataset)
        except KeyError:
            print(f"WARNING: dataset {cfg.data.dataset!r} has no raw-id "
                  "label map; writing train ids (as if --train_ids were "
                  "passed)", file=sys.stderr)

    # output names: scan basename, disambiguated by the parent directory
    # when basenames collide (e.g. frame 000001.bin from two sequences)
    def stem(path):
        return os.path.splitext(os.path.basename(path))[0]

    writer = None
    if args.submission:
        from coarse3d_tpu_torch.eval.submission import SubmissionWriter

        if args.train_ids and cfg.data.dataset in ("semantic_kitti",
                                                   "semantic_poss"):
            raise SystemExit("--submission writes raw ids; drop --train_ids")

        def seq_of(path):
            # .../sequences/NN/velodyne/FFFFFF.bin -> NN; nuScenes tokens
            # are the file stem (path_info convention: ("nusc", token))
            if cfg.data.dataset == "nuscenes":
                return "nusc"
            parts = os.path.abspath(path).split(os.sep)
            if len(parts) >= 3 and parts[-2] == "velodyne":
                return parts[-3]
            raise SystemExit(
                f"--submission needs scans under sequences/NN/velodyne/, "
                f"got {path}")

        writer = SubmissionWriter(args.out, cfg.data.dataset,
                                  label_spec=spec, split=args.split)
        out_names = {q: (seq_of(q), stem(q)) for q in paths}
    else:
        names = [stem(q) for q in paths]
        if len(set(names)) < len(names):
            names = [
                f"{os.path.basename(os.path.dirname(os.path.abspath(q)))}"
                f"_{stem(q)}" for q in paths]
            if len(set(names)) < len(names):
                raise SystemExit(
                    "output filenames collide even with parent-directory "
                    "prefixes; pass scans from distinct directories or "
                    "rename")
        out_names = {q: n + ".label" for q, n in zip(paths, names)}

    os.makedirs(args.out, exist_ok=True)
    bs = args.batch_size
    for start in range(0, len(paths), bs):
        chunk = paths[start:start + bs]
        pts, msk, counts = [], [], []
        for path in chunk:
            scan = read_scan(path)
            counts.append(scan.shape[0])
            pp, vv = pad_points(scan, cfg.data.max_points, fill=0.0)
            pts.append(pp)
            msk.append(vv)
        labels = infer(torch.from_numpy(np.stack(pts)),
                       torch.from_numpy(np.stack(msk))).cpu().numpy()
        for j, path in enumerate(chunk):
            pred = labels[j, :counts[j]].astype(np.int32)
            if writer is not None:
                seq_id, frame_id = out_names[path]
                writer.write(seq_id, frame_id, pred)  # unmaps internally
            else:
                if spec is not None:
                    pred = spec.unmap_labels(pred).astype(np.int32)
                pred.tofile(os.path.join(args.out, out_names[path]))
        print(f"{min(start + bs, len(paths))}/{len(paths)} scans")
    if writer is not None:
        writer.finalize()
    print(f"wrote {len(paths)} prediction files -> {args.out}")


if __name__ == "__main__":
    main()
