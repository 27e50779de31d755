"""One-command BASELINE.md matrix runner (real-data readiness).

Port of the JAX package's ``tools/baseline_matrix.py``: the same plan, run
through the port's CLIs (``python -m coarse3d_tpu_torch.tools.*``), each
stage that runs a model on ``--device`` (the card by default; weak-label
sampling runs on the host). The moment a dataset or a
released checkpoint appears, this drives the full BASELINE table (the
reference's README.md:174-179) with the right presets and flags:

  # released-checkpoint evaluation (BASELINE config #1):
  python -m coarse3d_tpu_torch.tools.baseline_matrix eval \
      --pth best_3DIOU_model.pth --dataset semantic_kitti \
      --pcd_root $KITTI/sequences --work runs/baseline

  # full training recipes (BASELINE configs #2-#6): weak-label generation
  # (if missing) -> 100-epoch training -> best-checkpoint KNN evaluation:
  python -m coarse3d_tpu_torch.tools.baseline_matrix train \
      --dataset semantic_kitti --weak_ratio 0.1 \
      --pcd_root $KITTI/sequences --work runs/baseline

  # print the whole plan without running anything:
  python -m coarse3d_tpu_torch.tools.baseline_matrix train --dataset all \
      --pcd_root ... --dry_run

Each stage shells out to the port's CLIs (gen_weak_labels / train /
convert_torch_ckpt / evaluate), so every command printed by --dry_run is
also runnable by hand. In eval mode ``convert_torch_ckpt`` checks the
released ``.pth`` against the family's layers and writes a port state dict
to ``<work>/converted/<dataset>_<ratio>.pth``, which ``evaluate --weights``
reads. Results are appended to <work>/baseline_report.md (BASELINE.md-shaped:
dataset, annotation ratio, measured mIoU, published reference mIoU, delta)
and <work>/baseline_report.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# published reference numbers (BASELINE.md / reference README.md:174-179)
PUBLISHED_MIOU = {
    ("semantic_kitti", "0.01"): 47.35,
    ("semantic_kitti", "0.1"): 57.57,
    ("semantic_poss", "0.01"): 31.10,
    ("semantic_poss", "0.1"): 43.00,
    ("nuscenes", "0.01"): 42.90,
    ("nuscenes", "0.1"): 58.70,
}
DATASETS = ("semantic_kitti", "semantic_poss", "nuscenes")


def _plan_row(args, dataset: str, ratio: str) -> list[list[str]]:
    """Commands (argv lists) for one BASELINE row, each stage that runs a
    model on ``args.device`` (weak-label sampling runs on the host)."""
    py = [sys.executable, "-m"]
    dev = ["--device", args.device]
    work = os.path.join(args.work, f"{dataset}_{ratio}")
    weak_root = args.weak_root or os.path.join(args.work, "weak", dataset)
    cmds = []
    if args.mode == "eval":
        converted = os.path.join(args.work, "converted",
                                 f"{dataset}_{ratio}.pth")
        cmds.append(py + ["coarse3d_tpu_torch.tools.convert_torch_ckpt",
                          "--pth", args.pth, "--net", args.net,
                          "--out", converted] + dev)
        eval_cmd = py + ["coarse3d_tpu_torch.tools.evaluate",
                         "--preset", dataset,
                         "--pcd_root", args.pcd_root,
                         "--weights", converted, "--knn",
                         "--num_workers", str(args.num_workers),
                         "--summary_json",
                         os.path.join(work, "eval_summary.json")]
        for ov in args.extra_set:
            eval_cmd += ["--set", ov]
        cmds.append(eval_cmd + dev)
        return cmds
    # training recipe: weak labels -> train -> evaluate best ckpt
    if not (args.weak_root and os.path.isdir(weak_root)):
        # annotation name "0.1" means 0.1% of points -> label_ratio 0.001
        cmds.append(py + ["coarse3d_tpu_torch.tools.gen_weak_labels",
                          "--dataset", dataset,
                          "--dataset_root", args.pcd_root,
                          "--dataset_save", weak_root,
                          "--weak_label_name", ratio,
                          "--label_ratio", str(float(ratio) / 100.0)])
    train_cmd = py + ["coarse3d_tpu_torch.tools.train",
                      "--preset", dataset,
                      "--pcd_root", args.pcd_root,
                      "--weak_root", weak_root,
                      "--weak_label_name", ratio,
                      "--epochs", str(args.epochs),
                      "--save_path", work,
                      "--id", f"baseline_{dataset}_{ratio}",
                      "--num_workers", str(args.num_workers)]
    if args.pretrained:
        train_cmd += ["--pretrained", args.pretrained, "--only_encoder"]
    for ov in args.extra_set:
        train_cmd += ["--set", ov]
    cmds.append(train_cmd + dev)
    eval_cmd = py + ["coarse3d_tpu_torch.tools.evaluate",
                     "--preset", dataset,
                     "--pcd_root", args.pcd_root,
                     "--run_dir", work, "--ckpt", "best_3DIOU", "--knn",
                     "--num_workers", str(args.num_workers),
                     "--summary_json",
                     os.path.join(work, "eval_summary.json")]
    for ov in args.extra_set:
        eval_cmd += ["--set", ov]
    cmds.append(eval_cmd + dev)
    return cmds


def _run(cmd: list[str]) -> str:
    """Run one stage, streaming its output live (a 100-epoch training row
    runs for hours; buffered output would hide whether it is progressing)
    while keeping a tail for the caller's JSON-summary parse."""
    import collections

    print("+ " + " ".join(cmd), flush=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    tail = collections.deque(maxlen=500)
    assert proc.stdout is not None
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        tail.append(line)
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"command failed rc={rc}: {cmd}")
    return "".join(tail)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=("eval", "train"),
                   help="eval = released-checkpoint evaluation (config #1); "
                        "train = full weak-supervision recipe (#2-#6)")
    p.add_argument("--dataset", default="all",
                   choices=DATASETS + ("all",))
    p.add_argument("--weak_ratio", default="all", choices=("0.01", "0.1",
                                                           "all"))
    p.add_argument("--pcd_root", required=True,
                   help="dataset root (sequences/ for KITTI/POSS, manifest "
                        "dir for nuScenes)")
    p.add_argument("--weak_root",
                   help="existing weak-label root (skips generation)")
    p.add_argument("--pth", help="released .pth checkpoint (eval mode)")
    p.add_argument("--pth_ratio", default="0.1", choices=("0.01", "0.1"),
                   help="annotation ratio the --pth checkpoint was trained "
                        "at (selects the published mIoU to compare against)")
    p.add_argument("--net", default="salsanext")
    p.add_argument("--pretrained",
                   help="reference-named ImageNet-pretrain .pth for the "
                        "recipe's encoder warm-start")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--work", default="runs/baseline_matrix")
    p.add_argument("--extra_set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="extra --set overrides forwarded to train/evaluate "
                        "(e.g. model.stem=s2d; repeatable)")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device of every stage: 'cuda' (default; fails "
                        "without a card) or 'cpu'")
    args = p.parse_args(argv)

    if args.mode == "eval" and not args.pth:
        p.error("eval mode needs --pth")
    if args.mode == "eval" and args.dataset == "all":
        # a .pth is trained for ONE dataset (n_classes/sensor differ);
        # evaluating it against all three presets would crash on shape
        # mismatch partway through the matrix
        p.error("eval mode needs an explicit --dataset (the checkpoint "
                "is dataset-specific)")

    datasets = DATASETS if args.dataset == "all" else (args.dataset,)
    ratios = ("0.01", "0.1") if args.weak_ratio == "all" else (
        args.weak_ratio,)
    if args.mode == "train":
        rows = [(d, r) for d in datasets for r in ratios]
    else:
        rows = [(d, args.pth_ratio) for d in datasets]

    plans = {(d, r): _plan_row(args, d, r) for d, r in rows}
    if args.dry_run:
        for (d, r), cmds in plans.items():
            print(f"# {d} @ {r}")
            for cmd in cmds:
                print("  " + " ".join(cmd))
        return {"rows": [list(k) for k in plans], "dry_run": True}

    os.makedirs(args.work, exist_ok=True)
    report = []
    for (d, r), cmds in plans.items():
        for cmd in cmds:
            _run(cmd)
        # evaluate wrote its summary to a file (--summary_json); parsing
        # the merged stdout/stderr tail was corruptible by late warnings
        # (ADVICE r3)
        summary_path = cmds[-1][cmds[-1].index("--summary_json") + 1]
        with open(summary_path) as f:
            result = json.load(f)
        published = PUBLISHED_MIOU.get((d, r))
        report.append({
            "dataset": d, "ratio": r,
            "mIoU": result["mIoU_3D"] * 100,
            "published": published,
            "delta": (result["mIoU_3D"] * 100 - published
                      if published else None),
        })
        _write_report(args.work, report)
    return {"rows": report}


def _write_report(work: str, report: list[dict]) -> None:
    with open(os.path.join(work, "baseline_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    lines = ["| dataset | annotations | mIoU (ours) | mIoU (reference) | "
             "delta |", "|---|---|---|---|---|"]
    for row in report:
        pub = row["published"]
        lines.append(
            f"| {row['dataset']} | {row['ratio']} | {row['mIoU']:.2f} | "
            f"{pub if pub is not None else '—'} | "
            f"{row['delta']:+.2f} |" if row["delta"] is not None else
            f"| {row['dataset']} | {row['ratio']} | {row['mIoU']:.2f} | — "
            f"| — |")
    with open(os.path.join(work, "baseline_report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
