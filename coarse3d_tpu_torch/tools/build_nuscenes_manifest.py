"""Build a nuScenes-lidarseg manifest (JSONL) from the raw table files.

Port of the JAX package's ``tools/build_nuscenes_manifest.py``, a copy: the
catalog (``data/datasets.py:NuscenesDataset``) and ``tools/gen_weak_labels.py``
read the manifest it writes. It reads JSON tables and writes JSON lines on
the host, and touches no device, so it takes no ``--device``.

Behavioral model: the reference walks the nuscenes-devkit DB at train time
(dataset_nuscenes.py:75-453: token lists per split, lidarseg filename join,
weak path by string substitution :300-309); here the v1.0 JSON tables are
read directly, with no devkit.

Split handling: the official train/val split is the devkit's
`nuscenes.utils.splits` scene-name lists. If the devkit is importable it is
used; otherwise pass --val_scenes (file with one scene name per line).

  python -m coarse3d_tpu_torch.tools.build_nuscenes_manifest \
      --dataroot /data/nuscenes --version v1.0-trainval \
      --out_dir /data/nuscenes [--weak_name 0.1]
"""

from __future__ import annotations

import argparse
import json
import os


def load_table(dataroot: str, version: str, name: str):
    with open(os.path.join(dataroot, version, f"{name}.json")) as f:
        return json.load(f)


def build_records(dataroot: str, version: str,
                  weak_name: str | None = None):
    """Yield (scene_name, record) for every key LIDAR_TOP sample frame."""
    scene = {s["token"]: s for s in load_table(dataroot, version, "scene")}
    sample = {s["token"]: s for s in load_table(dataroot, version, "sample")}
    sample_data = load_table(dataroot, version, "sample_data")
    try:
        lidarseg = {
            r["sample_data_token"]: r["filename"]
            for r in load_table(dataroot, version, "lidarseg")}
    except FileNotFoundError:
        lidarseg = {}

    for sd in sample_data:
        if not sd.get("is_key_frame"):
            continue
        fname = sd["filename"]
        if "LIDAR_TOP" not in fname:
            continue
        smp = sample[sd["sample_token"]]
        scene_name = scene[smp["scene_token"]]["name"]
        rec = {
            "token": sd["token"],
            "lidar": fname,
            "lidarseg": lidarseg.get(sd["token"]),
        }
        if weak_name and rec["lidarseg"]:
            # weak path by substitution, mirroring dataset_nuscenes.py:300-309
            rec["weak"] = rec["lidarseg"].replace(
                "lidarseg", weak_name).replace(".bin", ".npy")
        yield scene_name, rec


def official_splits():
    """Devkit scene splits if available, else None."""
    try:
        from nuscenes.utils import splits

        return {"train": set(splits.train), "val": set(splits.val)}
    except ImportError:
        return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--weak_name", default=None,
                   help="weak-label dir name substituted for 'lidarseg'")
    p.add_argument("--val_scenes", default=None,
                   help="file listing val scene names (one per line); "
                        "required when the nuscenes devkit is absent")
    args = p.parse_args(argv)

    splits = official_splits()
    if splits is None:
        if not args.val_scenes:
            raise SystemExit("nuscenes devkit not installed: pass "
                             "--val_scenes")
        with open(args.val_scenes) as f:
            val = {line.strip() for line in f if line.strip()}
        splits = {"val": val, "train": None}  # train = everything else

    os.makedirs(args.out_dir, exist_ok=True)
    counts = {"train": 0, "val": 0}
    files = {
        s: open(os.path.join(args.out_dir, f"manifest_{s}.jsonl"), "w")
        for s in ("train", "val")
    }
    try:
        for scene_name, rec in build_records(
                args.dataroot, args.version, args.weak_name):
            if scene_name in splits["val"]:
                split = "val"
            elif splits["train"] is None or scene_name in splits["train"]:
                split = "train"
            else:
                continue
            files[split].write(json.dumps(rec) + "\n")
            counts[split] += 1
    finally:
        for f in files.values():
            f.close()
    print(f"wrote {counts['train']} train / {counts['val']} val records "
          f"to {args.out_dir}")


if __name__ == "__main__":
    main()
