"""Benchmark-submission prediction trees (the port's copy of the JAX
package's ``eval/submission.py``).

The reference never writes predictions at all (its Validation mode only
logs metrics, trainer.py:706-747), but its published results target the
SemanticKITTI and nuScenes-lidarseg benchmark servers, whose upload formats
are fixed:

* SemanticKITTI (and SemanticPOSS, which follows the same tree):
  ``<root>/sequences/<NN>/predictions/<FFFFFF>.label`` — one little-endian
  **uint32** raw-dataset-id per point, in scan order
  (semantic-kitti.org submission spec / validate_submission.py).
* nuScenes-lidarseg: ``<root>/lidarseg/<split>/<token>_lidarseg.bin`` — one
  **uint8** challenge category index (1..16, == this repo's train ids) per
  point, plus ``<root>/<split>/submission.json`` meta
  (nuscenes-devkit lidarseg evaluation spec).

Any other dataset (synthetic smoke runs) falls back to flat
``<seq>_<frame>.label`` int32 train-id files.
"""

from __future__ import annotations

import json
import os

import numpy as np

from coarse3d_tpu_torch.data.label_maps import LabelSpec


class SubmissionWriter:
    """Writes per-scan point predictions in the benchmark's upload layout.

    Args:
      root: output directory (the directory one would zip for upload).
      dataset: "semantic_kitti" | "semantic_poss" | "nuscenes" | other.
      label_spec: LabelSpec for train-id -> raw-id unmapping (KITTI/POSS).
      split: nuScenes split name used in the tree ("val" / "test").
    """

    def __init__(self, root: str, dataset: str,
                 label_spec: LabelSpec | None = None, split: str = "val"):
        self.root = root
        self.dataset = dataset
        self.spec = label_spec
        self.split = split
        self.count = 0
        os.makedirs(root, exist_ok=True)

    def write(self, seq_id: str, frame_id: str, pred: np.ndarray) -> str:
        """Write one scan's per-point train-id predictions; returns the path."""
        if self.dataset in ("semantic_kitti", "semantic_poss"):
            assert self.spec is not None, "KITTI/POSS submissions need a spec"
            out_dir = os.path.join(
                self.root, "sequences", seq_id, "predictions")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{frame_id}.label")
            # train id 0 (ignore) can reach here when KNN is off (argmax
            # over all classes); raw id 0 = "unlabeled" is rejected by the
            # benchmark validator, so clip to 1 like the nuScenes branch.
            raw = self.spec.unmap_labels(np.maximum(pred, 1))
            raw.astype(np.uint32).tofile(path)
        elif self.dataset == "nuscenes":
            out_dir = os.path.join(self.root, "lidarseg", self.split)
            os.makedirs(out_dir, exist_ok=True)
            # the challenge index space IS the 16-class train-id space; 0
            # (ignore) is not a legal prediction — clip to 1 like the
            # devkit's validate_submission demands. All catalogs follow the
            # ("<namespace>", <token-or-stem>) path_info convention, so the
            # frame_id IS the token (a seq_id fallback here silently
            # collapsed every synthetic scan onto one file).
            path = os.path.join(out_dir, f"{frame_id}_lidarseg.bin")
            np.maximum(pred, 1).astype(np.uint8).tofile(path)
        else:
            path = os.path.join(self.root, f"{seq_id}_{frame_id}.label")
            pred.astype(np.int32).tofile(path)
        self.count += 1
        return path

    def finalize(self) -> None:
        if self.dataset == "nuscenes":
            meta_dir = os.path.join(self.root, self.split)
            os.makedirs(meta_dir, exist_ok=True)
            with open(os.path.join(meta_dir, "submission.json"), "w") as f:
                json.dump({"meta": {
                    "use_camera": False, "use_lidar": True, "use_radar": False,
                    "use_map": False, "use_external": False}}, f)


def read_submission(root: str, dataset: str, seq_id: str, frame_id: str,
                    label_spec: LabelSpec | None = None,
                    split: str = "val") -> np.ndarray:
    """Read one scan's predictions back as *train ids* (round-trip check)."""
    if dataset in ("semantic_kitti", "semantic_poss"):
        raw = np.fromfile(
            os.path.join(root, "sequences", seq_id, "predictions",
                         f"{frame_id}.label"), dtype=np.uint32)
        assert label_spec is not None
        return label_spec.map_labels(raw.astype(np.int64))
    if dataset == "nuscenes":
        return np.fromfile(
            os.path.join(root, "lidarseg", split, f"{frame_id}_lidarseg.bin"),
            dtype=np.uint8).astype(np.int32)
    return np.fromfile(
        os.path.join(root, f"{seq_id}_{frame_id}.label"), dtype=np.int32)
