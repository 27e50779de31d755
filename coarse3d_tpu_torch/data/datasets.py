"""Dataset catalogs: file discovery + raw scan/label loading (the port's
copy of the JAX package's ``data/datasets.py``).

Behavioral models:
  - SemanticKITTI: the reference's pc_processor/dataset/semantic_kitti/
    dataset_semkitti.py — per-sequence velodyne/*.bin + labels/*.label +
    <weak_root>/<seq>/<name>/*.npy, 16-bit semantic/instance split, LUT label
    mapping.
  - SemanticPOSS: semantic_poss/semantic_poss.py — same layout plus tag/*.tag
    sensor position masks; the range image is tag-scattered, not computed
    (:167-206), depth clamped at 200 m (:173).
  - nuScenes: nuScenes/dataset_nuscenes.py — the reference walks the
    nuscenes-devkit DB; this environment has no devkit, so the catalog reads
    a pre-built JSONL manifest (one {lidar, lidarseg, weak} record per
    sample token — see tools/build_nuscenes_manifest.py) and applies the
    same >= 1 m min-depth filter (:317-326).

All catalogs return train-id labels (LUT applied) and a uniform record dict,
so the pipeline above is dataset-agnostic.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from coarse3d_tpu_torch.data import readers
from coarse3d_tpu_torch.data.label_maps import LabelSpec, get_label_spec


def _discover(root: str, seq: int, subdir: str, exts: tuple[str, ...]):
    path = os.path.join(root, f"{int(seq):02d}", subdir)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"dataset dir not found: {path}")
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(exts))
    return files


class SemanticKittiDataset:
    """Sequence-folder catalog for SemanticKITTI scans."""

    name = "semantic_kitti"

    def __init__(
        self,
        pcd_root: str,
        sequences: Sequence[int],
        weak_root: str | None = None,
        weak_label_name: str = "0.1",
        has_label: bool = True,
    ):
        self.label_spec: LabelSpec = get_label_spec(self.name)
        self.has_label = has_label
        self.has_weak = weak_root is not None
        self.scan_files: list[str] = []
        self.label_files: list[str] = []
        self.weak_files: list[str] = []
        for seq in sorted(int(s) for s in sequences):
            scans = _discover(pcd_root, seq, "velodyne", (".bin",))
            self.scan_files.extend(scans)
            if has_label:
                labels = _discover(pcd_root, seq, "labels", (".label",))
                assert len(labels) == len(scans), f"seq {seq} count mismatch"
                self.label_files.extend(labels)
            if self.has_weak:
                weak = _discover(weak_root, seq, weak_label_name, (".npy",))
                assert len(weak) == len(scans), f"seq {seq} weak mismatch"
                self.weak_files.extend(weak)

    def __len__(self) -> int:
        return len(self.scan_files)

    def path_info(self, index: int) -> tuple[str, str]:
        parts = self.scan_files[index].split(os.sep)
        return parts[-3], os.path.splitext(parts[-1])[0]

    def load(self, index: int) -> dict[str, np.ndarray]:
        points = readers.read_kitti_scan(self.scan_files[index])
        n = len(points)
        if self.has_label:
            sem_raw, _ = readers.read_kitti_label(self.label_files[index])
            labels = self.label_spec.map_labels(sem_raw)
        else:
            labels = np.zeros(n, np.int32)
        if self.has_weak:
            weak = readers.read_weak_label(self.weak_files[index])
            if weak.max(initial=0) >= self.label_spec.n_classes:
                weak = self.label_spec.map_labels(weak)
        else:
            weak = np.zeros(n, np.int32)
        assert len(labels) == len(weak) == n, (
            f"length mismatch at {self.scan_files[index]}")
        return {"points": points, "labels": labels.astype(np.int32),
                "weak_labels": weak.astype(np.int32)}


class SemanticPossDataset(SemanticKittiDataset):
    """SemanticPOSS catalog; adds sensor-provided .tag position masks."""

    name = "semantic_poss"

    def __init__(self, pcd_root: str, sequences: Sequence[int], **kw):
        super().__init__(pcd_root, sequences, **kw)
        self.label_spec = get_label_spec(self.name)
        self.tag_files: list[str] = []
        for seq in sorted(int(s) for s in sequences):
            tags = _discover(pcd_root, seq, "tag", (".tag",))
            self.tag_files.extend(tags)
        assert len(self.tag_files) == len(self.scan_files)

    def load(self, index: int) -> dict[str, np.ndarray]:
        out = super().load(index)
        tags = readers.read_poss_tag(self.tag_files[index])
        assert tags.sum() == len(out["points"]), (
            f"tag/point mismatch at {self.tag_files[index]}")
        out["tags"] = tags
        return out


class NuscenesDataset:
    """Manifest-backed nuScenes-lidarseg catalog.

    Records: {"lidar": path, "lidarseg": path, "weak": path|null,
    "token": str}. The min-depth filter (reference
    dataset_nuscenes.py:317-326) drops points closer than 1 m.
    """

    name = "nuscenes"

    def __init__(
        self,
        manifest_path: str,
        data_root: str = "",
        has_label: bool = True,
        filter_min_depth: bool = True,
        min_depth: float = 1.0,
    ):
        self.label_spec = get_label_spec(self.name)
        self.data_root = data_root
        self.has_label = has_label
        self.filter_min_depth = filter_min_depth
        self.min_depth = min_depth
        with open(manifest_path) as f:
            self.records = [json.loads(line) for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.records)

    def path_info(self, index: int) -> tuple[str, str]:
        return "nusc", self.records[index].get("token", str(index))

    def _resolve(self, p: str) -> str:
        return os.path.join(self.data_root, p) if self.data_root else p

    def load(self, index: int) -> dict[str, np.ndarray]:
        rec = self.records[index]
        points = readers.read_nuscenes_scan(self._resolve(rec["lidar"]))
        if self.has_label and rec.get("lidarseg"):
            raw = readers.read_nuscenes_label(self._resolve(rec["lidarseg"]))
            labels = self.label_spec.map_labels(raw)
        else:
            labels = np.zeros(len(points), np.int32)
        if rec.get("weak"):
            weak = readers.read_weak_label(self._resolve(rec["weak"]))
        else:
            weak = np.zeros(len(points), np.int32)
        if self.filter_min_depth:
            # Reference parity: full-xyz norm, strict > (dataset_nuscenes.py
            # :321-323 "depths > min_dist"), NOT an xy-radius or inclusive >=.
            keep = np.linalg.norm(points[:, :3], axis=1) > self.min_depth
            points, labels, weak = points[keep], labels[keep], weak[keep]
        return {"points": points, "labels": labels.astype(np.int32),
                "weak_labels": weak.astype(np.int32)}


def build_dataset(cfg, split: str = "train"):
    """Catalog factory from an ExperimentConfig (reference
    trainer.py:157-270 dispatch)."""
    d = cfg.data
    train = split == "train"
    seqs = d.train_seq if train else d.val_seq
    weak = dict(weak_root=d.weak_root, weak_label_name=d.weak_label_name) \
        if (train and d.weak_root) else {}
    if d.dataset == "semantic_kitti":
        return SemanticKittiDataset(d.pcd_root, seqs, **weak)
    if d.dataset == "semantic_poss":
        return SemanticPossDataset(d.pcd_root, seqs, **weak)
    if d.dataset == "nuscenes":
        manifest = os.path.join(
            d.pcd_root, f"manifest_{'train' if train else 'val'}.jsonl")
        return NuscenesDataset(manifest, data_root=d.pcd_root)
    raise ValueError(f"unknown dataset: {d.dataset}")
