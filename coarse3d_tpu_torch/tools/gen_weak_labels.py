"""Weak-label generation: voxel-grid-sampled sparse annotations.

Port of the JAX package's ``tools/gen_weak_labels.py``, a copy: it runs on
the host (NumPy, or the native voxelizer of ``native/``) and writes the same
files. Behavioral model: the reference's tasks/prepare_data/
gen_sem_weak_label_rand_grid.py (:140-271): per scan, voxelize at
`voxel_size` (0.06 m), label each voxel by its first point, uniformly sample
`round(N_points * label_ratio)` (min 1) among non-ignore voxels, and
propagate each sampled voxel's label to all its points
(`voxel_propagation=True`) or only its first point. Saves one .npy of
per-point weak labels per scan + a per-class stats log.

The reference's per-point Python loops collapse into vectorized NumPy:
open3d's voxel coordinate is floor((p - min_bound) / voxel_size), and
`np.unique(..., return_inverse=True)` gives the point->voxel map in one
pass; scans are spread over worker processes.

The tool runs on the host alone and so takes no ``--device``, as
``build_nuscenes_manifest`` takes none: it runs on any data-preparation
machine, with or without a card.

CLI:
  python -m coarse3d_tpu_torch.tools.gen_weak_labels \
      --dataset semantic_kitti --dataset_root .../sequences \
      --dataset_save .../weak/sequences --label_ratio 0.001
"""

from __future__ import annotations

import argparse
import os
import multiprocessing

import numpy as np

from coarse3d_tpu_torch.data import readers
from coarse3d_tpu_torch.data.label_maps import get_label_spec


def voxelize(xyz: np.ndarray, voxel_size: float
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Point -> voxel assignment, open3d VoxelGrid coordinate convention.

    Returns (voxel_coords (V, 3) int, point2voxel (N,) int voxel ids,
    first_point (V,) index of each voxel's first point).

    Voxel ids are FIRST-APPEARANCE ordered (the id of a voxel is the rank
    of its first point), byte-identical to the native C++ path — so weak
    labels generated with a fixed --seed are reproducible whether or not
    the native extension compiled.
    """
    coords = np.floor(
        (xyz - xyz.min(axis=0)) / voxel_size).astype(np.int64)
    voxels, first, inverse = np.unique(
        coords, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    # lexicographic unique order -> first-appearance order
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return voxels[order], rank[inverse], first[order]


def sample_weak_labels(
    xyz: np.ndarray,
    mapped_labels: np.ndarray,
    label_ratio: float,
    voxel_size: float,
    rng: np.random.Generator,
    voxel_propagation: bool = True,
) -> np.ndarray:
    """Per-point weak labels by random voxel-grid sampling."""
    n = len(xyz)
    from coarse3d_tpu_torch import native

    if native.available():
        # the same partition, first point per voxel and first-appearance
        # voxel ids as the NumPy path (voxelize), in C++
        point2voxel, first = native.voxelize_native(xyz[:, :3], voxel_size)
    else:
        _, point2voxel, first = voxelize(xyz[:, :3], voxel_size)
    voxel_label = mapped_labels[first]  # voxel labeled by its first point

    n_sample = max(1, int(np.around(n * label_ratio)))
    valid = np.flatnonzero(voxel_label > 0)
    assert len(valid) > 0, "scan has no labeled voxels"
    n_sample = min(n_sample, len(valid))
    sampled = rng.choice(valid, size=n_sample, replace=False)

    weak = np.zeros(n, dtype=np.int32)
    if voxel_propagation:
        lut = np.zeros(voxel_label.shape[0], np.int32)
        lut[sampled] = voxel_label[sampled]
        weak = lut[point2voxel]
    else:
        weak[first[sampled]] = voxel_label[sampled]
    return weak


def _process_scan(args):
    scan_path, label_path, out_path, dataset, ratio, voxel_size, prop, seed \
        = args
    spec = get_label_spec(dataset)
    if dataset == "nuscenes":
        points = readers.read_nuscenes_scan(scan_path)
        raw = readers.read_nuscenes_label(label_path)
    else:
        points = readers.read_kitti_scan(scan_path)
        raw, _ = readers.read_kitti_label(label_path)
    mapped = spec.map_labels(raw)
    rng = np.random.default_rng(seed)
    weak = sample_weak_labels(points, mapped, ratio, voxel_size, rng, prop)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.save(out_path, weak)
    counts = np.bincount(weak, minlength=spec.n_classes)
    full = np.bincount(mapped, minlength=spec.n_classes)
    return counts, full


def _nuscenes_weak_path(lidarseg_rel: str, weak_label_name: str) -> str:
    """Reference path convention (gen_nuscenes_weak_label_rand_grid.py
    :176-182): the weak file is the lidarseg path rebased onto dataset_save
    with 'lidarseg' -> weak_label_name and '.bin' -> '.npy'."""
    return lidarseg_rel.replace("lidarseg", weak_label_name).replace(
        ".bin", ".npy")


def _nuscenes_jobs(args) -> list:
    """Manifest-driven job list: each record of every manifest carries
    {lidar, lidarseg} relative paths (tools/build_nuscenes_manifest.py).
    The reference's generator walks the devkit token list
    (gen_nuscenes_weak_label_rand_grid.py:261-276); no devkit is in this
    image, so the manifest stands in for it."""
    import json

    manifests = args.manifest or sorted(
        os.path.join(args.dataset_root, f)
        for f in os.listdir(args.dataset_root)
        if f.startswith("manifest_") and f.endswith(".jsonl"))
    if not manifests:
        raise SystemExit(
            f"--dataset nuscenes: no --manifest given and no "
            f"manifest_*.jsonl found in {args.dataset_root} "
            f"(build one with tools/build_nuscenes_manifest.py)")
    jobs = []
    for m, manifest in enumerate(manifests):
        with open(manifest) as f:
            records = [json.loads(line) for line in f if line.strip()]
        for i, rec in enumerate(records):
            if not rec.get("lidarseg"):
                # manifests built without a lidarseg table (e.g. v1.0-test)
                # carry "lidarseg": null — there is nothing to sample from
                raise SystemExit(
                    f"{manifest}: record {i} has no lidarseg path; weak "
                    "labels can only be generated for labeled splits")
            out_rel = _nuscenes_weak_path(rec["lidarseg"],
                                          args.weak_label_name)
            jobs.append((
                os.path.join(args.dataset_root, rec["lidar"]),
                os.path.join(args.dataset_root, rec["lidarseg"]),
                os.path.join(args.dataset_save, out_rel),
                args.dataset, args.label_ratio, args.voxel_size,
                not args.no_voxel_propagation,
                (args.seed, m, i),
            ))
    return jobs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="semantic_kitti",
                   choices=["semantic_kitti", "semantic_poss", "nuscenes"])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--dataset_save", required=True)
    p.add_argument("--sequences", type=int, nargs="*", default=None)
    p.add_argument("--manifest", nargs="*", default=None,
                   help="nuscenes: manifest .jsonl file(s); defaults to all "
                        "manifest_*.jsonl under --dataset_root")
    p.add_argument("--weak_label_name", default="0.1")
    p.add_argument("--label_ratio", type=float, default=0.001,
                   help="0.001 => 0.1%%, 0.0001 => 0.01%%")
    p.add_argument("--voxel_size", type=float, default=0.06)
    p.add_argument("--no_voxel_propagation", action="store_true")
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.sequences is None:
        args.sequences = {
            "semantic_kitti": list(range(11)),
            "semantic_poss": list(range(6)),
        }.get(args.dataset, [])

    if args.dataset == "nuscenes":
        jobs = _nuscenes_jobs(args)
    else:
        jobs = []
        for seq in args.sequences:
            seq_s = f"{seq:02d}"
            scan_dir = os.path.join(args.dataset_root, seq_s, "velodyne")
            label_dir = os.path.join(args.dataset_root, seq_s, "labels")
            out_dir = os.path.join(args.dataset_save, seq_s,
                                   args.weak_label_name)
            scans = sorted(
                f for f in os.listdir(scan_dir) if f.endswith(".bin"))
            for i, fname in enumerate(scans):
                stem = os.path.splitext(fname)[0]
                jobs.append((
                    os.path.join(scan_dir, fname),
                    os.path.join(label_dir, stem + ".label"),
                    os.path.join(out_dir, stem + ".npy"),
                    args.dataset, args.label_ratio, args.voxel_size,
                    not args.no_voxel_propagation,
                    (args.seed, seq, i),
                ))
    if not jobs:
        raise SystemExit("no scans found — check --dataset_root/--sequences")

    spec = get_label_spec(args.dataset)
    weak_counts = np.zeros(spec.n_classes, np.int64)
    full_counts = np.zeros(spec.n_classes, np.int64)
    # spawned workers: the caller may hold threads (torch's), which a
    # forked child would inherit half-locked
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        for i, (wc, fc) in enumerate(pool.imap_unordered(_process_scan, jobs)):
            weak_counts += wc
            full_counts += fc
            if (i + 1) % 500 == 0:
                print(f"{i + 1}/{len(jobs)} scans")

    log = os.path.join(
        args.dataset_save,
        f"log_{args.dataset}_ratio-{args.label_ratio}"
        f"_voxel-{args.voxel_size}.txt")
    with open(log, "w") as f:
        f.write(f"args: {vars(args)}\n\nper-class weak/full point counts:\n")
        for c in range(spec.n_classes):
            f.write(f"{c} {spec.class_names[c]}: "
                    f"{weak_counts[c]} / {full_counts[c]}\n")
    print(f"done: {len(jobs)} scans; stats -> {log}")


if __name__ == "__main__":
    main()
