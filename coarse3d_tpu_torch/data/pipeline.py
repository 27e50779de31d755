"""Host-side sample building + batched prefetching pipeline.

Port of the JAX package's ``data/pipeline.py``: ``build_sample`` is a copy
(the same scan and generator give the same arrays); ``DataPipeline`` differs
in three ways: ``process_index`` / ``process_count`` default to 0 / 1 (one
process); across processes a training epoch first drops the shuffled
order's last ``n % process_count`` scans, so that every process takes the
same number of steps (the JAX package's stripes may differ by one scan);
and with ``pin_memory`` each batch is stacked straight into page-locked host
tensors, so the Trainer's copies to the card can be asynchronous.

Behavioral model: the torch `Dataset`/`DataLoader` stack —
wss_sem_kitti_loader.py:92-251 (augment -> project -> label scatter -> weak
fallback re-projection -> 5ch features -> fixed max_points padding),
wss_sem_poss_loader.py (tag-driven variant), DistributedSampler
shuffle/drop_last (trainer.py:300-340).

Design: samples are fixed-shape NumPy dicts with explicit validity masks
(the reference's implicit "padded points map to pixel (0,0)" convention is
replaced by `point_valid`); a thread pool + bounded queue overlaps disk I/O
and projection with device compute; multi-process sharding is index-striped
by ``process_index`` (the DistributedSampler analog). POSS per-point pixels
come from the sensor .tag mask, normalized to the same (px, py) convention so
every consumer is dataset-agnostic.
"""

from __future__ import annotations

import functools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from coarse3d_tpu_torch.configs.config import AugmentConfig, ExperimentConfig, SensorSpec
from coarse3d_tpu_torch.data.augment import augment_pointcloud
from coarse3d_tpu_torch.data.synthetic import pad_points
from coarse3d_tpu_torch.ops import projection

BATCH_KEYS = (
    "features", "train_label", "eval_label", "point_px", "point_py",
    "point_depth", "point_label", "point_weak_label", "point_valid",
)


def _tag_pixels(tags: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-point (px, py) from a row-major POSS position mask."""
    flat = np.flatnonzero(tags)
    return (flat % w).astype(np.int32), (flat // w).astype(np.int32)


def build_sample(
    scan: dict[str, np.ndarray],
    sensor: SensorSpec,
    max_points: int,
    augment: AugmentConfig | None = None,
    rng: np.random.Generator | None = None,
    train: bool = True,
    mask_excludes_point0: bool = True,
) -> dict[str, np.ndarray]:
    """One scan -> fixed-shape sample dict (see BATCH_KEYS)."""
    points = scan["points"]
    labels = scan["labels"]
    weak = scan["weak_labels"]
    if train and augment is not None:
        points = augment_pointcloud(points, augment, rng or
                                    np.random.default_rng())

    if "tags" in scan:
        # POSS: sensor-given pixel layout (semantic_poss.py:167-206)
        px, py = _tag_pixels(scan["tags"], sensor.proj_w)
        point_depth = None
        h, w = sensor.proj_h, sensor.proj_w
        depth = np.linalg.norm(points[:, :3], axis=1)
        if sensor.max_depth > 0:
            depth = np.minimum(depth, sensor.max_depth)
        proj_points = np.full((h * w, points.shape[1]), -1.0, np.float32)
        proj_range = np.full((h * w,), -1.0, np.float32)
        flat = py.astype(np.int64) * w + px
        proj_points[flat] = points
        proj_range[flat] = depth
        proj_points = proj_points.reshape(h, w, -1)
        proj_range = proj_range.reshape(h, w)
        eval_img = np.zeros((h * w,), np.int32)
        eval_img[flat] = labels
        train_img = np.zeros((h * w,), np.int32)
        train_img[flat] = weak
        eval_img = eval_img.reshape(h, w)
        train_img = train_img.reshape(h, w)
    else:
        from coarse3d_tpu_torch import native

        if native.available():
            project = functools.partial(
                native.range_project_native, sensor=sensor,
                mask_excludes_point0=mask_excludes_point0)
            scatter = native.scatter_labels_native
        else:
            project = functools.partial(
                projection.range_project_np, sensor=sensor,
                mask_excludes_point0=mask_excludes_point0)
            scatter = projection.scatter_labels_np
        proj = project(points)
        px, py = proj["px"], proj["py"]
        point_depth = proj["depth"]
        proj_points, proj_range = proj["proj_points"], proj["proj_range"]
        eval_img = scatter(proj["proj_idx"], labels)
        train_img = scatter(proj["proj_idx"], weak)

        # Weak-label fallback: if occlusion wiped every weak pixel,
        # re-project with weak points forced nearest
        # (wss_sem_kitti_loader.py:134-147).
        if train and (train_img > 0).sum() == 0 and (weak > 0).any():
            depth_tmp = np.linalg.norm(points[:, :3], axis=1)
            depth_tmp[weak < 1] = 10000.0
            if native.available():
                proj2 = native.range_project_native(
                    points, sensor, depth_override=depth_tmp)
            else:
                proj2 = projection.range_project_np(
                    points, sensor, depth=depth_tmp)
            train_img = scatter(proj2["proj_idx"], weak)

    features = projection.build_range_features_np(proj_points, proj_range)

    if point_depth is None:  # POSS tag path computes depth directly
        point_depth = np.minimum(
            np.linalg.norm(points[:, :3], axis=1),
            sensor.max_depth if sensor.max_depth > 0 else np.inf)
    depth_p, _ = pad_points(point_depth.astype(np.float32), max_points,
                            fill=-1.0)

    px_p, valid = pad_points(px.astype(np.int32), max_points)
    py_p, _ = pad_points(py.astype(np.int32), max_points)
    lbl_p, _ = pad_points(labels.astype(np.int32), max_points)
    weak_p, _ = pad_points(weak.astype(np.int32), max_points)

    return {
        "features": features,
        "train_label": train_img.astype(np.int32),
        "eval_label": eval_img.astype(np.int32),
        "point_px": px_p,
        "point_py": py_p,
        "point_depth": depth_p,
        "point_label": lbl_p,
        "point_weak_label": weak_p,
        "point_valid": valid,
    }


def _pad_tail_batch(batch: dict[str, np.ndarray],
                    batch_size: int) -> dict[str, np.ndarray]:
    """Pad a partial (eval-tail) batch to the fixed batch size so every step
    runs the same compiled shape. Pad samples replicate sample 0's arrays but
    carry point_valid=False, all-ignore labels, and scan_index=-1, so they
    contribute nothing to the confusion matrix and are skippable by
    prediction writers."""
    pad_n = batch_size - len(batch["scan_index"])
    out = {}
    for k, v in batch.items():
        pad = np.repeat(v[:1], pad_n, axis=0)
        if k in ("point_valid", "train_label", "eval_label", "point_label",
                 "point_weak_label"):
            pad = np.zeros_like(pad)
        elif k == "scan_index":
            pad = np.full(pad_n, -1, np.int32)
        out[k] = np.concatenate([v, pad])
    return out


class DataPipeline:
    """Shuffling, sharding, batching, threaded prefetch over a catalog."""

    def __init__(
        self,
        dataset,
        cfg: ExperimentConfig,
        batch_size: int,
        train: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count or 1
        self.pin_memory = pin_memory

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.train:
            order = np.random.default_rng(
                (self.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        if self.train:
            # every process takes the same number of scans, hence of steps:
            # the data-parallel step's collectives need all of them in it
            # (DistributedSampler(drop_last=True) cuts the same way)
            order = order[:n - n % self.process_count]
        # stripe across hosts (DistributedSampler analog)
        order = order[self.process_index::self.process_count]
        if self.train:  # drop_last
            usable = (len(order) // self.batch_size) * self.batch_size
            order = order[:usable]
        return order

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        if self.train:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _build(self, index: int, epoch: int) -> dict[str, np.ndarray]:
        scan = self.dataset.load(int(index))
        rng = np.random.default_rng((self.seed, epoch, int(index)))
        return build_sample(
            scan, self.cfg.sensor, self.cfg.data.max_points,
            augment=self.cfg.augment if self.train else None,
            rng=rng, train=self.train)

    def _stack(self, arrays: list[np.ndarray]) -> np.ndarray:
        """np.stack; with ``pin_memory`` into a page-locked buffer (the
        array is a view of a pinned tensor, which ``torch.from_numpy``
        recovers: it shares the memory, so ``is_pinned()`` holds)."""
        if not self.pin_memory:
            return np.stack(arrays)
        import torch

        first = arrays[0]
        out = torch.empty((len(arrays),) + first.shape,
                          dtype=torch.from_numpy(first[:0]).dtype,
                          pin_memory=True).numpy()
        np.stack(arrays, out=out)
        return out

    def epoch(self, epoch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Yield stacked batch dicts, prefetched by a thread pool."""
        order = self._epoch_indices(epoch)
        batches = [
            order[i:i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(
                            lambda i: self._build(i, epoch), idxs))
                        batch = {k: self._stack([s[k] for s in samples])
                                 for k in BATCH_KEYS}
                        # dataset indices ride in the batch so prediction
                        # writers never depend on iteration order (multi-host
                        # striping reorders scans)
                        batch["scan_index"] = np.asarray(idxs, np.int32)
                        if len(samples) < self.batch_size:
                            batch = _pad_tail_batch(batch, self.batch_size)
                            if self.pin_memory:
                                batch = {k: self._stack(list(v))
                                         for k, v in batch.items()}
                        q.put(batch)
                q.put(None)
            except BaseException as exc:  # propagate to the consumer
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
