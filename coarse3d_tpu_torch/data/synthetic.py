"""Synthetic LiDAR scan fixtures: the port's whole-module copy of the JAX
package's ``data/synthetic.py`` (``synthetic_scan`` with its ``uniform`` /
``grid`` / ``clustered`` angular modes, the in-memory catalogs
``SyntheticDataset`` / ``SyntheticHardDataset`` and their scan generators,
``synthetic_batch`` and ``pad_points``).

The same numpy generator state gives the same scan, and the same training
batch, in both packages, so a test or a smoke run can feed one batch to
both.
"""

from __future__ import annotations

import numpy as np

from coarse3d_tpu_torch.configs.config import SensorSpec


def synthetic_scan(
    rng: np.random.Generator,
    n_points: int,
    n_classes: int,
    sensor: SensorSpec,
    weak_ratio: float = 0.001,
    angular: str = "uniform",
) -> dict[str, np.ndarray]:
    """One scan: (N, 4) points + full labels + weak labels.

    `angular` controls the pixel-occupancy structure — the one property of
    the synthetic distribution the point-rate ops (projection scatter, KNN
    gather) could be sensitive to:

      uniform    — i.i.d. angles (the default; ~35% of points lose their
                   pixel to a nearer point at KITTI scale)
      grid       — beam-structured like a real rotating scanner: points on
                   H regular elevation rows, near-regular azimuth spacing
                   with sub-pixel jitter (few-% pixel losers)
      clustered  — 60% of points in ~2-px angular blobs (object-like
                   foreground over a uniform background; worst-case scatter
                   conflicts, well above real-scan loser rates)
    """
    yaw_lo = np.radians(sensor.fov_left)
    yaw_hi = np.radians(sensor.fov_right)
    pit_lo = np.radians(sensor.fov_down)
    pit_hi = np.radians(sensor.fov_up)
    if angular == "uniform":
        yaw = rng.uniform(yaw_lo, yaw_hi, n_points)
        pitch = rng.uniform(pit_lo, pit_hi, n_points)
    elif angular == "grid":
        h = sensor.proj_h
        row = np.arange(n_points) % h
        per_row = -(-n_points // h)  # ceil: azimuth steps per beam
        rank = np.arange(n_points) // h
        u = (rank + rng.uniform(0.2, 0.8, n_points)) / per_row
        v = (row + rng.uniform(0.2, 0.8, n_points)) / h
        yaw = yaw_lo + u * (yaw_hi - yaw_lo)
        pitch = pit_lo + v * (pit_hi - pit_lo)
    elif angular == "clustered":
        k = max(8, n_points // 3000)
        n_bg = int(n_points * 0.4)
        n_cl = n_points - n_bg
        cu, cv = rng.uniform(0, 1, k), rng.uniform(0, 1, k)
        blob = rng.integers(0, k, n_cl)
        u = np.concatenate([
            rng.uniform(0, 1, n_bg),
            (cu[blob] + rng.normal(0, 2.0 / sensor.proj_w, n_cl)) % 1.0])
        v = np.concatenate([
            rng.uniform(0, 1, n_bg),
            np.clip(cv[blob] + rng.normal(0, 2.0 / sensor.proj_h, n_cl),
                    0.0, 1.0 - 1e-6)])
        perm = rng.permutation(n_points)
        u, v = u[perm], v[perm]
        yaw = yaw_lo + u * (yaw_hi - yaw_lo)
        pitch = pit_lo + v * (pit_hi - pit_lo)
    else:
        raise ValueError(f"unknown angular distribution: {angular!r}")
    depth = rng.gamma(shape=2.0, scale=8.0, size=n_points).clip(1.5, 80.0)

    x = depth * np.cos(pitch) * np.cos(-yaw)
    y = depth * np.cos(pitch) * np.sin(-yaw)
    z = depth * np.sin(pitch)
    intensity = rng.uniform(0.0, 1.0, n_points)
    points = np.stack([x, y, z, intensity], axis=1).astype(np.float32)

    # Correlate labels with elevation bands so IoU is not pure noise.
    bands = np.clip(
        ((pitch - np.radians(sensor.fov_down))
         / (np.radians(sensor.fov_up) - np.radians(sensor.fov_down))
         * (n_classes - 1)).astype(np.int32),
        0, n_classes - 2) + 1
    flip = rng.random(n_points) < 0.1
    labels = np.where(
        flip, rng.integers(1, n_classes, n_points), bands).astype(np.int32)

    weak = np.zeros(n_points, dtype=np.int32)
    n_weak = max(1, int(round(n_points * weak_ratio)))
    weak_idx = rng.choice(n_points, size=n_weak, replace=False)
    weak[weak_idx] = labels[weak_idx]
    return {"points": points, "labels": labels, "weak_labels": weak}


class SyntheticDataset:
    """In-memory catalog of synthetic scans (drop-in for the disk catalogs);
    used by --synthetic smoke runs and tests."""

    name = "synthetic"

    def __init__(self, n_scans: int, n_points: int, n_classes: int, sensor,
                 weak_ratio: float = 0.002, seed: int = 0,
                 cache: bool = True):
        self.n_scans = n_scans
        self.n_points = n_points
        self.n_classes = n_classes
        self.sensor = sensor
        self.weak_ratio = weak_ratio
        self.seed = seed
        # scans are deterministic in (seed, index): cache them instead of
        # regenerating every epoch (a KITTI-scale 120k-point scan costs
        # a noticeable share of a host core per generation, the dominant
        # data wait in synthetic runs; 64 scans are ~200 MB). Copies are served
        # because the pipeline's augmentor works on the arrays. Pass
        # cache=False for single-pass consumers (evaluate/infer) where
        # every scan is read once and the cache is pure memory overhead.
        self._cache: dict[int, dict[str, np.ndarray]] | None = (
            {} if cache else None)

    def __len__(self) -> int:
        return self.n_scans

    def path_info(self, index: int) -> tuple[str, str]:
        return "synth", f"{index:06d}"

    def _generate(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        return synthetic_scan(
            rng, self.n_points, self.n_classes, self.sensor, self.weak_ratio)

    def load(self, index: int) -> dict[str, np.ndarray]:
        if self._cache is None:
            return self._generate(index)
        scan = self._cache.get(index)
        if scan is None:
            self._cache[index] = scan = self._generate(index)
        return {k: v.copy() for k, v in scan.items()}


def texture_periods(
    n_classes: int, cell_px: float, modes_per_class: int = 2,
    min_period_px: float = 5.0,
) -> np.ndarray:
    """Per-(class, mode) intensity stripe periods, in *pixels* of the range
    image, geometrically spaced between `min_period_px` and ~1/3 of the
    segment width (so several full periods are observable inside every
    segment) and interleaved so each class's modes sit far apart while
    adjacent classes differ by only one ratio step.

    Pixel units keep the task difficulty resolution-independent: the tiny
    CPU grids and the 64x2048 KITTI grid see the same stripe widths.
    """
    m = n_classes - 1  # real classes; 0 is ignore
    slots = m * modes_per_class
    lo = min_period_px
    hi = max(cell_px / 3.0, lo * 2)
    series = lo * (hi / lo) ** (np.arange(slots) / max(slots - 1, 1))
    table = np.zeros((n_classes, modes_per_class), np.float64)
    for i in range(m):
        for j in range(modes_per_class):
            table[i + 1, j] = series[j * m + i]
    return table


def synthetic_hard_scan(
    rng: np.random.Generator,
    n_points: int,
    n_classes: int,
    sensor: SensorSpec,
    weak_ratio: float = 0.0001,
    n_segments: int = 6,
    modes_per_class: int = 2,
    noise: float = 0.15,
    weak_label_noise: float = 0.0,
    imbalance: float = 0.0,
) -> dict[str, np.ndarray]:
    """A scan whose classes are *geometrically indistinguishable*.

    The elevation-band task (`synthetic_scan`) is solvable from per-pixel
    pitch alone, so the contrast/selection machinery has nothing to add (the
    round-2 ablation's null result). Here the scene is a random partition of
    the yaw axis into full-height sectors; every class has the same
    depth/elevation distribution, and the ONLY class signal is the angular
    frequency of an intensity stripe pattern (class -> one of
    `modes_per_class` stripe periods, random phase per sector; square wave,
    so the per-pixel intensity marginal is the same two-level mixture for
    every class). A single pixel is uninformative; classification requires
    spatial context, and with ~0.01% weak labels whole (class, mode) texture
    modes go unlabeled — the regime the prototype-contrast machinery
    (sub-prototypes per class, pseudo-label expansion; reference
    contrast_pixel_loss.py:8-195, trainer.py:654-690) exists to handle.

    `imbalance > 1` skews the class point-share geometrically so class k
    owns ~imbalance^(-(k-1)/(C-2)) of the yaw budget (class 1 most common,
    class C-1 rarest at 1/imbalance of class 1's share). The uniform weak
    sampling then starves rare classes of CE signal exactly as real-world
    class imbalance does (SemanticKITTI's rare classes are the rows where
    COARSE3D's own table claims its largest wins, README.md:174-179 of the
    reference) — the transfer channel the balanced task lacks by
    construction. Every class keeps >= 1 sector per scan so per-class IoU
    stays measurable. 0 (default) keeps the balanced 1D-Voronoi layout.
    """
    yaw_lo, yaw_hi = np.radians(sensor.fov_left), np.radians(sensor.fov_right)
    pit_lo, pit_hi = np.radians(sensor.fov_down), np.radians(sensor.fov_up)
    yaw = rng.uniform(yaw_lo, yaw_hi, n_points)
    pitch = rng.uniform(pit_lo, pit_hi, n_points)
    depth = rng.gamma(shape=2.0, scale=8.0, size=n_points).clip(1.5, 80.0)

    x = depth * np.cos(pitch) * np.cos(-yaw)
    y = depth * np.cos(pitch) * np.sin(-yaw)
    z = depth * np.sin(pitch)

    u = (yaw - yaw_lo) / (yaw_hi - yaw_lo)
    if imbalance and imbalance > 1.0:
        m = n_classes - 1
        if n_segments < m:
            raise ValueError(
                f"imbalanced hard task needs n_segments >= n_classes-1 "
                f"({n_segments} < {m}) so every class keeps a sector")
        # geometric class shares, sectors-per-class >= 1 by construction
        w = imbalance ** (-np.arange(m) / max(m - 1, 1))
        share = w / w.sum()
        n_k = np.maximum(1, np.round(share * n_segments).astype(np.int64))
        while n_k.sum() > n_segments:
            n_k[int(np.argmax(n_k))] -= 1
        while n_k.sum() < n_segments:
            n_k[int(np.argmin(n_k))] += 1
        seg_class = np.repeat(
            np.arange(1, m + 1, dtype=np.int32), n_k)
        # sector widths: class share split over its sectors, jittered so
        # boundaries are not a fixed grid, then shuffled + rotated so class
        # order around the circle is random per scan
        widths = (share / n_k)[seg_class - 1]
        widths = widths * rng.lognormal(0.0, 0.25, n_segments)
        order = rng.permutation(n_segments)
        seg_class = seg_class[order]
        widths = widths[order]
        bounds = np.cumsum(widths / widths.sum())
        v = (u + rng.uniform(0.0, 1.0)) % 1.0
        seg = np.minimum(np.searchsorted(bounds, v, side="right"),
                         n_segments - 1)
    else:
        # random full-height yaw sectors (1D Voronoi, wrap at the 360 seam)
        su = rng.uniform(0.0, 1.0, n_segments)
        du = np.abs(u[:, None] - su[None, :])
        du = np.minimum(du, 1.0 - du)
        seg = np.argmin(du, axis=1)
        seg_class = rng.integers(1, n_classes, n_segments).astype(np.int32)

    seg_mode = rng.integers(0, modes_per_class, n_segments)
    seg_phase = rng.uniform(0.0, 2 * np.pi, n_segments)

    periods = texture_periods(
        n_classes, sensor.proj_w / n_segments, modes_per_class)
    # cycles per radian of yaw such that one period spans `periods` pixels
    freq = (sensor.proj_w / periods[seg_class, seg_mode]
            ) * 2 * np.pi / (yaw_hi - yaw_lo)
    wave = np.sign(np.sin(freq[seg] * yaw + seg_phase[seg]))
    intensity = (0.5 + 0.35 * wave
                 + rng.normal(0.0, noise, n_points)).clip(0.0, 1.0)

    points = np.stack([x, y, z, intensity], axis=1).astype(np.float32)
    labels = seg_class[seg]

    weak = np.zeros(n_points, dtype=np.int32)
    n_weak = max(1, int(round(n_points * weak_ratio)))
    weak_idx = rng.choice(n_points, size=n_weak, replace=False)
    weak_lbl = labels[weak_idx].copy()
    if weak_label_noise > 0:
        flip = rng.random(n_weak) < weak_label_noise
        weak_lbl = np.where(
            flip, rng.integers(1, n_classes, n_weak), weak_lbl)
    weak[weak_idx] = weak_lbl
    return {"points": points, "labels": labels, "weak_labels": weak}


class SyntheticHardDataset(SyntheticDataset):
    """Catalog over `synthetic_hard_scan` (the contrast-ablation benchmark)."""

    name = "synthetic_hard"

    def __init__(self, n_scans, n_points, n_classes, sensor,
                 weak_ratio: float = 0.0001, seed: int = 0,
                 n_segments: int = 6, modes_per_class: int = 2,
                 noise: float = 0.15, weak_label_noise: float = 0.0,
                 imbalance: float = 0.0, cache: bool = True):
        super().__init__(n_scans, n_points, n_classes, sensor,
                         weak_ratio=weak_ratio, seed=seed, cache=cache)
        self.n_segments = n_segments
        self.modes_per_class = modes_per_class
        self.noise = noise
        self.weak_label_noise = weak_label_noise
        self.imbalance = imbalance

    def _generate(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        return synthetic_hard_scan(
            rng, self.n_points, self.n_classes, self.sensor,
            weak_ratio=self.weak_ratio, n_segments=self.n_segments,
            modes_per_class=self.modes_per_class, noise=self.noise,
            weak_label_noise=self.weak_label_noise,
            imbalance=self.imbalance)


def hard_task_kwargs(args) -> dict:
    """SyntheticHardDataset kwargs from a CLI namespace.

    The train / evaluate / train_crf tools share the --synthetic_* flag
    names; this is the single place mapping them to dataset kwargs (None =
    flag not passed, keep the dataset default), so a new hard-task knob is
    threaded once instead of per-tool.
    """
    out = {}
    for attr, key in (("synthetic_segments", "n_segments"),
                      ("synthetic_modes", "modes_per_class"),
                      ("synthetic_noise", "noise"),
                      ("synthetic_label_noise", "weak_label_noise"),
                      ("synthetic_imbalance", "imbalance")):
        val = getattr(args, attr, None)
        if val is not None:
            out[key] = val
    return out


def synthetic_batch(
    rng: np.random.Generator,
    cfg,
    batch_size: int,
    n_points: int = 20000,
    weak_ratio: float = 0.002,
) -> dict[str, np.ndarray]:
    """Device-batch dict exactly as the data pipeline emits it.

    Keys: features (B,H,W,5) raw feature image, train_label / eval_label
    (B,H,W) int32, point_px / point_py (B,P) int32, point_label (B,P) int32,
    point_weak_label (B,P) int32, point_valid (B,P) bool.
    """
    from coarse3d_tpu_torch.ops import projection

    sensor = cfg.sensor
    max_points = cfg.data.max_points
    out = {k: [] for k in (
        "features", "train_label", "eval_label", "point_px", "point_py",
        "point_depth", "point_label", "point_weak_label", "point_valid")}
    for _ in range(batch_size):
        scan = synthetic_scan(
            rng, n_points, cfg.data.n_classes, sensor, weak_ratio)
        proj = projection.range_project_np(scan["points"], sensor)
        feats = projection.build_range_features(
            proj["proj_points"], proj["proj_range"], xp=np)
        out["features"].append(feats)
        out["eval_label"].append(
            projection.scatter_labels_np(proj["proj_idx"], scan["labels"]))
        out["train_label"].append(
            projection.scatter_labels_np(
                proj["proj_idx"], scan["weak_labels"]))
        px, pv = pad_points(proj["px"], max_points)
        depth, _ = pad_points(proj["depth"].astype(np.float32), max_points,
                              fill=-1.0)
        py, _ = pad_points(proj["py"], max_points)
        lbl, _ = pad_points(scan["labels"], max_points)
        wlbl, _ = pad_points(scan["weak_labels"], max_points)
        out["point_px"].append(px)
        out["point_py"].append(py)
        out["point_depth"].append(depth)
        out["point_label"].append(lbl)
        out["point_weak_label"].append(wlbl)
        out["point_valid"].append(pv)
    return {k: np.stack(v) for k, v in out.items()}


def pad_points(
    arr: np.ndarray, max_points: int, fill=0
) -> tuple[np.ndarray, np.ndarray]:
    """Pad (N, ...) to (max_points, ...) returning the validity mask.

    Mirrors the reference's fixed `max_points` padding convention
    (wss_sem_kitti_loader.py:198-222) but with an explicit mask instead of
    the implicit "padded points map to pixel (0, 0)" convention.
    """
    n = arr.shape[0]
    assert n <= max_points, f"scan has {n} > max_points={max_points}"
    out_shape = (max_points,) + arr.shape[1:]
    out = np.full(out_shape, fill, dtype=arr.dtype)
    out[:n] = arr
    valid = np.zeros(max_points, dtype=bool)
    valid[:n] = True
    return out, valid
