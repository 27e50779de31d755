"""Visualization: PLY export, label colorization, qualitative panels (the
port's copy of the JAX package's ``visualizer/vis.py``).

Behavioral models: pc_processor/visualizer/vis_as_ply.py (PLY export with
label colorization), Trainer._combineTensorboradImages (trainer.py:379-445 —
weak | prediction | ground-truth | error rows with the weak row dilated so
sparse labels are visible). The reference's open3d interactive viewers are
offline-only tools (SURVEY §2); here everything is headless: PLY files render
in any viewer and the panels go to the metric writer. No open3d / plyfile
dependency — PLY is written directly; dilation uses cv2 when present, else a
NumPy max-pool.
"""

from __future__ import annotations

import numpy as np

from coarse3d_tpu_torch.data.label_maps import LabelSpec


def save_ply(path: str, xyz: np.ndarray, colors: np.ndarray | None = None,
             binary: bool = True) -> None:
    """Write an (N, 3) cloud (+ optional (N, 3) float [0,1] colors) as PLY."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    has_color = colors is not None
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        rgb = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(
                    n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = xyz
                rec["rgb"] = rgb
                f.write(rec.tobytes())
            else:
                f.write(xyz.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = "%g %g %g" % tuple(xyz[i])
                if has_color:
                    row += " %d %d %d" % tuple(rgb[i])
                f.write((row + "\n").encode())


def colorize_labels(labels: np.ndarray, spec: LabelSpec,
                    black_unlabeled: bool = True) -> np.ndarray:
    """Train-id label map -> (..., 3) float RGB in [0, 1]."""
    lut = spec.train_color_lut().copy()
    if black_unlabeled:
        lut[0] = 0.0  # the reference forces white->black pre-dilate (:398)
    return lut[np.asarray(labels, np.int64)]


def normalize_range_image(img: np.ndarray) -> np.ndarray:
    """Per-image min-max normalize over valid (>=0) pixels
    (utils/tensor_ops.py:3-18 analog)."""
    valid = img >= 0
    if not valid.any():
        return np.zeros_like(img)
    lo, hi = img[valid].min(), img[valid].max()
    out = (img - lo) / max(hi - lo, 1e-6)
    return np.where(valid, np.clip(out, 0, 1), 0.0)


def dilate_rgb(rgb: np.ndarray, size: int = 5, iterations: int = 1
               ) -> np.ndarray:
    """Dilate an (H, W, 3) image (cv2.dilate analog, trainer.py:418)."""
    try:
        import cv2

        out = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        out = cv2.dilate(out, np.ones((size, size), np.uint8),
                         iterations=iterations)
        return out.astype(np.float32) / 255.0
    except ImportError:
        out = rgb
        pad = size // 2
        for _ in range(iterations):
            padded = np.pad(out, ((pad, pad), (pad, pad), (0, 0)))
            h, w = out.shape[:2]
            stacked = np.stack([
                padded[dy:dy + h, dx:dx + w]
                for dy in range(size) for dx in range(size)])
            out = stacked.max(axis=0)
        return out


def composite_panel(
    argmax: np.ndarray,
    full_label: np.ndarray,
    weak_label: np.ndarray,
    spec: LabelSpec,
    dilate_weak: bool = True,
) -> np.ndarray:
    """(4H, W, 3) float panel: dilated weak | prediction | GT | error
    (trainer.py:379-445)."""
    color_weak = colorize_labels(weak_label, spec)
    if dilate_weak:
        color_weak = dilate_rgb(color_weak)
    color_pred = colorize_labels(argmax, spec)
    color_full = colorize_labels(full_label, spec)
    error = ((full_label > 0) & (full_label != argmax)).astype(np.float32)
    error_rgb = np.repeat(error[..., None], 3, axis=-1)
    return np.concatenate(
        [color_weak, color_pred, color_full, error_rgb], axis=0)
