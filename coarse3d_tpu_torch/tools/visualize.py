"""Offline scan visualization CLI.

Port of the JAX package's ``tools/visualize.py``. Behavioral model: the
reference's standalone viewer scripts (pc_processor/visualizer/
{visualizer.py,vis_as_ply.py}): load a scan (+ optional labels / weak
labels / weights for predictions), colorize, and export. The reference
opens open3d windows; this writes PLY point clouds and a range-image panel
PNG instead (a ``.npy`` of the panel where PIL is missing).

``--weights`` is a reference-named ``.pth`` (the reference's own
checkpoints, ``tools/export_torch_ckpt.py``'s output or
``torch.save(model.state_dict())`` of the port); the prediction runs the
serving path (``eval/inference.py:make_inference_fn``: projection, the
model, ``--knn``) on ``--device``, the card by default. The panels come
from the host projection (``ops/projection.py:range_project_np``), as in
the JAX tool.

  python -m coarse3d_tpu_torch.tools.visualize --preset semantic_kitti \
      --scan .../000000.bin [--label .../000000.label] \
      [--weak .../000000.npy] [--weights model.pth [--knn]] \
      --out outdir/
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="semantic_kitti")
    p.add_argument("--config")
    p.add_argument("--scan", required=True, help=".bin pointcloud")
    p.add_argument("--label", help="full .label file (KITTI format)")
    p.add_argument("--weak", help="weak .npy file")
    p.add_argument("--weights",
                   help="reference-named .pth state dict for predictions")
    p.add_argument("--knn", action="store_true")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="device of the prediction: 'cuda' (default; fails "
                        "without a card) or 'cpu'")
    args = p.parse_args(argv)

    import numpy as np

    from coarse3d_tpu_torch.configs import load_config, preset
    from coarse3d_tpu_torch.data import readers
    from coarse3d_tpu_torch.data.label_maps import get_label_spec
    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.ops import projection
    from coarse3d_tpu_torch.visualizer.vis import (
        colorize_labels,
        normalize_range_image,
        save_ply,
    )

    device = resolve_device(args.device)
    cfg = load_config(args.config) if args.config else preset(args.preset)
    spec = get_label_spec(cfg.data.dataset)
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.scan))[0]

    points = readers.read_kitti_scan(args.scan)
    labels = None
    if args.label:
        raw, _ = readers.read_kitti_label(args.label)
        labels = spec.map_labels(raw)
    weak = np.load(args.weak).reshape(-1) if args.weak else None

    proj = projection.range_project_np(points, cfg.sensor)
    panels = [np.stack([normalize_range_image(proj["proj_range"])] * 3, -1)]

    if labels is not None:
        save_ply(os.path.join(args.out, f"{stem}_gt.ply"), points[:, :3],
                 colorize_labels(labels, spec))
        panels.append(
            colorize_labels(projection.scatter_labels_np(
                proj["proj_idx"], labels), spec))
    if weak is not None:
        panels.append(
            colorize_labels(projection.scatter_labels_np(
                proj["proj_idx"], weak), spec))

    pred = None
    if args.weights:
        import torch

        from coarse3d_tpu_torch.data.synthetic import pad_points
        from coarse3d_tpu_torch.eval.inference import make_inference_fn
        from coarse3d_tpu_torch.tools.convert_jax_params import (
            load_reference_state_dict,
        )
        from coarse3d_tpu_torch.train.setup import build_model

        model = build_model(cfg, device=device)
        model.load_state_dict(load_reference_state_dict(args.weights),
                              strict=True)
        infer = make_inference_fn(model, cfg, use_knn=args.knn)
        pts_p, valid = pad_points(points, cfg.data.max_points, fill=0.0)
        pred = infer(torch.from_numpy(pts_p[None]),
                     torch.from_numpy(valid[None])).cpu().numpy()[0][valid]
        save_ply(os.path.join(args.out, f"{stem}_pred.ply"), points[:, :3],
                 colorize_labels(pred, spec))
        panels.append(
            colorize_labels(projection.scatter_labels_np(
                proj["proj_idx"], pred.astype(np.int32)), spec))
        if labels is not None:
            err = (pred != labels) & (labels > 0)
            err_img = projection.scatter_labels_np(
                proj["proj_idx"], err.astype(np.int32))
            panels.append(np.stack(
                [err_img.astype(np.float32),
                 np.zeros_like(err_img, np.float32),
                 np.zeros_like(err_img, np.float32)], -1))

    panel = np.concatenate([np.clip(p, 0, 1) for p in panels], axis=0)
    png = os.path.join(args.out, f"{stem}_panel.png")
    try:
        from PIL import Image

        Image.fromarray((panel * 255).astype(np.uint8)).save(png)
    except ImportError:  # PIL-less image: raw npy fallback
        png = png.replace(".png", ".npy")
        np.save(png, (panel * 255).astype(np.uint8))
    print(f"wrote {stem}: {len(panels)} panel rows -> {png}")
    return png


if __name__ == "__main__":
    main()
