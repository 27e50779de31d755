from coarse3d_tpu_torch.visualizer.vis import (
    colorize_labels,
    composite_panel,
    dilate_rgb,
    normalize_range_image,
    save_ply,
)

__all__ = [
    "colorize_labels",
    "composite_panel",
    "dilate_rgb",
    "normalize_range_image",
    "save_ply",
]
