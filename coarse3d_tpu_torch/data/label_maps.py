"""Label taxonomies for SemanticKITTI / SemanticPOSS / nuScenes-lidarseg.

The port's own copy of the JAX package's ``data/label_maps.py``.

The raw-id -> train-id mappings, inverse maps, ignore flags, class names and
colors are standard public dataset metadata (the reference carries them as
YAML: pc_processor/dataset/semantic_kitti/semantic-kitti.yaml,
semantic_poss/semantic-poss.yaml, nuScenes/nuscenes.yaml). Here they are
plain Python data compiled into NumPy LUTs once at import; the LUTs are what
the pipeline applies (vectorized fancy-indexing, mirroring
dataset_semkitti.py:140-196 which also builds +100-slack LUTs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ---------------------------------------------------------------------------
# SemanticKITTI (20 train classes incl. ignore=0)
# ---------------------------------------------------------------------------

KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

KITTI_LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72, 18: 80,
    19: 81,
}

KITTI_CLASS_NAMES = (
    "unlabeled", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
)

# raw-id -> BGR-ish rgb triplets (SemanticKITTI convention)
KITTI_COLOR_MAP = {
    0: (255, 255, 255), 1: (0, 0, 255), 10: (245, 150, 100),
    11: (245, 230, 100), 13: (250, 80, 100), 15: (150, 60, 30),
    16: (255, 0, 0), 18: (180, 30, 80), 20: (255, 0, 0), 30: (30, 30, 255),
    31: (200, 40, 255), 32: (90, 30, 150), 40: (255, 0, 255),
    44: (255, 150, 255), 48: (75, 0, 75), 49: (75, 0, 175),
    50: (0, 200, 255), 51: (50, 120, 255), 52: (0, 150, 255),
    60: (170, 255, 150), 70: (0, 175, 0), 71: (0, 60, 135),
    72: (80, 240, 150), 80: (150, 240, 255), 81: (0, 0, 255),
    99: (255, 255, 50), 252: (245, 150, 100), 253: (200, 40, 255),
    254: (30, 30, 255), 255: (90, 30, 150), 256: (255, 0, 0),
    257: (250, 80, 100), 258: (180, 30, 80), 259: (255, 0, 0),
}

KITTI_SPLIT = {
    "train": (0, 1, 2, 3, 4, 5, 6, 7, 9, 10),
    "valid": (8,),
    "test": (11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21),
}

# ---------------------------------------------------------------------------
# SemanticPOSS (14 train classes incl. ignore=0)
# ---------------------------------------------------------------------------

POSS_LEARNING_MAP = {
    0: 0, 4: 1, 5: 1, 6: 2, 7: 3, 8: 4, 9: 5, 10: 6, 11: 6, 12: 6, 13: 7,
    14: 8, 15: 9, 16: 10, 17: 11, 21: 12, 22: 13,
}

POSS_LEARNING_MAP_INV = {
    0: 0, 1: 4, 2: 6, 3: 7, 4: 8, 5: 9, 6: 10, 7: 13, 8: 14, 9: 15, 10: 16,
    11: 17, 12: 21, 13: 22,
}

POSS_CLASS_NAMES = (
    "unlabeled", "people", "rider", "car", "trunk", "plants", "traffic-sign",
    "pole", "trashcan", "building", "cone/stone", "fence", "bike", "road",
)

POSS_COLOR_MAP = {
    0: (0, 0, 0), 1: (0, 0, 0), 2: (0, 0, 0), 3: (0, 0, 0),
    4: (255, 30, 30), 5: (255, 30, 30), 6: (255, 40, 200),
    7: (100, 150, 245), 8: (135, 60, 0), 9: (0, 175, 0), 10: (255, 0, 0),
    11: (255, 0, 0), 12: (255, 0, 0), 13: (255, 240, 150),
    14: (125, 255, 0), 15: (255, 200, 0), 16: (50, 255, 255),
    17: (255, 120, 50), 18: (0, 0, 0), 19: (0, 0, 0), 20: (0, 0, 0),
    21: (100, 230, 245), 22: (128, 128, 128),
}

POSS_SPLIT = {"train": (0, 1, 2, 4, 5), "valid": (3,)}

# ---------------------------------------------------------------------------
# nuScenes-lidarseg (17 train classes incl. ignore=0)
# ---------------------------------------------------------------------------

NUSC_LEARNING_MAP = {
    0: 0, 1: 0, 2: 7, 3: 7, 4: 7, 5: 0, 6: 7, 7: 0, 8: 0, 9: 1, 10: 0,
    11: 0, 12: 8, 13: 0, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 19: 0, 20: 0,
    21: 6, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 29: 0,
    30: 16, 31: 0,
}

NUSC_LEARNING_MAP_INV = {
    0: 0, 1: 9, 2: 14, 3: 16, 4: 17, 5: 18, 6: 21, 7: 7, 8: 12, 9: 22,
    10: 23, 11: 24, 12: 25, 13: 26, 14: 27, 15: 28, 16: 30,
}

NUSC_CLASS_NAMES = (
    "ignore", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
)

NUSC_COLOR_MAP = {
    0: (0, 0, 0), 1: (70, 130, 180), 2: (0, 0, 230), 3: (135, 206, 235),
    4: (100, 149, 237), 5: (219, 112, 147), 6: (0, 0, 128),
    7: (240, 128, 128), 8: (138, 43, 226), 9: (112, 128, 144),
    10: (210, 105, 30), 11: (105, 105, 105), 12: (47, 79, 79),
    13: (188, 143, 143), 14: (220, 20, 60), 15: (255, 127, 80),
    16: (255, 69, 0), 17: (255, 158, 0), 18: (233, 150, 70),
    19: (255, 83, 0), 20: (255, 215, 0), 21: (255, 61, 99),
    22: (255, 140, 0), 23: (255, 99, 71), 24: (0, 207, 191),
    25: (175, 0, 75), 26: (75, 0, 75), 27: (112, 180, 60),
    28: (222, 184, 135), 29: (255, 228, 196), 30: (0, 175, 0),
    31: (255, 240, 245),
}


@dataclasses.dataclass(frozen=True)
class LabelSpec:
    """Compiled LUT bundle for one dataset taxonomy."""

    n_classes: int
    class_names: tuple[str, ...]
    lut: np.ndarray          # raw id -> train id (int32, +100 slack)
    lut_inv: np.ndarray      # train id -> raw id
    color_lut: np.ndarray    # raw id -> rgb float (n_raw, 3) in [0, 1]
    ignore: tuple[int, ...] = (0,)

    def map_labels(self, raw: np.ndarray) -> np.ndarray:
        return self.lut[raw.astype(np.int64)]

    def unmap_labels(self, train_ids: np.ndarray) -> np.ndarray:
        return self.lut_inv[train_ids.astype(np.int64)]

    def train_color_lut(self) -> np.ndarray:
        """(n_classes, 3) colors in train-id order, [0, 1] floats."""
        return self.color_lut[self.lut_inv]


def _build(learning_map, learning_map_inv, color_map, names) -> LabelSpec:
    n_classes = len(learning_map_inv)
    # +100 slack mirrors the reference LUT sizing (dataset_semkitti.py:140-196)
    # so out-of-taxonomy raw ids index safely as 0.
    max_key = max(max(learning_map), max(color_map)) + 100
    lut = np.zeros(max_key + 1, dtype=np.int32)
    for raw_id, train_id in learning_map.items():
        lut[raw_id] = train_id
    lut_inv = np.zeros(n_classes, dtype=np.int32)
    for train_id, raw_id in learning_map_inv.items():
        lut_inv[train_id] = raw_id
    color_lut = np.zeros((max_key + 1, 3), dtype=np.float32)
    for raw_id, rgb in color_map.items():
        color_lut[raw_id] = np.asarray(rgb, dtype=np.float32) / 255.0
    return LabelSpec(
        n_classes=n_classes,
        class_names=tuple(names),
        lut=lut,
        lut_inv=lut_inv,
        color_lut=color_lut,
    )


_SPECS = {
    "semantic_kitti": lambda: _build(
        KITTI_LEARNING_MAP, KITTI_LEARNING_MAP_INV, KITTI_COLOR_MAP,
        KITTI_CLASS_NAMES),
    "semantic_poss": lambda: _build(
        POSS_LEARNING_MAP, POSS_LEARNING_MAP_INV, POSS_COLOR_MAP,
        POSS_CLASS_NAMES),
    "nuscenes": lambda: _build(
        NUSC_LEARNING_MAP, NUSC_LEARNING_MAP_INV, NUSC_COLOR_MAP,
        NUSC_CLASS_NAMES),
}

_CACHE: dict[str, LabelSpec] = {}


def get_label_spec(dataset: str) -> LabelSpec:
    if dataset not in _CACHE:
        _CACHE[dataset] = _SPECS[dataset]()
    return _CACHE[dataset]
