"""Typed experiment configuration (the port's own copy).

A field-for-field copy of the JAX package's ``configs/config.py``, kept here
so the PyTorch port never imports the JAX package. Configs written for one
load unchanged in the other; ``tests/test_torch_isolation.py`` holds the two
copies to the same presets.

The reference drives everything from one flat YAML per dataset loaded into an
``Option`` object (tasks/weak_segmentation/option.py:12 and
config_semantic_kitti.yaml). Here the same knobs live in frozen dataclasses
(hashable, so they can key caches), with YAML loading + presets for the three
shipped datasets.

Hyperparameters mirror the reference task configs
(config_semantic_kitti.yaml:20-153, config_semantic_poss.yaml,
config_nuscenes.yaml): contrastive block, training block, per-class counts for
loss weighting, augmentation probabilities, and sensor geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import yaml


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """Spherical range-image geometry (reference: sensor block of task YAMLs).

    ``img_mean``/``img_stds`` are per-channel statistics of the 5-channel
    (range, x, y, z, intensity) projected feature image.
    """

    name: str = "HDL64"
    proj_h: int = 64
    proj_w: int = 2048
    fov_up: float = 3.0
    fov_down: float = -25.0
    fov_left: float = -180.0
    fov_right: float = 180.0
    img_mean: tuple[float, ...] = (12.12, 10.88, 0.23, -1.04, 0.21)
    img_stds: tuple[float, ...] = (12.32, 11.47, 6.91, 0.86, 0.16)
    # SemanticPOSS clamps range at 200m (reference semantic_poss.py:173).
    max_depth: float = 0.0  # 0 = no clamp

    def __post_init__(self):
        assert self.fov_up >= 0 and self.fov_down <= 0, (
            "require fov_up >= 0 and fov_down <= 0, got "
            f"{self.fov_up}/{self.fov_down}"
        )
        assert self.fov_right >= 0 and self.fov_left <= 0


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Point-cloud augmentation (reference: augmentor.py:7-143 + YAML block)."""

    p_flipx: float = 0.0
    p_flipy: float = 0.5
    p_transx: float = 0.5
    trans_xmin: float = -5.0
    trans_xmax: float = 5.0
    p_transy: float = 0.5
    trans_ymin: float = -3.0
    trans_ymax: float = 3.0
    p_transz: float = 0.5
    trans_zmin: float = -1.0
    trans_zmax: float = 0.0
    p_rot_roll: float = 0.5
    rot_rollmin: float = -5.0
    rot_rollmax: float = 5.0
    p_rot_pitch: float = 0.5
    rot_pitchmin: float = -5.0
    rot_pitchmax: float = 5.0
    p_rot_yaw: float = 0.5
    # NOTE: the reference ships yawmin=5, yawmax=-5 (an inverted interval that
    # random.uniform still samples from); preserved verbatim for parity.
    rot_yawmin: float = 5.0
    rot_yawmax: float = -5.0


@dataclasses.dataclass(frozen=True)
class ContrastConfig:
    """Prototype-contrast block (reference: config_semantic_kitti.yaml:20-26)."""

    contrast_warmup: int = 5
    loss_w_contrast: float = 0.1
    temperature: float = 0.07
    base_temperature: float = 0.07
    num_anchor: int = 512
    entropy_selection: bool = True
    sub_proto_size: int = 20
    # EMA time-constant is 1/(1-m) optimizer steps: 0.999 == 1000 steps,
    # ~0.4 epoch on the reference's KITTI schedule (~2.4k steps/epoch). On
    # short schedules (few steps/epoch) the memory never leaves random init
    # and contrast silently degenerates into the frozen-prototype mode —
    # scale m so 1/(1-m) stays a sub-epoch fraction of training
    # (PERF.md "r3 ablation grid, phase 1").
    proto_momentum: float = 0.999
    # Stagger knob (beyond the reference, which activates selection and the
    # prototype EMA together at contrast_warmup): epoch at which entropy
    # selection starts contributing pseudo anchors; None = contrast_warmup.
    # Until then the select ratio is held at 0, which degenerates
    # entropy_based_selection to exactly the weak-only anchor path (k=0 for
    # every segment), so the EMA memory forms on clean weak anchors before
    # noisy pseudo labels join — the composition the r4 balanced ablation
    # grid suggested (each mechanism helps alone, together they cancel;
    # PERF.md "r4 phase-2 secondary arms").
    selection_warmup: int | None = None
    proj_dim: int = 256
    # Fixed per-class pixel budget for the masked Sinkhorn / EMA prototype
    # update (the reference gathers dynamic `label == c` subsets,
    # salsanext_proto.py:354-359; on TPU this becomes a fixed-shape gather).
    max_pixels_per_class: int = 2048
    # Reference defect #2 (SURVEY §5.1): `use_prototype` defaults False so the
    # shipped trainer contrasts against frozen random prototypes. We default
    # the EMA update ON (the paper's mechanism); set False for shipped-code
    # parity.
    use_prototype: bool = True
    # Bitwise-parity replication of the reference's DDP prototype sync
    # (salsanext_proto.py:397-400): each replica EMA-updates from its LOCAL
    # batch shard, then the memories are mean-all-reduced WITHOUT a final
    # re-normalization. Default False uses the global contraction (one
    # Sinkhorn over the global batch under pjit — sharper; see
    # models/prototypes.py).
    ddp_parity_protos: bool = False


@dataclasses.dataclass(frozen=True)
class KnnConfig:
    """KNN range post-processing (reference: postproc/knn.py:36-52).

    Defaults follow the RangeNet++ lidar-bonnetal convention the reference
    code was lifted from (it ships no YAML block — SURVEY §5.1 defect #10).
    """

    knn: int = 5
    search: int = 5
    sigma: float = 1.0
    cutoff: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    net_type: str = "salsanext"  # salsanext | rangenet | squeezesegv3
    in_channels: int = 5
    base_channels: int = 32
    # rangenet/squeezesegv3 depth selector (21 or 53 layer darknet-style).
    layers: int = 21
    dropout_rate: float = 0.2
    # bf16 activations / fp32 params is the TPU-native default; fp32
    # activations available for parity checks.
    compute_dtype: str = "bfloat16"
    # "parity" = the reference architecture; "s2d" = TPU-native
    # space-to-depth stem (salsanext only): the network runs at half
    # resolution on 4x-stacked pixels and predicts 2x2 logits per coarse
    # pixel via pixel-shuffle; "s2d_w" = width-only 1x2 variant (full row
    # resolution, half width) — the middle ground for texture-carried
    # tasks where the 2x2 stem measurably costs accuracy. NOT
    # weight-compatible with the reference — opt-in for throughput
    # (PERF.md "space-to-depth stem" table).
    stem: str = "parity"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_epochs: int = 100
    batch_size_train: int = 4  # per replica, matching 4/GPU in run.sh
    batch_size_val: int = 4
    lr: float = 0.01
    warmup_epochs: int = 1
    # torch AdamW default weight decay; the YAML's weight_decay is unused by
    # the reference (trainer.py:146-155, SURVEY §5.1 defect #5).
    weight_decay: float = 0.01
    loss_w_ce_2d: float = 1.0
    loss_w_lov_2d: float = 1.0
    focal_gamma: float = 2.0
    # valid-pixel cap for the Lovász sort (weak labels are ~0.1% of pixels;
    # see losses/lovasz.py). 0 disables the cap.
    lovasz_budget: int = 16384
    val_frequency: int = 1
    seed: int = 1
    ignore_cls: int = 0
    # Apply KNN range cleanup during training-time validation so
    # best-checkpoint selection matches the published (KNN-included) metric.
    # The reference selects on KNN-less validation (trainer.py:706-747 vs
    # SURVEY §5.1 defect #10) — default False keeps parity; flip for new runs.
    val_use_knn: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "semantic_kitti"  # semantic_kitti | semantic_poss | nuscenes
    n_classes: int = 20
    pcd_root: str = ""
    weak_root: str = ""
    weak_label_name: str = "0.1"
    train_seq: tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)
    val_seq: tuple[int, ...] = (8,)
    max_points: int = 150000
    # Per-class weak-label counts used for focal-loss alpha
    # (reference: cls_counts block; trainer.py:273-291,351-359).
    cls_counts: tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    sensor: SensorSpec = dataclasses.field(default_factory=SensorSpec)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    contrast: ContrastConfig = dataclasses.field(default_factory=ContrastConfig)
    knn: KnnConfig = dataclasses.field(default_factory=KnnConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    save_path: str = "experiments"
    experiment_id: str = "v1.0"


# ---------------------------------------------------------------------------
# Presets for the three shipped datasets.
# ---------------------------------------------------------------------------

_KITTI_CLS_COUNTS = (
    0.0, 1877, 9, 10, 80, 130, 22, 23, 2, 7809, 542, 5425, 205, 7718, 2856,
    15575, 334, 4564, 148, 38,
)

_POSS_CLS_COUNTS = (
    0.0, 86, 22, 390, 67, 1914, 32, 26, 10, 1168, 6, 98, 289, 973,
)

_NUSC_CLS_COUNTS = (
    0.0, 145, 4, 100, 615, 31, 4, 30, 14, 90, 262, 4654, 134, 1174, 1278,
    3668, 2530,
)


def preset(name: str) -> ExperimentConfig:
    """Build the reference-equivalent config for one of the three datasets."""
    if name in ("tiny", "synthetic"):
        # small everything: CPU smoke runs and CI
        return ExperimentConfig(
            data=DataConfig(dataset="synthetic", n_classes=8,
                            max_points=4096,
                            cls_counts=tuple([0.0] + [100.0] * 7)),
            sensor=SensorSpec(proj_h=16, proj_w=64),
            model=ModelConfig(compute_dtype="float32"),
            contrast=ContrastConfig(
                num_anchor=32, max_pixels_per_class=128, sub_proto_size=4,
                proj_dim=32),
        )
    if name in ("semantic_kitti", "kitti"):
        return ExperimentConfig(
            data=DataConfig(
                dataset="semantic_kitti",
                n_classes=20,
                train_seq=(0, 1, 2, 3, 4, 5, 6, 7, 9, 10),
                val_seq=(8,),
                max_points=150000,
                cls_counts=_KITTI_CLS_COUNTS,
            ),
            sensor=SensorSpec(),
        )
    if name in ("semantic_poss", "poss"):
        return ExperimentConfig(
            data=DataConfig(
                dataset="semantic_poss",
                n_classes=14,
                train_seq=(0, 1, 3, 4, 5),
                val_seq=(2,),
                max_points=72000,  # 40*1800; POSS scans are dense tag grids
                cls_counts=_POSS_CLS_COUNTS,
            ),
            sensor=SensorSpec(
                name="Pandar40P",
                proj_h=40,
                proj_w=1800,
                fov_up=15.0,
                fov_down=-25.0,
                img_mean=(23.6835, 0.6078, 1.6879, -0.6106, 14.8053),
                img_stds=(18.7819, 18.3021, 23.7248, 1.7326, 16.6886),
                max_depth=200.0,
            ),
        )
    if name in ("nuscenes", "nusc"):
        return ExperimentConfig(
            data=DataConfig(
                dataset="nuscenes",
                n_classes=17,
                train_seq=(),
                val_seq=(),
                # padding budget only — results are identical for any scan
                # that fits. HDL32E sweeps are <= ~35k points; the
                # reference's 150000 is the KITTI constant copied over
                # (wss_nuscenes_loader.py:19) and makes every point-rate op
                # (projection scatter, KNN gather, unprojection) run at
                # ~20% occupancy: 69.8 -> 129.4 scans/s/chip from this
                # field alone (PERF.md). pad_points fails loudly if a scan
                # ever exceeds it.
                max_points=40000,
                cls_counts=_NUSC_CLS_COUNTS,
            ),
            sensor=SensorSpec(
                name="HDL32E",
                proj_h=64,
                proj_w=2048,
                fov_up=15.0,
                fov_down=-35.0,
                img_mean=(9.5353, 0.0631, -0.2114, -0.4938, 18.7527),
                img_stds=(12.1666, 9.9376, 11.592, 1.7673, 22.0192),
            ),
        )
    if name in ("nuscenes_32", "nusc32"):
        # TPU-native opt-in: the reference projects the 32-beam HDL32E onto
        # a 64-row image (config_nuscenes.yaml keeps the KITTI 64x2048 grid),
        # so every other row is empty and the convs do 2x the work. A 32-row
        # grid matches the sensor; NOT weight-compatible with reference
        # checkpoints (like ModelConfig.stem="s2d" — see PERF.md).
        cfg = preset("nuscenes")
        return dataclasses.replace(
            cfg, sensor=dataclasses.replace(cfg.sensor, proj_h=32))
    raise ValueError(f"unknown preset: {name}")


def _update_dataclass(obj, overrides: Mapping[str, Any]):
    kwargs = {}
    for field in dataclasses.fields(obj):
        if field.name not in overrides:
            continue
        value = overrides[field.name]
        current = getattr(obj, field.name)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            value = _update_dataclass(current, value)
        elif isinstance(current, tuple) and isinstance(value, (list, tuple)):
            value = tuple(value)
        kwargs[field.name] = value
    return dataclasses.replace(obj, **kwargs)


def load_config(path: str) -> ExperimentConfig:
    """Load a YAML config: `preset: <name>` plus nested section overrides."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = preset(raw.pop("preset", "semantic_kitti"))
    return _update_dataclass(cfg, raw)


def apply_overrides(cfg: ExperimentConfig,
                    assignments: list[str]) -> ExperimentConfig:
    """Apply `section.key=value` CLI overrides (values parsed as YAML, so
    `train.lr=0.02`, `contrast.loss_w_contrast=0`, `model.stem=s2d`,
    `data.cls_counts=[0,1,2]` all coerce to the right types). The reference
    has no CLI overrides beyond --id (option.py); this replaces hand-editing
    the task YAML for one-off experiments."""
    nested: dict = {}
    for item in assignments:
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"--set expects section.key=value, got {item!r}")
        node = nested
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        parsed = yaml.safe_load(value)
        if value.strip() == "None":
            # YAML parses "None" as the *string* 'None'; a user writing
            # the Python spelling means null, not a string
            parsed = None
        elif parsed is None and not value.strip():
            # `--set train.lr=` parses to None and would surface as a
            # confusing failure deep in training; demand an explicit null
            # (any YAML null spelling — null/~/Null/NULL — passes through)
            raise ValueError(
                f"--set: empty value for {key.strip()!r} (write "
                f"{key.strip()}=null if you really mean None)")
        node[parts[-1]] = parsed
    # error on unknown keys instead of silently ignoring them
    def check(obj, tree, prefix=""):
        names = {f.name for f in dataclasses.fields(obj)}
        for k, v in tree.items():
            if k not in names:
                raise ValueError(
                    f"--set: unknown config field {prefix + k!r}")
            cur = getattr(obj, k)
            if isinstance(v, Mapping):
                if not dataclasses.is_dataclass(cur):
                    raise ValueError(
                        f"--set: {prefix + k!r} is not a section")
                check(cur, v, prefix + k + ".")
            elif dataclasses.is_dataclass(cur):
                # e.g. `--set train=0.01` (missing the `.lr`): replacing a
                # whole section with a scalar would blow up much later
                raise ValueError(
                    f"--set: {prefix + k!r} is a config section; set a "
                    f"field inside it, e.g. {prefix + k}.<field>=...")
    check(cfg, nested)
    return _update_dataclass(cfg, nested)
