from coarse3d_tpu_torch.configs.config import (
    AugmentConfig,
    ContrastConfig,
    DataConfig,
    ExperimentConfig,
    KnnConfig,
    ModelConfig,
    SensorSpec,
    TrainConfig,
    apply_overrides,
    load_config,
    preset,
)

__all__ = [
    "AugmentConfig",
    "ContrastConfig",
    "DataConfig",
    "ExperimentConfig",
    "KnnConfig",
    "ModelConfig",
    "SensorSpec",
    "TrainConfig",
    "apply_overrides",
    "load_config",
    "preset",
]
