from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    ShapeConfig,
    applicable_shapes,
    count_params,
    get_config,
    list_archs,
    non_embedding_params,
    smoke,
)

__all__ = [
    "ARCHS", "SHAPES", "ModelConfig", "MoEConfig", "RWKVConfig", "SSMConfig",
    "ShapeConfig", "applicable_shapes", "count_params", "get_config",
    "list_archs", "non_embedding_params", "smoke",
]
