from repro_torch.configs.base import (FeatureField, InteractionSpec, ShapeSpec,
                                      WDLConfig, get_config, get_shapes, list_archs,
                                      register_arch)

__all__ = [
    "FeatureField",
    "InteractionSpec",
    "ShapeSpec",
    "WDLConfig",
    "get_config",
    "get_shapes",
    "list_archs",
    "register_arch",
]
