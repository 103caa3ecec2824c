from repro_torch.configs.base import (FeatureField, InteractionSpec, LMConfig, MoESpec,
                                      SchNetConfig, ShapeSpec, WDLConfig, get_config,
                                      get_shapes, list_archs, register_arch, skipped_shapes)

__all__ = [
    "FeatureField",
    "InteractionSpec",
    "LMConfig",
    "MoESpec",
    "SchNetConfig",
    "ShapeSpec",
    "WDLConfig",
    "get_config",
    "get_shapes",
    "list_archs",
    "register_arch",
    "skipped_shapes",
]
