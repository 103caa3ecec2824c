from repro_torch.engine.engine import (AUTO_NAMES, EmbeddingEngine, EngineContext,
                                      resolve_assignment)
from repro_torch.engine.strategies import (LookupStrategy, PicassoL2Strategy,
                                           PicassoNarrowStrategy, PicassoStrategy,
                                           available_strategies, get_strategy,
                                           register_strategy)

__all__ = [
    "AUTO_NAMES",
    "EmbeddingEngine",
    "EngineContext",
    "LookupStrategy",
    "PicassoL2Strategy",
    "PicassoNarrowStrategy",
    "PicassoStrategy",
    "available_strategies",
    "get_strategy",
    "register_strategy",
    "resolve_assignment",
]
