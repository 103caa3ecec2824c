"""Unified embedding engine (``repro.engine`` in torch): the engine, every
registry strategy class and helper, and the assignment compiler, so
launchers and tests import from one place."""
from repro_torch.core.assign import (AUTO_NAMES, GroupScore, StrategyAssignment,
                                     apply_assignment, compile_assignment,
                                     estimate_l2_gain, estimate_narrow_gain,
                                     estimate_skew, maybe_compile, resolve_assignment)
from repro_torch.engine.engine import EmbeddingEngine, EngineContext, export_stats
from repro_torch.engine.strategies import (AllGatherRowsStrategy, HybridStrategy,
                                           LookupStrategy, MPNoDedupStrategy,
                                           PicassoL2Strategy, PicassoNarrowStrategy,
                                           PicassoStrategy, PSStrategy,
                                           available_strategies, get_strategy,
                                           register_strategy)

__all__ = [
    "AUTO_NAMES",
    "AllGatherRowsStrategy",
    "EmbeddingEngine",
    "EngineContext",
    "GroupScore",
    "HybridStrategy",
    "LookupStrategy",
    "MPNoDedupStrategy",
    "PSStrategy",
    "PicassoL2Strategy",
    "PicassoNarrowStrategy",
    "PicassoStrategy",
    "StrategyAssignment",
    "apply_assignment",
    "available_strategies",
    "compile_assignment",
    "estimate_l2_gain",
    "estimate_narrow_gain",
    "estimate_skew",
    "export_stats",
    "get_strategy",
    "maybe_compile",
    "register_strategy",
    "resolve_assignment",
]
