"""Pluggable lookup strategies for the EmbeddingEngine
(``repro.engine.strategies`` in torch, forward path).

A ``LookupStrategy`` owns the per-group sparse hot path: how packed IDs turn
into rows. This slice ports the registry and ``picasso`` (K-Packed
Unique&Partition, fixed-capacity Shuffle, HybridHash hot tier on the read
path). The other strategies and every ``apply_grads`` come with later
slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Type

import torch

from repro_torch.core import packed_embedding as pe
from repro_torch.embedding.state import EmbeddingState

_REGISTRY: Dict[str, Type["LookupStrategy"]] = {}


def register_strategy(name: str):
    """Class decorator: make a LookupStrategy selectable by name."""

    def deco(cls: Type["LookupStrategy"]) -> Type["LookupStrategy"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_strategy(name: str) -> Type["LookupStrategy"]:
    """Resolve a strategy class by name; unknown names raise with the menu."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown lookup strategy {name!r}; available in the port: "
            f"{', '.join(available_strategies())}") from None


class LookupStrategy:
    """Base class: per-group sparse forward, parameterized once."""

    name = "base"
    uses_cache = False        # whether the HybridHash hot tier participates

    def __init__(self, *, world: int, capacity: Dict[int, int],
                 use_fused: Optional[bool] = None):
        self.world = world
        self.capacity = capacity
        # resolved kernels.ops override: None = kernel where tensors are on CUDA
        self.use_fused = use_fused

    def lookup(self, st: EmbeddingState, gid: int, ids: torch.Tensor,
               *, cache_on: bool = False) -> Tuple[torch.Tensor, Any]:
        """ids [n] -> (rows [n, D], ctx). ``ctx.inv`` maps positions to rows."""
        raise NotImplementedError


@register_strategy("picasso")
class PicassoStrategy(LookupStrategy):
    """Full packed/interleaved/cached path (paper §III-B/D): fixed-shape
    unique -> cache probe -> partition -> Shuffle -> local gather -> Shuffle
    back -> Stitch (+ hot-tier merge)."""

    uses_cache = True

    def lookup(self, st, gid, ids, *, cache_on=False):
        return pe.mp_lookup(
            st.w, ids, world=self.world, capacity=self.capacity[gid],
            hot_keys=st.cache.keys if cache_on else None,
            hot_rows=st.cache.rows if cache_on else None,
            fused=self.use_fused)
