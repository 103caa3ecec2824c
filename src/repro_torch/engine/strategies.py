"""Pluggable lookup strategies for the EmbeddingEngine
(``repro.engine.strategies`` in torch).

A ``LookupStrategy`` owns the per-group sparse hot path: how packed IDs turn
into rows (``lookup``) and how row gradients update the state
(``apply_grads``). The port has the registry and ``picasso`` (K-Packed
Unique&Partition, fixed-capacity Shuffle, HybridHash hot tier on the read
path; transposed Shuffle + dedup/row-wise Adagrad, hit grads into the tier
or to their owners). The other strategies come with later slices.
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
    """Base class: per-group sparse forward/backward, parameterized once."""

    name = "base"
    uses_cache = False        # whether the HybridHash hot tier participates

    def __init__(self, *, world: int, capacity: Dict[int, int], lr: float = 0.05,
                 eps: float = 1e-8, cache_update: str = "psum",
                 use_fused: Optional[bool] = None):
        self.world = world
        self.capacity = capacity
        self.lr = lr
        self.eps = eps
        self.cache_update = cache_update
        # resolved kernels.ops override: None = kernel where tensors are on CUDA
        self.use_fused = use_fused

    def lookup(self, st: EmbeddingState, gid: int, ids: torch.Tensor,
               *, cache_on: bool = False) -> Tuple[torch.Tensor, Any]:
        """ids [n] -> (rows [n, D], ctx). ``ctx.inv`` maps positions to rows."""
        raise NotImplementedError

    def apply_grads(self, st: EmbeddingState, gid: int, ctx: Any, g_rows: torch.Tensor,
                    *, cache_on: bool = False
                    ) -> Tuple[EmbeddingState, torch.Tensor, torch.Tensor]:
        """Row grads -> updated state. Returns (state, overflow, cache_hits)."""
        raise NotImplementedError


@register_strategy("picasso")
class PicassoStrategy(LookupStrategy):
    """Full packed/interleaved/cached path (paper §III-B/D).

    Forward: fixed-shape unique -> cache probe -> partition -> Shuffle ->
    local gather -> Shuffle back -> Stitch (+ hot-tier merge). Backward:
    transposed Shuffle for miss grads; hit grads into the hot tier
    ('psum') or routed to their owners ('stale'); FCounter update. The
    state's tensors are updated in place."""

    uses_cache = True

    def lookup(self, st, gid, ids, *, cache_on=False):
        return pe.mp_lookup(
            st.w, ids, world=self.world, capacity=self.capacity[gid],
            hot_keys=st.cache.keys if cache_on else None,
            hot_rows=st.cache.rows if cache_on else None,
            fused=self.use_fused)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False):
        w2, acc2, cache2 = pe.apply_sparse_grads(
            st.w, st.acc, st.cache if cache_on else None, ctx, g_rows,
            world=self.world, lr=self.lr, eps=self.eps,
            cache_update=self.cache_update, fused=self.use_fused)
        counts2 = pe.count_frequencies(st.counts, ctx)
        st2 = EmbeddingState(w=w2, acc=acc2, counts=counts2,
                             cache=cache2 if cache2 is not None else st.cache, l2=st.l2)
        return (st2, ctx.routing.overflow.to(torch.int32),
                pe.cache_hit_count(ctx).to(torch.int32))
