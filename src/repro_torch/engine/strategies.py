"""Pluggable lookup strategies for the EmbeddingEngine
(``repro.engine.strategies`` in torch).

A ``LookupStrategy`` owns the per-group sparse hot path: how packed IDs turn
into rows (``lookup``) and how row gradients update the state
(``apply_grads``). The port has the registry and three strategies:

``picasso``
    K-Packed Unique&Partition, fixed-capacity Shuffle, HybridHash hot tier
    on the read path; transposed Shuffle + dedup/row-wise Adagrad, hit
    grads into the tier or to their owners.
``picasso_l2``
    ``picasso`` with a second, larger cache tier behind the hot tier: L1
    misses probe L2, only ids in neither tier ride the Shuffle, and the
    flush ranks both tiers at once. A cold or disabled L2 is bitwise
    ``picasso``.
``picasso_narrow``
    ``picasso_l2`` with hot/cold widths: the tiers serve full-width rows
    while the cold master stores and routes ``d = plan.narrow_dim`` wide
    rows, widened at lookup through a learned ``[d, D]`` projection. A
    group the plan does not narrow runs ``picasso_l2`` exactly.

A strategy advertises its tiers through class attributes the engine gates
on per group: ``uses_cache`` (L1 where the plan budgets ``cache_rows``),
``uses_l2`` (L2 where the plan budgets ``l2_rows`` *and* L1 is active) and
``extra_metric_keys`` (the per-tier counters ``tier_metrics`` reports).
Every strategy's routed gradient hops honour ``grad_compress`` (``'none' |
'fp16' | 'topk'``, ``optim.grad_compression``). The other strategies come
with later slices.
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
    uses_l2 = False           # whether the L2 tier participates
    extra_metric_keys: Tuple[str, ...] = ()  # keys tier_metrics reports

    def __init__(self, *, world: int, capacity: Dict[int, int], lr: float = 0.05,
                 eps: float = 1e-8, cache_update: str = "psum",
                 use_fused: Optional[bool] = None, grad_compress: str = "none"):
        self.world = world
        self.capacity = capacity
        self.lr = lr
        self.eps = eps
        self.cache_update = cache_update
        # resolved kernels.ops override: None = kernel where tensors are on CUDA
        self.use_fused = use_fused
        # wire compression of the routed sparse-gradient payload
        self.grad_compress = grad_compress

    def lookup(self, st: EmbeddingState, gid: int, ids: torch.Tensor,
               *, cache_on: bool = False, l2_on: bool = False
               ) -> Tuple[torch.Tensor, Any]:
        """ids [n] -> (rows [n, D], ctx). ``ctx.inv`` maps positions to rows."""
        raise NotImplementedError

    def apply_grads(self, st: EmbeddingState, gid: int, ctx: Any, g_rows: torch.Tensor,
                    *, cache_on: bool = False, l2_on: bool = False
                    ) -> Tuple[EmbeddingState, torch.Tensor, torch.Tensor]:
        """Row grads -> updated state. Returns (state, overflow, cache_hits);
        ``cache_hits`` counts ids served by any tier."""
        raise NotImplementedError

    def tier_metrics(self, ctx: Any) -> Dict[str, torch.Tensor]:
        """Per-tier counters of one lookup, exactly ``extra_metric_keys``
        (int32 scalars) whether or not a tier was warm."""
        return {}


@register_strategy("picasso")
class PicassoStrategy(LookupStrategy):
    """Full packed/interleaved/cached path (paper §III-B/D).

    Forward: fixed-shape unique -> cache probe -> partition -> Shuffle ->
    local gather -> Shuffle back -> Stitch (+ hot-tier merge). Backward:
    transposed Shuffle for miss grads; hit grads into the hot tier
    ('psum') or routed to their owners ('stale'); FCounter update. The
    state's tensors are updated in place."""

    uses_cache = True

    def lookup(self, st, gid, ids, *, cache_on=False, l2_on=False):
        return pe.mp_lookup(
            st.w, ids, world=self.world, capacity=self.capacity[gid],
            hot_keys=st.cache.keys if cache_on else None,
            hot_rows=st.cache.rows if cache_on else None,
            fused=self.use_fused)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        w2, acc2, cache2 = pe.apply_sparse_grads(
            st.w, st.acc, st.cache if cache_on else None, ctx, g_rows,
            world=self.world, lr=self.lr, eps=self.eps,
            cache_update=self.cache_update, fused=self.use_fused,
            compress=self.grad_compress)
        counts2 = pe.count_frequencies(st.counts, ctx)
        # an unused L2 tier is kept as it is
        st2 = st._replace(w=w2, acc=acc2, counts=counts2,
                          cache=cache2 if cache2 is not None else st.cache)
        return (st2, ctx.routing.overflow.to(torch.int32),
                pe.cache_hit_count(ctx).to(torch.int32))


@register_strategy("picasso_l2")
class PicassoL2Strategy(PicassoStrategy):
    """PICASSO with a two-level parameter cache: the L1 hot tier and, behind
    it, a larger L2 tier (the reference places it in pinned host memory;
    the port keeps it on the card). Unique ids probe L1, the L1 misses probe
    L2, and only the rest ride the Shuffle.

    The backward follows ``cache_update`` as for L1 (``'psum'``: both tiers
    authoritative between flushes; ``'stale'``: the union of tier hits is
    routed to the owners). The flush (``pe.flush_cache_l2``) ranks one
    top-(H1+H2) and splits it. With ``l2_on=False`` every path is bitwise
    ``picasso``; with the tier on but cold, lookups and updates are too, but
    the FCounter also counts tier hits (``count_hit_frequencies``), so
    rankings may part from ``picasso`` once L1 is warm, by design."""

    uses_l2 = True
    extra_metric_keys = ("cache_hits/l1", "cache_hits/l2")

    def lookup(self, st, gid, ids, *, cache_on=False, l2_on=False):
        if not l2_on or st.l2 is None:
            return super().lookup(st, gid, ids, cache_on=cache_on)
        return pe.mp_lookup(
            st.w, ids, world=self.world, capacity=self.capacity[gid],
            hot_keys=st.cache.keys if cache_on else None,
            hot_rows=st.cache.rows if cache_on else None,
            l2_keys=st.l2.keys, l2_rows=st.l2.rows, fused=self.use_fused)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        if not l2_on or st.l2 is None or ctx.l2_hit is None:
            return super().apply_grads(st, gid, ctx, g_rows, cache_on=cache_on)
        w2, acc2, cache2, l22 = pe.apply_sparse_grads_l2(
            st.w, st.acc, st.cache if cache_on else None, st.l2, ctx, g_rows,
            world=self.world, lr=self.lr, eps=self.eps,
            cache_update=self.cache_update, fused=self.use_fused,
            compress=self.grad_compress)
        counts2 = pe.count_frequencies(st.counts, ctx)
        # tier-served ids never route, so they are counted here, or the flush
        # ranking would evict the resident (hottest) rows
        counts2 = pe.count_hit_frequencies(counts2, ctx, ctx.hit | ctx.l2_hit,
                                           world=self.world)
        st2 = st._replace(w=w2, acc=acc2, counts=counts2,
                          cache=cache2 if cache2 is not None else st.cache, l2=l22)
        hits = pe.cache_hit_count(ctx) + pe.l2_hit_count(ctx)
        return st2, ctx.routing.overflow.to(torch.int32), hits.to(torch.int32)

    def tier_metrics(self, ctx):
        return {"cache_hits/l1": pe.cache_hit_count(ctx).to(torch.int32),
                "cache_hits/l2": pe.l2_hit_count(ctx).to(torch.int32)}


@register_strategy("picasso_narrow")
class PicassoNarrowStrategy(PicassoL2Strategy):
    """Frequency-adaptive widths: hot ids wide, cold ids narrow.

    Ids in either tier are served full-width rows as in ``picasso_l2``; the
    rest ride the Shuffle at the planned narrow width ``d`` (the master is
    ``[rows, d]``) and one ``ops.gather_project`` pass widens them through
    the learned ``[d, D]`` projection ``st.proj``. The backward folds the
    wide cotangent through ``proj^T`` once, routes narrow gradients, updates
    the wide tiers and trains the projection (``pe.apply_sparse_grads_narrow``);
    the flush (``pe.flush_cache_narrow``) widens ids heating into a tier,
    keeps resident ids' exact wide rows and narrows cooling ids through the
    pseudo-inverse. A group the plan does not narrow (``st.proj is None``)
    runs ``picasso_l2`` exactly."""

    def lookup(self, st, gid, ids, *, cache_on=False, l2_on=False):
        if st.proj is None:  # not narrowed on this plan: the L2 path
            return super().lookup(st, gid, ids, cache_on=cache_on, l2_on=l2_on)
        with_l2 = l2_on and st.l2 is not None
        return pe.mp_lookup_narrow(
            st.w, ids, proj=st.proj.kernel, world=self.world,
            capacity=self.capacity[gid],
            hot_keys=st.cache.keys if cache_on else None,
            hot_rows=st.cache.rows if cache_on else None,
            l2_keys=st.l2.keys if with_l2 else None,
            l2_rows=st.l2.rows if with_l2 else None, fused=self.use_fused)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        if st.proj is None:
            return super().apply_grads(st, gid, ctx, g_rows, cache_on=cache_on,
                                       l2_on=l2_on)
        with_l2 = l2_on and st.l2 is not None and ctx.l2_hit is not None
        w2, acc2, cache2, l22, proj2 = pe.apply_sparse_grads_narrow(
            st.w, st.acc, st.cache if cache_on else None, st.l2 if with_l2 else None,
            st.proj, ctx, g_rows, world=self.world, lr=self.lr, eps=self.eps,
            cache_update=self.cache_update, fused=self.use_fused,
            compress=self.grad_compress)
        counts2 = pe.count_frequencies(st.counts, ctx)
        if cache_on or with_l2:
            both = ctx.hit if ctx.l2_hit is None else ctx.hit | ctx.l2_hit
            counts2 = pe.count_hit_frequencies(counts2, ctx, both, world=self.world)
        st2 = st._replace(w=w2, acc=acc2, counts=counts2,
                          cache=cache2 if cache2 is not None else st.cache,
                          l2=l22 if with_l2 else st.l2, proj=proj2)
        hits = pe.cache_hit_count(ctx) + pe.l2_hit_count(ctx)
        return st2, ctx.routing.overflow.to(torch.int32), hits.to(torch.int32)
