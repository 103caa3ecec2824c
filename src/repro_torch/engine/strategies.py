"""Pluggable lookup strategies for the EmbeddingEngine
(``repro.engine.strategies`` in torch).

A ``LookupStrategy`` owns the per-group sparse hot path: how packed IDs turn
into rows (``lookup``) and how row gradients update the state
(``apply_grads``). Strategies bind to groups: the engine dispatches each
packed group to the strategy its assignment names (``core.assign``), so a
plan can replicate its tiny tables with ``ps`` while it routes and caches
the big ones in the same step. The registry:

``picasso``
    K-Packed Unique&Partition, fixed-capacity Shuffle, HybridHash hot tier
    on the read path; transposed Shuffle + dedup/row-wise Adagrad, hit
    grads into the tier or to their owners.
``hybrid``
    ``picasso`` with the tier forced off: every unique id rides the Shuffle
    every step. On a plan built with ``enable_packing=False`` it is the
    paper's "MP without packing or cache" baseline (§II-C).
``ps``
    PS-style lookups (all_gather ids, psum partial rows): no routing, no
    dedup, no cache; the backward all_gathers per-id grads.
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
``mp_nodedup``
    The Shuffle without K-Packed dedup: every raw id, duplicates included,
    rides it. Exact against ``picasso`` on ``exact_capacity`` plans.
``allgather_rows``
    Dedup'd replication: the unique ids are served by ``ps_lookup`` and
    their row grads ride one all_gather back.

A strategy advertises its tiers through class attributes the engine gates
on per group: ``uses_cache`` (L1 where the plan budgets ``cache_rows``),
``uses_l2`` (L2 where the plan budgets ``l2_rows`` *and* L1 is active),
``uses_routing_ctx`` (its ctx carries the Shuffle's routing, which the
FCounter update reads) and ``extra_metric_keys`` (the per-tier counters
``tier_metrics`` reports). Every ctx carries ``inv``, and ``order`` and
``slot_sorted`` (a stable argsort of ``inv`` and ``inv`` in its order), so
the engine's backward ``segment_grad`` never sorts. Every strategy's routed
or gathered gradient hop honours ``grad_compress`` (``'none' | 'fp16' |
'topk'``, ``optim.grad_compression``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch.core import packed_embedding as pe
from repro_torch.dist.compat import WORLD1, Group, all_gather_tiled, resolve_group
from repro_torch.embedding.state import EmbeddingState
from repro_torch.optim import grad_compression as gcomp

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
            f"unknown lookup strategy {name!r}; available: "
            f"{', '.join(available_strategies())}") from None


class LookupStrategy:
    """Base class: per-group sparse forward/backward, parameterized once."""

    name = "base"
    uses_cache = False        # whether the HybridHash hot tier participates
    uses_l2 = False           # whether the L2 tier participates
    uses_routing_ctx = True   # ctx carries Shuffle routing (MP strategies)
    extra_metric_keys: Tuple[str, ...] = ()  # keys tier_metrics reports

    def __init__(self, *, world: int, capacity: Dict[int, int], lr: float = 0.05,
                 eps: float = 1e-8, cache_update: str = "psum",
                 use_fused: Optional[bool] = None, grad_compress: str = "none",
                 group: Optional[Group] = None):
        # this rank's group, where the reference holds its mesh axes
        self.group = resolve_group(world, group)
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

    def journal(self, j: Any, st: EmbeddingState, ctx: Any,
                *, cache_on: bool = False, l2_on: bool = False) -> None:
        """Save into ``j`` (``j.save(tensor, idx=None)``: the rows at
        ``idx``, or the whole tensor) every row ``apply_grads`` may write
        from this ``ctx`` under these flags, before it runs, so a rejected
        step can restore them (``train.train_step``). A strategy that writes
        more in ``apply_grads`` saves more here; one without this method
        cannot be guarded. No host sync."""
        raise NotImplementedError(f"strategy {self.name!r} keeps no journal")

    def tier_metrics(self, ctx: Any) -> Dict[str, torch.Tensor]:
        """Per-tier counters of one lookup, exactly ``extra_metric_keys``
        (int32 scalars) whether or not a tier was warm."""
        return {}


def _save_rows(j: Any, tensors: Tuple[torch.Tensor, ...], ids: torch.Tensor,
               group: Group = WORLD1) -> None:
    """Rows at ``ids`` of each tensor; an invalid (sentinel) id clamps to a
    row saved alongside, which its masked write leaves as it was. Past
    world 1 ``ids`` are this rank's global ids and the tensors its shard:
    the writes land on the owners' rows of every rank's ids (the routed and
    gathered grads, the FCounter), so the rows saved are this rank's rows
    of every rank's ``ids``, all_gathered (one small collective)."""
    rps = tensors[0].shape[0]
    if group.world > 1:
        ids = (all_gather_tiled(ids.reshape(-1).to(torch.int32), group).long()
               - group.rank * rps)
    idx = torch.clamp(ids.long(), 0, rps - 1)
    for t in tensors:
        j.save(t, idx)


def _save_tier(j: Any, tier: Any, slot: torch.Tensor, group: Group = WORLD1) -> None:
    """A tier's rows and accumulators at the probe slots. Past world 1 the
    replicated tier takes every rank's hit grads (summed, or gathered), so
    the slots saved are every rank's, all_gathered."""
    if tier.keys.shape[0] > 0:
        if group.world > 1:
            slot = all_gather_tiled(slot.reshape(-1).to(torch.int32), group)
        _save_rows(j, (tier.rows, tier.acc), slot)


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
            st.w, ids, world=self.world, group=self.group, capacity=self.capacity[gid],
            hot_keys=st.cache.keys if cache_on else None,
            hot_rows=st.cache.rows if cache_on else None,
            fused=self.use_fused)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        w2, acc2, cache2 = pe.apply_sparse_grads(
            st.w, st.acc, st.cache if cache_on else None, ctx, g_rows,
            world=self.world, group=self.group, lr=self.lr, eps=self.eps,
            cache_update=self.cache_update, fused=self.use_fused,
            compress=self.grad_compress)
        counts2 = pe.count_frequencies(st.counts, ctx)
        # an unused L2 tier is kept as it is
        st2 = st._replace(w=w2, acc=acc2, counts=counts2,
                          cache=cache2 if cache2 is not None else st.cache)
        return (st2, ctx.routing.overflow.to(torch.int32),
                pe.cache_hit_count(ctx).to(torch.int32))

    def journal(self, j, st, ctx, *, cache_on=False, l2_on=False):
        # the routed misses, the stale hit routes and the FCounter's rows
        # all lie among the ctx's unique ids; 'psum' hits write L1 by slot
        _save_rows(j, (st.w, st.acc, st.counts), ctx.uniq, self.group)
        if cache_on:
            _save_tier(j, st.cache, ctx.cache_slot, self.group)


@register_strategy("hybrid")
class HybridStrategy(PicassoStrategy):
    """MP Shuffle routing without the HybridHash tier (paper §II-C): the
    ``picasso`` path with the tier never participating, so every unique id
    is routed to its owner every step. Isolates the cache's contribution;
    on a plan built with ``enable_packing=False`` it is the "MP without
    packing or cache" baseline."""

    uses_cache = False

    def lookup(self, st, gid, ids, *, cache_on=False, l2_on=False):
        return super().lookup(st, gid, ids, cache_on=False)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        return super().apply_grads(st, gid, ctx, g_rows, cache_on=False)

    def journal(self, j, st, ctx, *, cache_on=False, l2_on=False):
        super().journal(j, st, ctx, cache_on=False)


@register_strategy("picasso_l2")
class PicassoL2Strategy(PicassoStrategy):
    """PICASSO with a two-level parameter cache: the L1 hot tier and, behind
    it, a larger L2 tier (on the card, or in pinned host memory under
    ``--pin-l2``, where the kernels reach it over the bus). Unique ids probe
    L1, the L1 misses probe L2, and only the rest ride the Shuffle.

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
            st.w, ids, world=self.world, group=self.group, capacity=self.capacity[gid],
            hot_keys=st.cache.keys if cache_on else None,
            hot_rows=st.cache.rows if cache_on else None,
            l2_keys=st.l2.keys, l2_rows=st.l2.rows, fused=self.use_fused)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        if not l2_on or st.l2 is None or ctx.l2_hit is None:
            return super().apply_grads(st, gid, ctx, g_rows, cache_on=cache_on)
        w2, acc2, cache2, l22 = pe.apply_sparse_grads_l2(
            st.w, st.acc, st.cache if cache_on else None, st.l2, ctx, g_rows,
            world=self.world, group=self.group, lr=self.lr, eps=self.eps,
            cache_update=self.cache_update, fused=self.use_fused,
            compress=self.grad_compress)
        counts2 = pe.count_frequencies(st.counts, ctx)
        # tier-served ids never route, so they are counted here, or the flush
        # ranking would evict the resident (hottest) rows
        counts2 = pe.count_hit_frequencies(counts2, ctx, ctx.hit | ctx.l2_hit,
                                           world=self.world, group=self.group)
        st2 = st._replace(w=w2, acc=acc2, counts=counts2,
                          cache=cache2 if cache2 is not None else st.cache, l2=l22)
        hits = pe.cache_hit_count(ctx) + pe.l2_hit_count(ctx)
        return st2, ctx.routing.overflow.to(torch.int32), hits.to(torch.int32)

    def journal(self, j, st, ctx, *, cache_on=False, l2_on=False):
        super().journal(j, st, ctx, cache_on=cache_on)
        if l2_on and st.l2 is not None and ctx.l2_hit is not None:
            _save_tier(j, st.l2, ctx.l2_slot, self.group)

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
            st.w, ids, proj=st.proj.kernel, world=self.world, group=self.group,
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
            st.proj, ctx, g_rows, world=self.world, group=self.group, lr=self.lr,
            eps=self.eps,
            cache_update=self.cache_update, fused=self.use_fused,
            compress=self.grad_compress)
        counts2 = pe.count_frequencies(st.counts, ctx)
        if cache_on or with_l2:
            both = ctx.hit if ctx.l2_hit is None else ctx.hit | ctx.l2_hit
            counts2 = pe.count_hit_frequencies(counts2, ctx, both, world=self.world,
                                               group=self.group)
        st2 = st._replace(w=w2, acc=acc2, counts=counts2,
                          cache=cache2 if cache2 is not None else st.cache,
                          l2=l22 if with_l2 else st.l2, proj=proj2)
        hits = pe.cache_hit_count(ctx) + pe.l2_hit_count(ctx)
        return st2, ctx.routing.overflow.to(torch.int32), hits.to(torch.int32)

    def journal(self, j, st, ctx, *, cache_on=False, l2_on=False):
        super().journal(j, st, ctx, cache_on=cache_on, l2_on=l2_on)
        if st.proj is not None:  # the projection trains whole
            j.save(st.proj.kernel)
            j.save(st.proj.acc)


def _identity_order(n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, slot_sorted)`` of a ctx whose ``inv`` is ``arange(n)``."""
    return (torch.arange(n, dtype=torch.int64, device=device),
            torch.arange(n, dtype=torch.int32, device=device))


def _gathered_apply(strategy: "LookupStrategy", st: EmbeddingState, ids: torch.Tensor,
                    g_rows: torch.Tensor) -> Tuple[EmbeddingState, torch.Tensor, torch.Tensor]:
    """The replicated strategies' backward: every shard's ids and row grads
    are all_gathered (the grads compressed on the wire under
    ``grad_compress``; both gathers are identities at world 1) and each
    shard applies the ones it owns with dedup + row-wise Adagrad, in place.
    Returns zero overflow and zero hits: nothing routes, nothing is cached."""
    rps = st.w.shape[0]
    grp = strategy.group
    all_g = gcomp.compressed_all_gather(g_rows, strategy.world, mode=strategy.grad_compress,
                                        fused=strategy.use_fused, group=grp)
    local = all_gather_tiled(ids.to(torch.int32), grp) - grp.rank * rps
    ok = (local >= 0) & (local < rps)
    pe._dedup_apply(st.w, st.acc, torch.clamp(local, 0, rps - 1), all_g, ok, strategy.lr,
                    strategy.eps, fused=strategy.use_fused)
    zero = torch.zeros((), dtype=torch.int32, device=g_rows.device)
    return st, zero, zero


class PSCtx(NamedTuple):
    """Context of a PS lookup: rows are per id, so ``inv`` is the identity
    and so is its sort."""

    inv: torch.Tensor          # [n] arange(n), int32
    ids: torch.Tensor          # [n] the packed ids (the backward needs them)
    order: torch.Tensor        # [n] arange(n), int64
    slot_sorted: torch.Tensor  # [n] arange(n), int32


@register_strategy("ps")
class PSStrategy(LookupStrategy):
    """PS/DP-style baseline (paper §II-C): all_gather ids, psum partial rows.
    No routing, no dedup, no cache: the fragmentary pattern PICASSO beats.
    The backward all_gathers per-id grads and applies the local ones."""

    uses_cache = False
    uses_routing_ctx = False

    def lookup(self, st, gid, ids, *, cache_on=False, l2_on=False):
        rows = pe.ps_lookup(st.w, ids, world=self.world, group=self.group)
        order, slot_sorted = _identity_order(ids.shape[0], ids.device)
        return rows, PSCtx(inv=slot_sorted, ids=ids, order=order, slot_sorted=slot_sorted)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        return _gathered_apply(self, st, ctx.ids, g_rows)

    def journal(self, j, st, ctx, *, cache_on=False, l2_on=False):
        _save_rows(j, (st.w, st.acc), ctx.ids, self.group)  # every position's rows


@register_strategy("mp_nodedup")
class MPNoDedupStrategy(LookupStrategy):
    """Model-parallel Shuffle without K-Packed dedup (paper §II-C baseline):
    every raw id, duplicates included, takes a Shuffle bucket slot, so the
    wire payload scales with the batch's id count, not its unique count.
    Exact against ``picasso`` when nothing overflows (``exact_capacity=True``
    plans): the owner-side dedup + Adagrad sums the duplicates' grads."""

    def lookup(self, st, gid, ids, *, cache_on=False, l2_on=False):
        return pe.mp_lookup_nodedup(st.w, ids, world=self.world, group=self.group,
                                    capacity=self.capacity[gid])

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        pe._apply_miss_grads(st.w, st.acc, ctx, g_rows, self.world, self.lr, self.eps,
                             self.use_fused, self.grad_compress, self.group)
        pe.count_frequencies(st.counts, ctx)
        return (st, ctx.routing.overflow.to(torch.int32),
                torch.zeros((), dtype=torch.int32, device=g_rows.device))

    def journal(self, j, st, ctx, *, cache_on=False, l2_on=False):
        _save_rows(j, (st.w, st.acc, st.counts), ctx.uniq, self.group)  # the sorted ids


class AllGatherCtx(NamedTuple):
    """Context of an ``allgather_rows`` lookup: rows are per unique slot."""

    inv: torch.Tensor          # [n] position -> unique slot
    uniq: torch.Tensor         # [n] sorted unique ids (sentinel-padded)
    order: torch.Tensor        # [n] the unique's stable sort (int64)
    slot_sorted: torch.Tensor  # [n] ``inv[order]`` (int32)


@register_strategy("allgather_rows")
class AllGatherRowsStrategy(LookupStrategy):
    """Dedup'd replication baseline: the batch is uniqued (fixed shape) and
    the unique set served by ``ps_lookup``, sentinel slots as exact zero
    rows. The backward all_gathers the unique ids and their row grads and
    applies them on the owner shard. Its wire cost sits between ``ps`` and
    the routed strategies; no routing ctx, no tiers."""

    uses_cache = False
    uses_routing_ctx = False

    def lookup(self, st, gid, ids, *, cache_on=False, l2_on=False):
        u = pe.fixed_unique(ids, sentinel=st.w.shape[0] * self.world)
        rows = pe.ps_lookup(st.w, u.uniq, world=self.world, group=self.group)
        return rows, AllGatherCtx(inv=u.inv, uniq=u.uniq, order=u.order,
                                  slot_sorted=u.slot_sorted)

    def apply_grads(self, st, gid, ctx, g_rows, *, cache_on=False, l2_on=False):
        return _gathered_apply(self, st, ctx.uniq, g_rows)

    def journal(self, j, st, ctx, *, cache_on=False, l2_on=False):
        _save_rows(j, (st.w, st.acc), ctx.uniq, self.group)
