"""PICASSO packed-embedding primitives (``repro.core.packed_embedding`` in
torch), for the ``picasso``, ``picasso_l2`` and ``picasso_narrow`` paths and
the baselines' lookups (``ps_lookup``, ``mp_lookup_nodedup``).

The kernel layer beneath ``repro_torch.engine.EmbeddingEngine``: stateless,
fixed-shape building blocks for one *packed* lookup per D-packed group:

    ids -> [Unique&Partition] -> L1 probe -> L2 probe -> Shuffle
        -> local Gather -> Shuffle back -> Stitch (+ tier merges)
        -> unique rows -> pool

and the transposed path for the sparse gradients (``apply_sparse_grads``,
``_l2``, ``_narrow``): miss grads ride the transposed Shuffle to their owner
rows and a fused dedup + row-wise Adagrad; hit grads go into their tier
(``'psum'``) or to their owner rows (``'stale'``). ``picasso_narrow`` keeps
the cold master at a narrow width ``d`` and widens the routed rows through a
learned ``[d, D]`` projection (``ops.gather_project``); its tiers stay at
the full width ``D``.

The reference keeps static shapes for its TPU collectives (sort-based fixed
unique, fixed-capacity per-peer buckets, sentinel slots); the port keeps
them too, so ``overflow``, ``send_slot`` and the exact-zero contracts match
bit for bit. Past world 1 every rank runs in a process of its own and
passes its ``dist.Group`` where the reference passes ``axes``: the Shuffle
is ``dist.all_to_all_tiled``, the tier and projection reductions
``dist.psum``, the flush's candidates and the baselines' ids and rows
``dist.all_gather_tiled``. With no group at world 1 every collective is the
identity, so that path is what it was. The FCounter update and the HybridHash flush
update the state's tensors in place, and so do the sparse updates: the
full-width table is 7.5 GB and a functional copy per step would double it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.compat import (WORLD1, Group, all_gather_tiled, all_to_all_tiled,
                                     psum, resolve_group)
from repro_torch.kernels import ops
from repro_torch.optim import grad_compression as gcomp


# ---------------------------------------------------------------------------
# fixed-shape building blocks (K-Packing: Unique&Partition fused)
# ---------------------------------------------------------------------------


class UniqueResult(NamedTuple):
    uniq: torch.Tensor      # [n] ascending; slots >= n_uniq hold ``sentinel``
    inv: torch.Tensor       # [n] original position -> unique slot
    n_uniq: torch.Tensor    # scalar
    uvalid: torch.Tensor    # [n] bool, slot validity
    order: torch.Tensor     # [n] int64 stable argsort of ids (and so of inv)
    slot_sorted: torch.Tensor  # [n] int32 ``inv[order]``, ascending


def fixed_unique(ids: torch.Tensor, sentinel: int) -> UniqueResult:
    """Sort-based unique with static output size == input size. The sort is
    stable, so ``order`` (equal ids in original position order) and
    ``slot_sorted`` are also the permutation the backward's
    ``ops.segment_grad`` sums along: slots ascend with ids."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    s = ids[order]
    is_first = torch.ones((n,), dtype=torch.bool, device=ids.device)
    is_first[1:] = s[1:] != s[:-1]
    slot_sorted = (torch.cumsum(is_first, 0) - 1).to(torch.int32)
    inv = torch.zeros((n,), dtype=torch.int32, device=ids.device)
    inv[order] = slot_sorted
    uniq = torch.full((n,), sentinel, dtype=ids.dtype, device=ids.device)
    uniq[slot_sorted.long()] = s
    n_uniq = is_first.sum().to(torch.int32)
    uvalid = torch.arange(n, dtype=torch.int32, device=ids.device) < n_uniq
    return UniqueResult(uniq, inv, n_uniq, uvalid, order, slot_sorted)


class Routing(NamedTuple):
    """Unique&Partition output: where each unique slot goes in the Shuffle."""

    owner: torch.Tensor      # [n] destination shard (== world for drop)
    pos: torch.Tensor        # [n] position within the per-peer bucket
    send_slot: torch.Tensor  # [n] flattened owner*cap + pos (world*cap = drop)
    kept: torch.Tensor       # [n] routed (miss & under capacity)
    overflow: torch.Tensor   # scalar count of dropped uniques


def partition(uniq: torch.Tensor, miss: torch.Tensor, rows_per_shard: int,
              world: int, capacity: int) -> Routing:
    """Partition sorted unique ids into fixed-capacity per-owner buckets.

    ``uniq`` ascending => block owner ids are monotone, so the rank of a miss
    within its owner's bucket is a cumsum difference (no extra sort).
    """
    owner = torch.clamp(uniq // rows_per_shard, max=world).to(torch.int32)
    m = miss.to(torch.int32)
    prefix = torch.cumsum(m, 0).to(torch.int32) - m  # exclusive
    start = torch.searchsorted(owner, owner, side="left")
    pos = prefix - prefix[start]
    kept = miss & (pos < capacity) & (owner < world)
    send_slot = torch.where(kept, owner * capacity + pos,
                            torch.full_like(owner, world * capacity))
    overflow = (miss & (pos >= capacity)).sum().to(torch.int32)
    return Routing(owner, pos, send_slot, kept, overflow)


# ---------------------------------------------------------------------------
# forward: Shuffle & Stitch (+ HybridHash read path)
# ---------------------------------------------------------------------------


class LookupCtx(NamedTuple):
    """Everything the backward and statistics passes need (all static
    shapes). ``l2_hit``/``l2_slot`` are ``None`` unless the lookup probed an
    L2 tier; ``narrow_rows`` is set by ``mp_lookup_narrow`` only."""

    uniq: torch.Tensor
    inv: torch.Tensor
    uvalid: torch.Tensor
    hit: torch.Tensor         # [n] served by hot tier
    cache_slot: torch.Tensor  # [n] clamped position in hot_keys
    routing: Routing
    recv_ids: torch.Tensor    # [world, cap] ids this shard served (owner side)
    recv_local: torch.Tensor  # [world, cap] local row idx (clamped)
    recv_valid: torch.Tensor  # [world, cap]
    l2_hit: Optional[torch.Tensor] = None    # [n] served by the L2 tier
    l2_slot: Optional[torch.Tensor] = None   # [n] clamped position in l2_keys
    narrow_rows: Optional[torch.Tensor] = None  # [n, d] routed narrow rows
    #   (the gather_project residual, zero at tier hits and padding, from
    #   which the projection's gradient is one ``narrow^T @ g_u`` product)
    order: Optional[torch.Tensor] = None        # [n] the unique's stable sort,
    slot_sorted: Optional[torch.Tensor] = None  # and ``inv`` in its order: the
    #   backward's ``segment_grad`` runs along them without a sort of its own


def cache_probe(uniq: torch.Tensor, uvalid: torch.Tensor,
                hot_keys: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if hot_keys is None or hot_keys.shape[0] == 0:
        z = torch.zeros(uniq.shape, dtype=torch.bool, device=uniq.device)
        return z, torch.zeros(uniq.shape, dtype=torch.int32, device=uniq.device)
    p = torch.searchsorted(hot_keys, uniq)
    p_c = torch.clamp(p, 0, hot_keys.shape[0] - 1)
    hit = (hot_keys[p_c] == uniq) & uvalid
    return hit, p_c.to(torch.int32)


class _Probe(NamedTuple):
    """The two tier probes of one lookup (L2 fields ``None`` without L2)."""

    hit: torch.Tensor
    cache_slot: torch.Tensor
    l1_rows: Optional[torch.Tensor]  # [n, D] hit rows, exact zeros elsewhere
    l2_hit: Optional[torch.Tensor]
    l2_slot: Optional[torch.Tensor]
    l2_rows: Optional[torch.Tensor]
    miss: torch.Tensor               # valid and in neither tier


def _probe_tiers(u: UniqueResult, hot_keys, hot_rows, l2_keys, l2_rows,
                 fused: Optional[bool]) -> _Probe:
    """Strictly tiered: L1 first, then the L2 tier for the L1 misses only
    (the mask keeps an overlapping user-built tier from serving an id
    twice). Each probe is one ``ops.tier_probe`` pass."""
    if hot_keys is not None and hot_keys.shape[0] > 0 and hot_rows is not None:
        hit, cache_slot, l1_rows = ops.tier_probe(u.uniq, u.uvalid, hot_keys, hot_rows,
                                                  fused=fused)
    else:
        (hit, cache_slot), l1_rows = cache_probe(u.uniq, u.uvalid, hot_keys), None
    if l2_keys is not None and l2_keys.shape[0] > 0:
        l2_hit, l2_slot, l2v = ops.tier_probe(u.uniq, u.uvalid & ~hit, l2_keys, l2_rows,
                                              fused=fused)
        miss = u.uvalid & ~hit & ~l2_hit
    else:
        l2_hit = l2_slot = l2v = None
        miss = u.uvalid & ~hit
    return _Probe(hit, cache_slot, l1_rows, l2_hit, l2_slot, l2v, miss)


def _shuffle_gather(table_shard: torch.Tensor, uniq: torch.Tensor, r: Routing, world: int,
                    capacity: int, fused: Optional[bool] = None, group: Group = WORLD1):
    """Route the misses to their owners (``all_to_all_tiled``, the identity
    at world 1), gather the owner rows and route them back: ``(recv_ids,
    recv_local, recv_valid, back [world*cap, width])``. A host-resident
    table (``--pin-l2``) is read over the bus by ``ops.take_rows``."""
    rps, width = table_shard.shape
    send_ids = torch.full((world * capacity + 1,), -1, dtype=torch.int32,
                          device=uniq.device)
    send_ids[r.send_slot.long()] = uniq.to(torch.int32)  # last slot = drop
    recv_ids = all_to_all_tiled(send_ids[:-1], group).reshape(world, capacity)
    base = group.rank * rps  # this rank's first row
    recv_valid = recv_ids >= 0
    recv_local = torch.clamp(recv_ids - base, 0, rps - 1)
    served = ops.take_rows(table_shard, recv_local.reshape(-1), fused=fused)
    served = served * recv_valid.reshape(-1, 1).to(served.dtype)
    back = all_to_all_tiled(served.reshape(world * capacity, width), group)
    return recv_ids, recv_local, recv_valid, back


def _stitch(miss_rows: torch.Tensor, pr: _Probe) -> torch.Tensor:
    """Tier rows over the routed rows, L2 first, then L1 (the reference's
    order); each probe's rows are already zero where it missed."""
    if pr.l2_hit is not None:
        miss_rows = torch.where(pr.l2_hit[:, None], pr.l2_rows.to(miss_rows.dtype),
                                miss_rows)
    if pr.l1_rows is not None:
        return torch.where(pr.hit[:, None], pr.l1_rows.to(miss_rows.dtype), miss_rows)
    return miss_rows


def mp_lookup(
    table_shard: torch.Tensor,     # [rows_per_shard, D]
    ids: torch.Tensor,             # [n] packed global row ids (int32)
    *,
    world: int,
    capacity: int,
    hot_keys: Optional[torch.Tensor] = None,   # [H] replicated, sorted
    hot_rows: Optional[torch.Tensor] = None,   # [H, D] replicated
    l2_keys: Optional[torch.Tensor] = None,    # [H2] L2 tier, sorted
    l2_rows: Optional[torch.Tensor] = None,    # [H2, D]
    fused: Optional[bool] = None,              # see kernels.ops
    group: Optional[Group] = None,             # this rank's (None at world 1)
) -> Tuple[torch.Tensor, LookupCtx]:
    """Forward packed lookup. Returns unique rows [n, D] + routing context.

    Each tier probe is one ``ops.tier_probe`` pass (binary search + hit-masked
    row gather, miss rows exactly zero), so the Stitch is one ``where`` per
    tier; its plain version computes the reference's searchsorted/take/where
    chain with identical hit values. Only ids in neither tier ride the
    Shuffle. Without ``l2_keys`` every intermediate is the L1-only path's
    and ``ctx.l2_hit`` stays ``None``.
    """
    grp = resolve_group(world, group)
    rps = table_shard.shape[0]
    u = fixed_unique(ids, sentinel=rps * world)
    pr = _probe_tiers(u, hot_keys, hot_rows, l2_keys, l2_rows, fused)
    r = partition(u.uniq, pr.miss, rps, world, capacity)
    recv_ids, recv_local, recv_valid, back = _shuffle_gather(table_shard, u.uniq, r,
                                                             world, capacity, fused, grp)
    take_idx = torch.clamp(r.send_slot, max=world * capacity - 1).long()
    miss_rows = back[take_idx] * r.kept[:, None].to(back.dtype)
    ctx = LookupCtx(
        uniq=u.uniq, inv=u.inv, uvalid=u.uvalid, hit=pr.hit, cache_slot=pr.cache_slot,
        routing=r, recv_ids=recv_ids, recv_local=recv_local, recv_valid=recv_valid,
        l2_hit=pr.l2_hit, l2_slot=pr.l2_slot,
        order=u.order, slot_sorted=u.slot_sorted)
    return _stitch(miss_rows, pr), ctx


def mp_lookup_narrow(
    table_shard: torch.Tensor,     # [rows_per_shard, d] NARROW master
    ids: torch.Tensor,             # [n] packed global row ids (int32)
    *,
    proj: torch.Tensor,            # [d, D] learned up-projection
    world: int,
    capacity: int,
    hot_keys: Optional[torch.Tensor] = None,   # [H1] sorted; tier rows are WIDE
    hot_rows: Optional[torch.Tensor] = None,   # [H1, D]
    l2_keys: Optional[torch.Tensor] = None,    # [H2] sorted
    l2_rows: Optional[torch.Tensor] = None,    # [H2, D]
    fused: Optional[bool] = None,
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, LookupCtx]:
    """``mp_lookup`` with hot/cold widths: tier hits are served full-width
    ``D`` rows as in the L2 path, while the misses ride the Shuffle at the
    narrow width ``d`` and the Stitch is one ``ops.gather_project`` pass
    that widens the routed-back narrow rows through ``proj``. The narrow
    rows land in ``ctx.narrow_rows`` (zeros at tier hits and padding) as the
    residual of the projection's gradient. Probes, overflow and routing are
    ``mp_lookup``'s."""
    grp = resolve_group(world, group)
    rps = table_shard.shape[0]
    u = fixed_unique(ids, sentinel=rps * world)
    pr = _probe_tiers(u, hot_keys, hot_rows, l2_keys, l2_rows, fused)
    r = partition(u.uniq, pr.miss, rps, world, capacity)
    recv_ids, recv_local, recv_valid, back = _shuffle_gather(table_shard, u.uniq, r,
                                                             world, capacity, fused, grp)
    take_idx = torch.clamp(r.send_slot, max=world * capacity - 1)
    miss_rows, narrow = ops.gather_project(back, take_idx, r.kept, proj, fused=fused)
    ctx = LookupCtx(
        uniq=u.uniq, inv=u.inv, uvalid=u.uvalid, hit=pr.hit, cache_slot=pr.cache_slot,
        routing=r, recv_ids=recv_ids, recv_local=recv_local, recv_valid=recv_valid,
        l2_hit=pr.l2_hit, l2_slot=pr.l2_slot, narrow_rows=narrow,
        order=u.order, slot_sorted=u.slot_sorted)
    return _stitch(miss_rows, pr), ctx


def pool(
    rows_u: torch.Tensor,    # [n, D] unique rows
    ctx_inv: torch.Tensor,   # [n]
    weights: torch.Tensor,   # [n] (0 for padding; 1/len for mean pooling)
    seg: torch.Tensor,       # [n] bag index (sorted; packed layout covers all)
    n_bags: int,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """SegmentReduction: ids -> bags, through ``ops.gather_pool`` (the CUDA
    kernel never materializes the ``[n, D]`` per-id intermediate)."""
    return ops.gather_pool(rows_u, ctx_inv, weights, seg, n_bags, fused=fused)


# ---------------------------------------------------------------------------
# backward: transposed Shuffle + row-wise adagrad (sparse-exact), in place
# ---------------------------------------------------------------------------


def _dedup_apply(w_shard: torch.Tensor, acc_shard: torch.Tensor, idx: torch.Tensor,
                 g: torch.Tensor, valid: torch.Tensor, lr: float, eps: float,
                 fused: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum duplicate row grads, then row-wise adagrad on touched rows only,
    in place on ``w_shard``/``acc_shard`` (``ops.dedup_adagrad``)."""
    return ops.dedup_adagrad(w_shard, acc_shard, idx, g, valid, lr, eps, fused=fused)


def apply_sparse_grads(
    w_shard: torch.Tensor,
    acc_shard: torch.Tensor,
    cache: Optional["CacheState"],
    ctx: LookupCtx,
    g_u: torch.Tensor,    # [n, D] grad wrt unique rows
    *,
    world: int,
    lr: float,
    eps: float = 1e-8,
    cache_update: str = "psum",   # 'psum' (tier authoritative, exact) | 'stale'
    fused: Optional[bool] = None,
    compress: str = "none",
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional["CacheState"]]:
    """Transposed path: miss grads -> owners; hit grads -> hot tier or owners.

    'psum'  -- hit grads are summed into the hot tier, which is authoritative
               for its rows between flushes (exact training);
    'stale' -- hit grads are routed to the owner rows and the tier stays
               read-only between flushes (Algorithm 1's bounded staleness).

    ``compress`` (``'none' | 'fp16' | 'topk'``, ``optim.grad_compression``)
    shrinks the routed hops' payload; the tier update stays exact.
    ``w_shard``, ``acc_shard`` and the tier are updated in place; the
    returned tuple names them.
    """
    grp = _check_update(world, compress, cache_update, group)
    _apply_miss_grads(w_shard, acc_shard, ctx, g_u, world, lr, eps, fused, compress, grp)

    if cache is None or cache.keys.shape[0] == 0:
        return w_shard, acc_shard, cache
    if cache_update == "stale":
        _route_hit_grads(w_shard, acc_shard, ctx, ctx.hit, g_u, world, lr, eps, fused,
                         compress, grp)
        return w_shard, acc_shard, cache
    return w_shard, acc_shard, _psum_into_tier(cache, ctx.hit, ctx.cache_slot, g_u,
                                               lr, eps, grp)


def _check_update(world: int, compress: str, cache_update: str,
                  group: Optional[Group]) -> Group:
    grp = resolve_group(world, group)
    gcomp.validate_routed_mode(compress)
    if cache_update not in ("psum", "stale"):
        raise ValueError(f"cache_update must be 'psum' or 'stale', got {cache_update!r}")
    return grp


def _scatter_rows(send_slot: torch.Tensor, values: torch.Tensor, n_slots: int,
                  fill: float = 0.0) -> torch.Tensor:
    """``[n_slots + 1, ...]`` buffer with ``values`` at ``send_slot``; the
    last row is the drop slot every not-kept position writes to (the
    reference's ``mode='drop'``), so callers slice it off."""
    buf = torch.full((n_slots + 1,) + tuple(values.shape[1:]), fill, dtype=values.dtype,
                     device=values.device)
    buf[send_slot.long()] = values
    return buf[:-1]


def _compressed_a2a_rows(send_g: torch.Tensor, compress: str = "none",
                         fused: Optional[bool] = None,
                         group: Group = WORLD1) -> torch.Tensor:
    """all_to_all ``[world*cap, D]`` gradient rows, compressed on the wire.

    ``'none'`` is the exact hop. Otherwise the rows are compressed before the
    collective, every payload tensor rides its own all_to_all (each keeps
    the leading row dimension) and the owner decompresses after it, as in
    the reference: at world 1 the all_to_alls are identities, but the lossy
    roundtrip runs all the same. Zero rows (empty bucket slots) survive
    every mode bitwise."""
    if compress == "none":
        return all_to_all_tiled(send_g, group)
    payload = gcomp.compress_rows(send_g, compress, fused=fused)
    payload = type(payload)(*(all_to_all_tiled(x, group) for x in payload))
    return gcomp.decompress_rows(payload, send_g.shape[-1], compress, fused=fused)


def _apply_miss_grads(w_shard, acc_shard, ctx: LookupCtx, g_u, world: int, lr: float,
                      eps: float, fused: Optional[bool] = None, compress: str = "none",
                      group: Group = WORLD1):
    """Transposed Shuffle: route miss grads to owner rows and apply. Kept
    positions have distinct slots; the rest all land in the drop slot."""
    cap = ctx.recv_ids.shape[1]
    send_g = _scatter_rows(ctx.routing.send_slot, g_u, world * cap)
    recv_g = _compressed_a2a_rows(send_g, compress, fused, group)
    return _dedup_apply(w_shard, acc_shard, ctx.recv_local.reshape(-1), recv_g,
                        ctx.recv_valid.reshape(-1), lr, eps, fused)


def _route_hit_grads(w_shard, acc_shard, ctx: LookupCtx, hit_mask, g_u, world: int,
                     lr: float, eps: float, fused: Optional[bool] = None,
                     compress: str = "none", group: Group = WORLD1):
    """'stale' mode: grads of tier-served ids ride a second small Shuffle to
    their owner rows; the tier itself stays read-only between flushes."""
    rps = w_shard.shape[0]
    cap = ctx.recv_ids.shape[1]
    r = partition(ctx.uniq, hit_mask, rps, world, cap)
    send_ids = _scatter_rows(r.send_slot, ctx.uniq.to(torch.int32), world * cap, -1)
    send_hg = _scatter_rows(r.send_slot, g_u, world * cap)
    recv_ids = all_to_all_tiled(send_ids, group)
    recv_hg = _compressed_a2a_rows(send_hg, compress, fused, group)
    base = group.rank * rps  # this rank's first row
    local = torch.clamp(recv_ids - base, 0, rps - 1)
    return _dedup_apply(w_shard, acc_shard, local, recv_hg, recv_ids >= 0, lr, eps,
                        fused)


def _tier_adagrad(tier: "CacheState", g_hot: torch.Tensor, lr: float,
                  eps: float) -> "CacheState":
    """Row-wise adagrad on the tier from a per-slot gradient, in place; rows
    without gradient stay bitwise unchanged."""
    gsq = (g_hot * g_hot).mean(dim=-1, keepdim=True)
    touched = (g_hot.abs().amax(dim=-1, keepdim=True) > 0).to(gsq.dtype)
    acc_new = tier.acc + gsq * touched
    upd = lr * g_hot / torch.sqrt(acc_new + eps)
    tier.rows.sub_(upd.to(tier.rows.dtype))
    tier.acc.copy_(acc_new)
    return tier


def _psum_into_tier(tier: "CacheState", hit_mask: torch.Tensor, slot: torch.Tensor,
                    g_u: torch.Tensor, lr: float, eps: float,
                    group: Group = WORLD1) -> "CacheState":
    """'psum' mode: sum the tier-hit grads per tier slot, ``psum`` them over
    the replicas (the identity at world 1) and adagrad the tier in place.

    Plain PyTorch on purpose, as in the reference: the dense ``[H, D]``
    gradient buffer exists anyway, after which the row-wise adagrad is an
    elementwise pass, and a per-row scatter kernel would only serialize it.
    Non-hit positions add into a drop row past the tier. At world 1 the
    hit positions are distinct unique ids, so their tier slots are distinct
    and this ``index_add_`` is deterministic on the card too; the all_reduce
    hands every replica the same sum."""
    h = tier.keys.shape[0]
    dst = torch.where(hit_mask, slot.long(), torch.full_like(slot, h, dtype=torch.long))
    g_hot = torch.zeros((h + 1, g_u.shape[1]), dtype=g_u.dtype, device=g_u.device)
    g_hot.index_add_(0, dst, g_u)
    return _tier_adagrad(tier, psum(g_hot[:h], group), lr, eps)


def _allgather_into_tier(tier: "CacheState", hit_mask: torch.Tensor, slot: torch.Tensor,
                         g_u: torch.Tensor, lr: float, eps: float,
                         fused: Optional[bool] = None,
                         group: Group = WORLD1) -> "CacheState":
    """Exact tier update whose cost follows the batch, not the tier: every
    rank's hit grads and slots are all_gathered (the identity at world 1)
    and feed ``ops.dedup_adagrad`` in place on the tier, so no dense
    ``[H2, D]`` buffer exists. Positions that missed the tier take the
    sentinel slot and are dropped; duplicate slots sum in stable-sorted
    position order of the gathered (rank-major) list, the same on every
    replica."""
    h = tier.keys.shape[0]
    slots = torch.where(hit_mask, slot, torch.full_like(slot, h))
    if group.world > 1:
        slots = all_gather_tiled(slots, group)
        g_u = all_gather_tiled(g_u * hit_mask[:, None].to(g_u.dtype), group)
        hit_mask = slots < h
    ops.dedup_adagrad(tier.rows, tier.acc, slots, g_u, hit_mask, lr, eps, fused=fused)
    return tier


def l2_reduction(world: int, n: int, d: int, h2: int) -> str:
    """The reference's static choice of the L2 tier's exact reduction:
    ``'all_gather'`` of the batch's hit grads and slots when its
    ``(world - 1) * n * (D + 1)`` elements are fewer than the dense
    ``H2 * D`` psum's, else ``'psum'``. At world 1 it is always the gather."""
    return "all_gather" if (world - 1) * n * (d + 1) < h2 * d else "psum"


def _tier_hit_grads(cache: Optional["CacheState"], l2: Optional["CacheState"],
                    ctx: LookupCtx, g_u: torch.Tensor, lr: float, eps: float,
                    fused: Optional[bool], group: Group = WORLD1):
    """'psum' mode for both tiers: L1 hit grads through the dense tier
    Adagrad, L2 hit grads through the reduction ``l2_reduction`` picks."""
    if cache is not None and cache.keys.shape[0] > 0:
        cache = _psum_into_tier(cache, ctx.hit, ctx.cache_slot, g_u, lr, eps, group)
    if l2 is not None and l2.keys.shape[0] > 0 and ctx.l2_hit is not None:
        n, d = g_u.shape
        if l2_reduction(group.world, n, d, l2.keys.shape[0]) == "all_gather":
            l2 = _allgather_into_tier(l2, ctx.l2_hit, ctx.l2_slot, g_u, lr, eps, fused,
                                      group)
        else:
            l2 = _psum_into_tier(l2, ctx.l2_hit, ctx.l2_slot, g_u, lr, eps, group)
    return cache, l2


def apply_sparse_grads_l2(
    w_shard: torch.Tensor,
    acc_shard: torch.Tensor,
    cache: Optional["CacheState"],
    l2: "CacheState",
    ctx: LookupCtx,
    g_u: torch.Tensor,
    *,
    world: int,
    lr: float,
    eps: float = 1e-8,
    cache_update: str = "psum",
    fused: Optional[bool] = None,
    compress: str = "none",
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional["CacheState"], "CacheState"]:
    """Two-tier transposed path (L1 hot tier + L2 tier), in place.

    Misses ride the transposed Shuffle as in ``apply_sparse_grads``. In
    ``'psum'`` mode both tiers stay authoritative between flushes: L1 hit
    grads through the dense tier Adagrad, L2 hit grads through the
    all_gather or the dense psum, as ``l2_reduction`` picks. In ``'stale'``
    mode the union of the two tiers' hits rides a second Shuffle to the
    owner rows and both tiers stay read-only. ``ctx`` must come from an
    L2-probing lookup."""
    grp = _check_update(world, compress, cache_update, group)
    _apply_miss_grads(w_shard, acc_shard, ctx, g_u, world, lr, eps, fused, compress, grp)
    if cache_update == "stale":
        _route_hit_grads(w_shard, acc_shard, ctx, ctx.hit | ctx.l2_hit, g_u, world, lr,
                         eps, fused, compress, grp)
        return w_shard, acc_shard, cache, l2
    cache, l2 = _tier_hit_grads(cache, l2, ctx, g_u, lr, eps, fused, grp)
    return w_shard, acc_shard, cache, l2


class ProjState(NamedTuple):
    """The learned per-group up-projection of ``picasso_narrow``: cold ids
    live as ``[d]``-narrow master rows and are widened to ``D`` at lookup.
    Replicated like the tiers; updated in place."""

    kernel: torch.Tensor  # [d, D]
    acc: torch.Tensor     # [d, 1] row-wise adagrad accumulator


def _proj_adagrad(proj: ProjState, g_proj: torch.Tensor, lr: float,
                  eps: float) -> ProjState:
    """Row-wise adagrad on the projection, in place: the tiers' update rule,
    so the projection trains in step with the rows it serves."""
    gsq = (g_proj * g_proj).mean(dim=-1, keepdim=True)
    acc_new = proj.acc + gsq
    upd = lr * g_proj / torch.sqrt(acc_new + eps)
    proj.kernel.sub_(upd.to(proj.kernel.dtype))
    proj.acc.copy_(acc_new)
    return proj


def apply_sparse_grads_narrow(
    w_shard: torch.Tensor,          # [rps, d] narrow master
    acc_shard: torch.Tensor,
    cache: Optional["CacheState"],  # L1 (wide rows)
    l2: Optional["CacheState"],     # L2 (wide rows); None = no L2 tier
    proj: ProjState,
    ctx: LookupCtx,                 # from mp_lookup_narrow
    g_u: torch.Tensor,              # [n, D] grad wrt the wide unique rows
    *,
    world: int,
    lr: float,
    eps: float = 1e-8,
    cache_update: str = "psum",
    fused: Optional[bool] = None,
    compress: str = "none",
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional["CacheState"], Optional["CacheState"],
           ProjState]:
    """Two-tier transposed path at hot/cold widths, in place.

    The wide cotangent is folded through ``proj^T`` once (``g_n = g_u @
    proj.kernel.T``, a plain product as in the reference); the routed hops
    carry the narrow gradient into the narrow master through the usual
    dedup + Adagrad. Tier-hit grads update the WIDE tiers as in
    ``apply_sparse_grads_l2``. The projection's gradient is one
    ``narrow_rows^T @ g_u`` product off the lookup's residual (tier hits
    never passed through ``proj``), psum'd over the replicas, then its
    row-wise Adagrad."""
    grp = _check_update(world, compress, cache_update, group)
    g_n = g_u @ proj.kernel.T   # [n, d]
    _apply_miss_grads(w_shard, acc_shard, ctx, g_n, world, lr, eps, fused, compress, grp)
    if cache_update == "stale":
        both = ctx.hit if ctx.l2_hit is None else ctx.hit | ctx.l2_hit
        _route_hit_grads(w_shard, acc_shard, ctx, both, g_n, world, lr, eps, fused,
                         compress, grp)
    else:
        cache, l2 = _tier_hit_grads(cache, l2, ctx, g_u, lr, eps, fused, grp)
    g_proj = psum(ctx.narrow_rows.T @ g_u, grp)   # [d, D]
    proj = _proj_adagrad(proj, g_proj, lr, eps)
    return w_shard, acc_shard, cache, l2, proj


# ---------------------------------------------------------------------------
# HybridHash tier state, frequency statistics + flush (Algorithm 1)
# ---------------------------------------------------------------------------


class CacheState(NamedTuple):
    keys: torch.Tensor   # [H] sorted global row ids (sentinel = rows_padded)
    rows: torch.Tensor   # [H, D]
    acc: torch.Tensor    # [H, 1] adagrad accumulator


def init_cache(h: int, d: int, rows_padded: int, dtype=torch.float32,
               device=None) -> CacheState:
    return CacheState(
        keys=torch.full((h,), rows_padded, dtype=torch.int32, device=device),
        rows=torch.zeros((h, d), dtype=dtype, device=device),
        acc=torch.zeros((h, 1), dtype=dtype, device=device),
    )


def count_frequencies(counts_shard: torch.Tensor, ctx: LookupCtx) -> torch.Tensor:
    """Owner-side FCounter update from the ids received this step, in place
    on ``counts_shard`` (returned for symmetry with the reference)."""
    return counts_shard.index_add_(
        0, ctx.recv_local.reshape(-1).long(),
        ctx.recv_valid.reshape(-1).to(counts_shard.dtype))


def count_hit_frequencies(counts_shard: torch.Tensor, ctx: LookupCtx,
                          hit_mask: torch.Tensor, *, world: int,
                          group: Optional[Group] = None) -> torch.Tensor:
    """FCounter update for tier-served lookups, in place. Tier hits never
    ride the Shuffle, so the owner never sees them; each rank adds the hits
    it issued to its own rows, weighted by ``world`` (the reference's
    unbiased estimate, exact at world 1). Positions that are not counted
    add 0 to row 0, so the update needs no host sync."""
    grp = resolve_group(world, group)
    rps = counts_shard.shape[0]
    base = grp.rank * rps  # this rank's first row
    local = ctx.uniq.to(torch.int32) - base
    ok = hit_mask & (local >= 0) & (local < rps)
    safe = torch.where(ok, local, torch.zeros_like(local)).long()
    return counts_shard.index_add_(0, safe, ok.to(counts_shard.dtype) * world)


def cache_hit_count(ctx: LookupCtx) -> torch.Tensor:
    return ctx.hit.sum()


def l2_hit_count(ctx: LookupCtx) -> torch.Tensor:
    if ctx.l2_hit is None:
        return torch.zeros((), dtype=torch.int32, device=ctx.hit.device)
    return ctx.l2_hit.sum()


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values, ties broken toward the lower
    index. ``torch.topk`` promises no tie order, and FCounter ties are
    common, so this is a stable descending sort instead."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _rank_tiers(counts_shard: torch.Tensor, h1: int, h2: int, world: int,
                rows_padded: int, group: Group = WORLD1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frequency ranking for both tiers: the top-(H1+H2) rows by FCounter
    count, split hottest-H1 / next-H2, each sorted; rows counted 0 never
    enter a tier (sentinel keys instead). As in the reference each rank
    keeps its top-(4H/world), the candidates and their global ids are
    all_gathered (rank-major), and a second top-k over the gathered list
    breaks ties toward the lower gathered index, as ``lax.top_k`` does; at
    world 1 the gather is the identity."""
    rps = counts_shard.shape[0]
    h = h1 + h2
    base = group.rank * rps  # this rank's first row
    k_local = min(rps, max(32, (4 * h + world - 1) // world))
    lvals, lidx = _top_k_stable(counts_shard, k_local)
    gids = all_gather_tiled(base + lidx.to(torch.int32), group)
    tvals, tidx = _top_k_stable(all_gather_tiled(lvals, group), h)
    ranked = torch.where(tvals > 0, gids[tidx], torch.full_like(gids[tidx], rows_padded))
    return torch.sort(ranked[:h1]).values, torch.sort(ranked[h1:]).values


def _decay(counts_shard: torch.Tensor, decay: float) -> None:
    counts_shard.copy_((counts_shard.to(torch.float32) * decay).to(counts_shard.dtype))


def flush_cache(
    w_shard: torch.Tensor,
    acc_shard: torch.Tensor,
    counts_shard: torch.Tensor,
    cache: CacheState,
    *,
    world: int,
    decay: float = 0.5,
    write_back: bool = True,
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, CacheState]:
    """Periodic HybridHash flush (Algorithm 1 L23-26).

    1. write back hot rows + optimizer state to the owner shard (in place);
    2. select the new top-H by frequency;
    3. load the new hot set.

    ``counts_shard`` decays in place; the returned tuple names the same
    ``w``/``acc``/``counts`` tensors and a fresh tier.
    """
    grp = resolve_group(world, group)
    rps = w_shard.shape[0]
    rows_padded = rps * world
    base = grp.rank * rps
    if write_back:
        _write_back_tier(w_shard, acc_shard, cache, base, rps, rows_padded)
    keys, _ = _rank_tiers(counts_shard, cache.keys.shape[0], 0, world, rows_padded, grp)
    new_cache = _load_tier(w_shard, acc_shard, keys, base, rps, rows_padded, grp)
    _decay(counts_shard, decay)
    return w_shard, acc_shard, counts_shard, new_cache


def flush_cache_l2(
    w_shard: torch.Tensor,
    acc_shard: torch.Tensor,
    counts_shard: torch.Tensor,
    cache: CacheState,
    l2: CacheState,
    *,
    world: int,
    decay: float = 0.5,
    write_back: bool = True,
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, CacheState, CacheState]:
    """Two-tier HybridHash flush: write both tiers back (``'psum'`` mode),
    rank the top-(H1+H2) rows once and split them hottest-H1 -> L1, next-H2
    -> L2 (disjoint by construction), and reload both from the master. An
    empty tier makes this the single-tier flush of the other."""
    grp = resolve_group(world, group)
    rps = w_shard.shape[0]
    rows_padded = rps * world
    base = grp.rank * rps
    if write_back:  # a host-resident L2 tier is staged only to be written back
        _write_back_tier(w_shard, acc_shard, cache, base, rps, rows_padded)
        _write_back_tier(w_shard, acc_shard, _staged_tier(l2, counts_shard.device), base,
                         rps, rows_padded)
    keys1, keys2 = _rank_tiers(counts_shard, cache.keys.shape[0], l2.keys.shape[0],
                               world, rows_padded, grp)
    new_l1 = _load_tier(w_shard, acc_shard, keys1, base, rps, rows_padded, grp)
    new_l2 = _load_tier(w_shard, acc_shard, keys2, base, rps, rows_padded, grp)
    _decay(counts_shard, decay)
    return w_shard, acc_shard, counts_shard, new_l1, _into(l2, new_l2)


def _write_back_tier(w_shard, acc_shard, tier: CacheState, base: int, rps: int,
                     rows_padded: int) -> None:
    """The owner shard takes its slice of the replicated tier, in place."""
    local = tier.keys - base
    mine = (local >= 0) & (local < rps) & (tier.keys < rows_padded)
    idx = local[mine].long()
    ops.put_rows(w_shard, idx, tier.rows[mine].to(w_shard.dtype))
    ops.put_rows(acc_shard, idx, tier.acc[mine].to(acc_shard.dtype))


def _load_tier(w_shard, acc_shard, keys, base: int, rps: int,
               rows_padded: int, group: Group = WORLD1) -> CacheState:
    """Master rows -> a fresh replicated tier: the psum of the owners'
    contributions (the identity at world 1)."""
    nlocal = keys - base
    nmine = (nlocal >= 0) & (nlocal < rps) & (keys < rows_padded)
    nclip = torch.clamp(nlocal, 0, rps - 1).long()
    contrib_w = ops.take_rows(w_shard, nclip) * nmine[:, None].to(w_shard.dtype)
    contrib_a = ops.take_rows(acc_shard, nclip) * nmine[:, None].to(acc_shard.dtype)
    return CacheState(keys, psum(contrib_w, group), psum(contrib_a, group))


def _staged_tier(tier: CacheState, device: torch.device) -> CacheState:
    """A host-resident tier (``--pin-l2``) copied to ``device`` for a
    flush's arithmetic; a tier already there is returned as it is."""
    if tier.rows.device == device:
        return tier
    return CacheState(*(t.to(device) for t in tier))


def _into(old: CacheState, new: CacheState) -> CacheState:
    """The flush's fresh tier, in place of a host-resident one: written into
    its pinned buffers (a tier keeps its size across flushes), so the
    placement survives; a device tier is simply replaced."""
    if old.rows.device == new.rows.device:
        return new
    for dst, src in zip(old, new):
        dst.copy_(src)
    return old


# ---------------------------------------------------------------------------
# heterogeneous widths (picasso_narrow): the re-widening flush
# ---------------------------------------------------------------------------


def proj_pinv(proj_kernel: torch.Tensor, ridge: float = 1e-6) -> torch.Tensor:
    """Regularised right pseudo-inverse of the ``[d, D]`` up-projection,
    ``P^T (P P^T + ridge I)^{-1}``: a ``[D, d]`` map with ``narrow @ P @ pinv
    ~= narrow``, used to narrow wide tier rows. The ``[d, d]`` solve runs in
    another order than XLA's, so rows narrowed through it match the
    reference to about 1e-6, not bitwise."""
    nd = proj_kernel.shape[0]
    gram = proj_kernel @ proj_kernel.T
    eye = torch.eye(nd, dtype=proj_kernel.dtype, device=proj_kernel.device)
    return proj_kernel.T @ torch.linalg.solve(gram + ridge * eye, eye)


def _write_back_tier_narrow(w_shard, acc_shard, tier: CacheState, pinv: torch.Tensor,
                            base: int, rps: int, rows_padded: int) -> None:
    """The owner takes its slice of a WIDE tier, narrowed through the
    projection's pseudo-inverse into the narrow master, in place."""
    local = tier.keys - base
    mine = (local >= 0) & (local < rps) & (tier.keys < rows_padded)
    idx = local[mine].long()
    nrows = tier.rows @ pinv   # [H, d]
    ops.put_rows(w_shard, idx, nrows[mine].to(w_shard.dtype))
    ops.put_rows(acc_shard, idx, tier.acc[mine].to(acc_shard.dtype))


def _load_tier_widened(w_shard, acc_shard, keys: torch.Tensor, proj_kernel: torch.Tensor,
                       base: int, rps: int, rows_padded: int,
                       group: Group = WORLD1) -> CacheState:
    """Narrow master rows -> a fresh WIDE tier: the owners' rows are psum'd
    at the narrow width and widened by one product over the whole tier."""
    nlocal = keys - base
    nmine = (nlocal >= 0) & (nlocal < rps) & (keys < rows_padded)
    nclip = torch.clamp(nlocal, 0, rps - 1).long()
    narrow = psum(ops.take_rows(w_shard, nclip) * nmine[:, None].to(w_shard.dtype), group)
    contrib_a = ops.take_rows(acc_shard, nclip) * nmine[:, None].to(acc_shard.dtype)
    return CacheState(keys, (narrow @ proj_kernel).to(w_shard.dtype),
                      psum(contrib_a, group))


def _carry_exact_rows(tier: CacheState, old1: CacheState, old2: CacheState,
                      rows_padded: int) -> CacheState:
    """Ids that stay tier-resident keep their EXACT wide rows (and adagrad
    slots) instead of a round trip through the rank-``d`` projection; freshly
    promoted ids keep their widened reload. In place on the fresh tier; the
    L2 pass overwrites the L1 one where both held a key, as in the
    reference."""
    for old in (old1, old2):
        if old.keys.shape[0] == 0:
            continue
        p = torch.searchsorted(old.keys, tier.keys)   # side='left', as jnp's
        pc = torch.clamp(p, 0, old.keys.shape[0] - 1)
        found = (old.keys[pc] == tier.keys) & (tier.keys < rows_padded)
        at = found.nonzero().squeeze(1)
        tier.rows[at] = old.rows[pc[at]]
        tier.acc[at] = old.acc[pc[at]]
    return tier


def flush_cache_narrow(
    w_shard: torch.Tensor,        # [rps, d] narrow master
    acc_shard: torch.Tensor,
    counts_shard: torch.Tensor,
    cache: CacheState,            # L1 (wide)
    l2: CacheState,               # L2 (wide; may have 0 rows)
    proj_kernel: torch.Tensor,    # [d, D]
    *,
    world: int,
    decay: float = 0.5,
    write_back: bool = True,
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, CacheState, CacheState]:
    """Two-tier flush at hot/cold widths, the re-widening lifecycle:

    1. write both WIDE tiers back into the narrow master through the
       projection's pseudo-inverse (``'psum'`` mode; adagrad slots exactly);
    2. one top-(H1+H2) ranking split hottest-H1 / next-H2 (as
       ``flush_cache_l2``);
    3. reload both tiers widened (``narrow @ P``, one product per tier), but
       ids that stayed tier-resident keep their exact wide rows
       (``_carry_exact_rows``; ``'psum'`` mode only: in ``'stale'`` mode the
       master is the single source of truth).

    Under ``--pin-l2`` the narrow master and the L2 tier are host-resident:
    the L2 tier is staged onto the card for the write-back's arithmetic (the
    same products as on device leaves, so the same bits; a flush that writes
    nothing back stages nothing), the master's rows move
    through ``ops.take_rows``/``ops.put_rows``, and the fresh L2 tier is
    written into the old one's pinned buffers.
    """
    grp = resolve_group(world, group)
    rps = w_shard.shape[0]
    rows_padded = rps * world
    base = grp.rank * rps
    l2_d = None  # a host-resident L2 tier is staged only to be written back
    if write_back:
        l2_d = _staged_tier(l2, counts_shard.device)
        pinv = proj_pinv(proj_kernel)
        _write_back_tier_narrow(w_shard, acc_shard, cache, pinv, base, rps, rows_padded)
        _write_back_tier_narrow(w_shard, acc_shard, l2_d, pinv, base, rps, rows_padded)
    keys1, keys2 = _rank_tiers(counts_shard, cache.keys.shape[0], l2.keys.shape[0],
                               world, rows_padded, grp)
    new_l1 = _load_tier_widened(w_shard, acc_shard, keys1, proj_kernel, base, rps,
                                rows_padded, grp)
    new_l2 = _load_tier_widened(w_shard, acc_shard, keys2, proj_kernel, base, rps,
                                rows_padded, grp)
    if write_back:
        new_l1 = _carry_exact_rows(new_l1, cache, l2_d, rows_padded)
        new_l2 = _carry_exact_rows(new_l2, cache, l2_d, rows_padded)
    _decay(counts_shard, decay)
    return w_shard, acc_shard, counts_shard, new_l1, _into(l2, new_l2)


# ---------------------------------------------------------------------------
# baseline lookups (paper §II-C) for the comparison strategies
# ---------------------------------------------------------------------------


def ps_lookup(table_shard: torch.Tensor, ids: torch.Tensor, *, world: int,
              group: Optional[Group] = None) -> torch.Tensor:
    """PS/DP-style lookup: all_gather the ids, gather the rows this shard
    owns, psum the partial rows and keep this rank's (no routing, no dedup,
    no cache). At world 1 the collectives are identities, so this is a
    masked gather. Ids outside the table (the sentinel slots of
    ``allgather_rows``) get exact zero rows."""
    grp = resolve_group(world, group)
    rps = table_shard.shape[0]
    n = ids.shape[0]
    local = all_gather_tiled(ids, grp) - grp.rank * rps
    ok = (local >= 0) & (local < rps)
    part = table_shard[torch.clamp(local, 0, rps - 1).long()]
    full = psum(part * ok[:, None].to(part.dtype), grp)
    return full[grp.rank * n:(grp.rank + 1) * n]


def mp_lookup_nodedup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    *,
    world: int,
    capacity: int,
    group: Optional[Group] = None,
) -> Tuple[torch.Tensor, LookupCtx]:
    """Model-parallel Shuffle without K-Packed dedup (paper §II-C baseline):
    every raw id, duplicates included, takes its own bucket slot.

    The ids are sorted (stably, as ``jnp.argsort``), not uniqued: ``inv``
    maps positions to sorted slots, so pooling and the transposed gradient
    path compose unchanged, and the owner-side dedup + Adagrad sums the
    duplicates' grads. ``ctx.order`` is the sort and ``ctx.slot_sorted`` is
    ``arange(n)`` (``inv[order]``), so the backward's ``segment_grad`` runs
    without a sort of its own. No tier: ``hit`` is all False. Needs
    ``capacity >= n`` per owner in the worst case (``exact_capacity=True``
    plans for lossless parity)."""
    grp = resolve_group(world, group)
    n = ids.shape[0]
    dev = ids.device
    order = torch.argsort(ids, stable=True)
    s = ids[order]
    slot_sorted = torch.arange(n, dtype=torch.int32, device=dev)
    inv = torch.empty((n,), dtype=torch.int32, device=dev)
    inv[order] = slot_sorted
    every = torch.ones((n,), dtype=torch.bool, device=dev)
    r = partition(s, every, table_shard.shape[0], world, capacity)
    recv_ids, recv_local, recv_valid, back = _shuffle_gather(table_shard, s, r, world,
                                                             capacity, group=grp)
    take_idx = torch.clamp(r.send_slot, max=world * capacity - 1).long()
    rows = back[take_idx] * r.kept[:, None].to(back.dtype)
    ctx = LookupCtx(
        uniq=s, inv=inv, uvalid=every, hit=torch.zeros((n,), dtype=torch.bool, device=dev),
        cache_slot=torch.zeros((n,), dtype=torch.int32, device=dev), routing=r,
        recv_ids=recv_ids, recv_local=recv_local, recv_valid=recv_valid,
        order=order, slot_sorted=slot_sorted)
    return rows, ctx
