"""PICASSO packed-embedding primitives (``repro.core.packed_embedding`` in
torch), for the ``picasso`` strategy's L1 path.

The kernel layer beneath ``repro_torch.engine.EmbeddingEngine``: stateless,
fixed-shape building blocks for one *packed* lookup per D-packed group:

    ids -> [Unique&Partition] -> Shuffle -> local Gather -> Shuffle back
        -> Stitch (+ hot-tier merge) -> unique rows -> pool

and the transposed path for the sparse gradients (``apply_sparse_grads``):
miss grads ride the transposed Shuffle to their owner rows and a fused
dedup + row-wise Adagrad; hit grads go into the hot tier (``'psum'``) or to
their owner rows (``'stale'``).

The reference keeps static shapes for its TPU collectives (sort-based fixed
unique, fixed-capacity per-peer buckets, sentinel slots); the port keeps
them too, so ``overflow``, ``send_slot`` and the exact-zero contracts match
bit for bit. This slice runs one rank: the all_to_all Shuffle, ``psum`` and
``all_gather`` are identities at world 1, and ``world > 1`` raises until
the multi-rank (NCCL) slice. The FCounter update and the HybridHash flush
update the state's tensors in place, and so do the sparse updates: the
full-width table is 7.5 GB and a functional copy per step would double it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops

_MULTI_RANK = "world > 1 needs the multi-rank (NCCL) slice of the port"


def _require_single_rank(world: int) -> None:
    if world != 1:
        raise NotImplementedError(_MULTI_RANK)


# ---------------------------------------------------------------------------
# fixed-shape building blocks (K-Packing: Unique&Partition fused)
# ---------------------------------------------------------------------------


class UniqueResult(NamedTuple):
    uniq: torch.Tensor      # [n] ascending; slots >= n_uniq hold ``sentinel``
    inv: torch.Tensor       # [n] original position -> unique slot
    n_uniq: torch.Tensor    # scalar
    uvalid: torch.Tensor    # [n] bool, slot validity


def fixed_unique(ids: torch.Tensor, sentinel: int) -> UniqueResult:
    """Sort-based unique with static output size == input size."""
    n = ids.shape[0]
    order = torch.argsort(ids)
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
    return UniqueResult(uniq, inv, n_uniq, uvalid)


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
    """Everything the statistics passes need (all static shapes). The
    reference's L2 and narrow leaves come with their strategies."""

    uniq: torch.Tensor
    inv: torch.Tensor
    uvalid: torch.Tensor
    hit: torch.Tensor         # [n] served by hot tier
    cache_slot: torch.Tensor  # [n] clamped position in hot_keys
    routing: Routing
    recv_ids: torch.Tensor    # [world, cap] ids this shard served (owner side)
    recv_local: torch.Tensor  # [world, cap] local row idx (clamped)
    recv_valid: torch.Tensor  # [world, cap]


def cache_probe(uniq: torch.Tensor, uvalid: torch.Tensor,
                hot_keys: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if hot_keys is None or hot_keys.shape[0] == 0:
        z = torch.zeros(uniq.shape, dtype=torch.bool, device=uniq.device)
        return z, torch.zeros(uniq.shape, dtype=torch.int32, device=uniq.device)
    p = torch.searchsorted(hot_keys, uniq)
    p_c = torch.clamp(p, 0, hot_keys.shape[0] - 1)
    hit = (hot_keys[p_c] == uniq) & uvalid
    return hit, p_c.to(torch.int32)


def mp_lookup(
    table_shard: torch.Tensor,     # [rows_per_shard, D]
    ids: torch.Tensor,             # [n] packed global row ids (int32)
    *,
    world: int,
    capacity: int,
    hot_keys: Optional[torch.Tensor] = None,   # [H] replicated, sorted
    hot_rows: Optional[torch.Tensor] = None,   # [H, D] replicated
    fused: Optional[bool] = None,              # see kernels.ops
) -> Tuple[torch.Tensor, LookupCtx]:
    """Forward packed lookup. Returns unique rows [n, D] + routing context.

    The L1 probe is one ``ops.tier_probe`` pass (binary search + hit-masked
    row gather, miss rows exactly zero), so the Stitch is a single ``where``;
    its plain version computes the reference's searchsorted/take/where chain
    with identical hit values. Only the misses ride the Shuffle.
    """
    _require_single_rank(world)
    rps, d = table_shard.shape
    rows_padded = rps * world

    u = fixed_unique(ids, sentinel=rows_padded)
    tier = hot_keys is not None and hot_keys.shape[0] > 0 and hot_rows is not None
    if tier:
        hit, cache_slot, hot = ops.tier_probe(u.uniq, u.uvalid, hot_keys, hot_rows,
                                              fused=fused)
    else:
        hit, cache_slot = cache_probe(u.uniq, u.uvalid, hot_keys)
    miss = u.uvalid & ~hit
    r = partition(u.uniq, miss, rps, world, capacity)

    # ---- Shuffle: route miss ids to owners (identity at world 1) ----------
    send_ids = torch.full((world * capacity + 1,), -1, dtype=torch.int32,
                          device=ids.device)
    send_ids[r.send_slot.long()] = u.uniq.to(torch.int32)  # last slot = drop
    recv_ids = send_ids[:-1].reshape(world, capacity)

    base = 0  # this rank's first row
    recv_valid = recv_ids >= 0
    recv_local = torch.clamp(recv_ids - base, 0, rps - 1)

    # ---- local Gather ------------------------------------------------------
    served = table_shard[recv_local.reshape(-1).long()]
    served = served * recv_valid.reshape(-1, 1).to(served.dtype)

    # ---- Shuffle back + Stitch ---------------------------------------------
    back = served.reshape(world * capacity, d)
    take_idx = torch.clamp(r.send_slot, max=world * capacity - 1).long()
    miss_rows = back[take_idx] * r.kept[:, None].to(served.dtype)
    rows_u = torch.where(hit[:, None], hot.to(miss_rows.dtype), miss_rows) if tier else miss_rows

    ctx = LookupCtx(
        uniq=u.uniq, inv=u.inv, uvalid=u.uvalid, hit=hit, cache_slot=cache_slot,
        routing=r, recv_ids=recv_ids, recv_local=recv_local, recv_valid=recv_valid,
    )
    return rows_u, ctx


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
) -> Tuple[torch.Tensor, torch.Tensor, Optional["CacheState"]]:
    """Transposed path: miss grads -> owners; hit grads -> hot tier or owners.

    'psum'  -- hit grads are summed into the hot tier, which is authoritative
               for its rows between flushes (exact training);
    'stale' -- hit grads are routed to the owner rows and the tier stays
               read-only between flushes (Algorithm 1's bounded staleness).

    ``w_shard``, ``acc_shard`` and the tier are updated in place; the
    returned tuple names them. Routed-gradient compression belongs to a
    later slice and raises.
    """
    _require_single_rank(world)
    if compress != "none":
        raise NotImplementedError(
            f"grad compression {compress!r} comes with a later slice of the port")
    if cache_update not in ("psum", "stale"):
        raise ValueError(f"cache_update must be 'psum' or 'stale', got {cache_update!r}")
    _apply_miss_grads(w_shard, acc_shard, ctx, g_u, world, lr, eps, fused)

    if cache is None or cache.keys.shape[0] == 0:
        return w_shard, acc_shard, cache
    if cache_update == "stale":
        _route_hit_grads(w_shard, acc_shard, ctx, ctx.hit, g_u, world, lr, eps, fused)
        return w_shard, acc_shard, cache
    return w_shard, acc_shard, _psum_into_tier(cache, ctx.hit, ctx.cache_slot, g_u,
                                               lr, eps)


def _scatter_rows(send_slot: torch.Tensor, values: torch.Tensor, n_slots: int,
                  fill: float = 0.0) -> torch.Tensor:
    """``[n_slots + 1, ...]`` buffer with ``values`` at ``send_slot``; the
    last row is the drop slot every not-kept position writes to (the
    reference's ``mode='drop'``), so callers slice it off."""
    buf = torch.full((n_slots + 1,) + tuple(values.shape[1:]), fill, dtype=values.dtype,
                     device=values.device)
    buf[send_slot.long()] = values
    return buf[:-1]


def _apply_miss_grads(w_shard, acc_shard, ctx: LookupCtx, g_u, world: int, lr: float,
                      eps: float, fused: Optional[bool] = None):
    """Transposed Shuffle: route miss grads to owner rows and apply. Kept
    positions have distinct slots; the rest all land in the drop slot."""
    cap = ctx.recv_ids.shape[1]
    send_g = _scatter_rows(ctx.routing.send_slot, g_u, world * cap)
    recv_g = send_g  # the transposed all_to_all is the identity at world 1
    return _dedup_apply(w_shard, acc_shard, ctx.recv_local.reshape(-1), recv_g,
                        ctx.recv_valid.reshape(-1), lr, eps, fused)


def _route_hit_grads(w_shard, acc_shard, ctx: LookupCtx, hit_mask, g_u, world: int,
                     lr: float, eps: float, fused: Optional[bool] = None):
    """'stale' mode: grads of tier-served ids ride a second small Shuffle to
    their owner rows; the tier itself stays read-only between flushes."""
    rps = w_shard.shape[0]
    cap = ctx.recv_ids.shape[1]
    r = partition(ctx.uniq, hit_mask, rps, world, cap)
    send_ids = _scatter_rows(r.send_slot, ctx.uniq.to(torch.int32), world * cap, -1)
    send_hg = _scatter_rows(r.send_slot, g_u, world * cap)
    recv_ids, recv_hg = send_ids, send_hg  # identity all_to_all at world 1
    base = 0  # this rank's first row
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
                    g_u: torch.Tensor, lr: float, eps: float) -> "CacheState":
    """'psum' mode: sum the tier-hit grads per tier slot and adagrad the tier
    in place (the psum over replicas is the identity at world 1).

    Plain PyTorch on purpose, as in the reference: the dense ``[H, D]``
    gradient buffer exists anyway, after which the row-wise adagrad is an
    elementwise pass, and a per-row scatter kernel would only serialize it.
    Non-hit positions add into a drop row past the tier. At world 1 the
    hit positions are distinct unique ids, so their tier slots are distinct
    and this ``index_add_`` is deterministic on the card too."""
    h = tier.keys.shape[0]
    dst = torch.where(hit_mask, slot.long(), torch.full_like(slot, h, dtype=torch.long))
    g_hot = torch.zeros((h + 1, g_u.shape[1]), dtype=g_u.dtype, device=g_u.device)
    g_hot.index_add_(0, dst, g_u)
    return _tier_adagrad(tier, g_hot[:h], lr, eps)


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


def cache_hit_count(ctx: LookupCtx) -> torch.Tensor:
    return ctx.hit.sum()


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values, ties broken toward the lower
    index. ``torch.topk`` promises no tie order, and FCounter ties are
    common, so this is a stable descending sort instead."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def flush_cache(
    w_shard: torch.Tensor,
    acc_shard: torch.Tensor,
    counts_shard: torch.Tensor,
    cache: CacheState,
    *,
    world: int,
    decay: float = 0.5,
    write_back: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, CacheState]:
    """Periodic HybridHash flush (Algorithm 1 L23-26).

    1. write back hot rows + optimizer state to the owner shard (in place);
    2. select the new top-H by frequency;
    3. load the new hot set.

    ``counts_shard`` decays in place; the returned tuple names the same
    ``w``/``acc``/``counts`` tensors and a fresh tier.
    """
    _require_single_rank(world)
    rps, _ = w_shard.shape
    h = cache.keys.shape[0]
    rows_padded = rps * world
    base = 0

    if write_back:
        _write_back_tier(w_shard, acc_shard, cache, base, rps, rows_padded)

    # the reference keeps the per-shard top-(4H/world) and merges them after
    # an all_gather; at world 1 the merge is a second top-k of the first
    k_local = min(rps, max(32, (4 * h + world - 1) // world))
    lvals, lidx = _top_k_stable(counts_shard, k_local)
    gids = base + lidx.to(torch.int32)
    tvals, tidx = _top_k_stable(lvals, h)
    new_keys = torch.sort(torch.where(tvals > 0, gids[tidx],
                                      torch.full_like(gids[tidx], rows_padded))).values

    new_cache = _load_tier(w_shard, acc_shard, new_keys, base, rps, rows_padded)
    counts_shard.copy_((counts_shard.to(torch.float32) * decay).to(counts_shard.dtype))
    return w_shard, acc_shard, counts_shard, new_cache


def _write_back_tier(w_shard, acc_shard, tier: CacheState, base: int, rps: int,
                     rows_padded: int) -> None:
    """The owner shard takes its slice of the replicated tier, in place."""
    local = tier.keys - base
    mine = (local >= 0) & (local < rps) & (tier.keys < rows_padded)
    idx = local[mine].long()
    w_shard[idx] = tier.rows[mine].to(w_shard.dtype)
    acc_shard[idx] = tier.acc[mine].to(acc_shard.dtype)


def _load_tier(w_shard, acc_shard, keys, base: int, rps: int,
               rows_padded: int) -> CacheState:
    """Master rows -> a fresh tier (the reference's psum of owner
    contributions is the identity at world 1)."""
    nlocal = keys - base
    nmine = (nlocal >= 0) & (nlocal < rps) & (keys < rows_padded)
    nclip = torch.clamp(nlocal, 0, rps - 1).long()
    contrib_w = w_shard[nclip] * nmine[:, None].to(w_shard.dtype)
    contrib_a = acc_shard[nclip] * nmine[:, None].to(acc_shard.dtype)
    return CacheState(keys, contrib_w, contrib_a)
